"""
BinaryCIF column codec, decoder and minimal encoder (port of
evcouplings_tpu/compare/bcif.py; host numpy, no device work).

A dependency-free implementation of the public BinaryCIF
specification (https://github.com/molstar/BinaryCIF): the encoding
chain ByteArray / FixedPoint / IntervalQuantization / RunLength /
Delta / IntegerPacking / StringArray, plus column masks
(0 = present, 1 = ".", 2 = "?").

The encoder subset (ByteArray, FixedPoint, StringArray) writes the
structures of the tests and of chip_smoke.py.
"""

import numpy as np

# ByteArray type codes -> numpy dtypes (little-endian)
_BYTE_ARRAY_TYPES = {
    1: np.dtype("<i1"),
    2: np.dtype("<i2"),
    3: np.dtype("<i4"),
    4: np.dtype("<u1"),
    5: np.dtype("<u2"),
    6: np.dtype("<u4"),
    32: np.dtype("<f4"),
    33: np.dtype("<f8"),
}

_DTYPE_TO_CODE = {v: k for k, v in _BYTE_ARRAY_TYPES.items()}


def _decode_byte_array(data, encoding):
    dtype = _BYTE_ARRAY_TYPES[encoding["type"]]
    return np.frombuffer(data, dtype=dtype)


def _decode_fixed_point(data, encoding):
    dtype = np.float32 if encoding.get("srcType", 33) == 32 else np.float64
    return np.asarray(data, dtype=dtype) / encoding["factor"]


def _decode_interval_quantization(data, encoding):
    dtype = np.float32 if encoding.get("srcType", 33) == 32 else np.float64
    delta = (encoding["max"] - encoding["min"]) / (
        encoding["numSteps"] - 1
    )
    return (
        encoding["min"] + np.asarray(data, dtype=dtype) * delta
    )


def _decode_run_length(data, encoding):
    data = np.asarray(data)
    return np.repeat(data[::2], data[1::2]).astype(
        np.dtype("<i4"), copy=False
    )


def _decode_delta(data, encoding):
    data = np.asarray(data, dtype=np.int64).copy()
    data[0] += encoding.get("origin", 0)
    return np.cumsum(data).astype(np.dtype("<i4"), copy=False)


def _decode_integer_packing(data, encoding):
    """Unpack small-byte-count integers where boundary values mark
    continuation (value accumulates until a non-boundary byte).

    Vectorized: each output value is the sum of a run of boundary
    entries plus its terminating non-boundary entry, i.e. a segment
    sum over runs delimited by the non-boundary positions — RCSB uses
    this encoding for the large _atom_site integer columns, so a
    per-element Python loop would dominate structure-load time."""
    data = np.asarray(data)
    info = np.iinfo(data.dtype)
    if encoding["isUnsigned"]:
        is_boundary = data == info.max
    else:
        is_boundary = (data == info.max) | (data == info.min)

    ends = np.flatnonzero(~is_boundary)
    if len(ends) == 0:
        return np.zeros(0, dtype=np.int64)
    # trailing boundary bytes without a terminator carry no value
    vals = data[:ends[-1] + 1].astype(np.int64)
    starts = np.empty(len(ends), dtype=np.intp)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    return np.add.reduceat(vals, starts)


def _decode_string_array(data, encoding):
    offsets = decode_data(encoding["offsets"], encoding["offsetEncoding"])
    indices = decode_data(data, encoding["dataEncoding"])

    string_data = encoding["stringData"]
    strings = [
        string_data[start:end]
        for start, end in zip(offsets[:-1], offsets[1:])
    ]

    indices = np.asarray(indices, dtype=np.int64)
    lookup = np.array([""] + strings, dtype=object)
    return lookup[indices + 1]


_DECODERS = {
    "ByteArray": _decode_byte_array,
    "FixedPoint": _decode_fixed_point,
    "IntervalQuantization": _decode_interval_quantization,
    "RunLength": _decode_run_length,
    "Delta": _decode_delta,
    "IntegerPacking": _decode_integer_packing,
    "StringArray": _decode_string_array,
}


def decode_data(data, encodings):
    """Apply an encoding chain in reverse to recover the raw column."""
    for encoding in reversed(encodings):
        kind = encoding["kind"]
        if kind not in _DECODERS:
            raise ValueError(
                "Unsupported BinaryCIF encoding: {}".format(kind)
            )
        data = _DECODERS[kind](data, encoding)
    return data


def decode_column(column):
    """Decode a full BinaryCIF column dict (with optional mask).

    Masked entries become "" for string columns and NaN for numeric
    columns (matching the biopython behavior the reference relies on).
    """
    values = decode_data(
        column["data"]["data"], column["data"]["encoding"]
    )

    mask_info = column.get("mask")
    if mask_info is not None and mask_info.get("data"):
        mask = np.asarray(
            decode_data(mask_info["data"], mask_info["encoding"])
        )
        if np.any(mask):
            values = np.asarray(values)
            if values.dtype.kind in ("U", "S", "O"):
                values = values.astype(object).copy()
                values[mask != 0] = ""
            else:
                values = values.astype(np.float64).copy()
                values[mask != 0] = np.nan
    return np.asarray(values)


# ---------------------------------------------------------------------------
# encoder subset (tests / artifact writing)
# ---------------------------------------------------------------------------

def _encode_numeric(values):
    values = np.asarray(values)
    if values.dtype.kind == "f":
        if not np.all(np.isfinite(values)):
            raise ValueError(
                "Cannot encode non-finite values in a fixed-point "
                "BinaryCIF column (NaN/inf would silently corrupt to "
                "INT32_MIN/1000)"
            )
        # fixed point with 3 decimals, stored as int32 deltas
        ints = np.round(values * 1000).astype("<i4")
        return ints.tobytes(), [
            {"kind": "FixedPoint", "factor": 1000, "srcType": 33},
            {"kind": "ByteArray", "type": 3},
        ]
    ints = values.astype("<i4")
    return ints.tobytes(), [{"kind": "ByteArray", "type": 3}]


def _encode_strings(values):
    values = ["" if v is None else str(v) for v in values]
    unique = list(dict.fromkeys(values))
    index_of = {s: i for i, s in enumerate(unique)}

    string_data = "".join(unique)
    offsets = np.zeros(len(unique) + 1, dtype="<i4")
    np.cumsum([len(s) for s in unique], out=offsets[1:])

    indices = np.array(
        [index_of[v] for v in values], dtype="<i4"
    )
    return b"", [{
        "kind": "StringArray",
        "stringData": string_data,
        "offsets": offsets.tobytes(),
        "offsetEncoding": [{"kind": "ByteArray", "type": 3}],
        "data": indices.tobytes(),
        "dataEncoding": [{"kind": "ByteArray", "type": 3}],
    }]


def encode_column(name, values):
    """Encode a column (auto-detecting string vs numeric storage)."""
    values = np.asarray(values)
    if values.dtype.kind in ("U", "S", "O"):
        data, encoding = _encode_strings(values)
    else:
        data, encoding = _encode_numeric(values)

    if encoding[0]["kind"] == "StringArray":
        # StringArray holds its own payload in `data`
        payload = encoding[0].pop("data")
        data = payload

    return {
        "name": name,
        "data": {"data": data, "encoding": encoding},
        "mask": None,
    }


def write_bcif(filename, categories):
    """Write a minimal single-block BinaryCIF file.

    categories: {category_name: {column_name: values}}.
    """
    import msgpack

    blocks = [{
        "header": "data",
        "categories": [
            {
                "name": cat_name,
                "rowCount": len(next(iter(columns.values()))),
                "columns": [
                    encode_column(col_name, values)
                    for col_name, values in columns.items()
                ],
            }
            for cat_name, columns in categories.items()
        ],
    }]

    payload = {
        "version": "0.3.0",
        "encoder": "evcouplings_torch",
        "dataBlocks": blocks,
    }
    with open(filename, "wb") as f:
        f.write(msgpack.packb(payload, use_bin_type=True))
