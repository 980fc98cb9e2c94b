"""
Native (C) alignment readers of the port, loaded through ctypes.

- `csrc/fasta_io.c`: single-pass FASTA/A2M reader returning the sequence
  block as one contiguous buffer.
- `csrc/stockholm_io.c`: single-pass Stockholm reader that concatenates
  interleaved residue blocks in C and hands the markup lines to Python
  for the annotation (GF/GC/GS/GR).

They are the JAX package's CPython loaders rewritten to a plain C
interface (no Python.h): a reader fills a record (io_common.h's EvcParse)
with malloc'd blocks, this module copies them into Python objects and
returns them with evc_parse_free. The libraries are built from the
checkout's sources with the host C compiler at first use
(kernels/_build.py, into build/evcouplings_torch/); where they cannot be
built, the readers raise KernelBuildError naming what is missing. The
port never falls back to the Python readers for that: HAVE_NATIVE and
HAVE_NATIVE_STOCKHOLM are always True. It falls back, as the JAX package
does, where a reader refuses its input with ValueError (ragged rows, a
truncated file, bytes the strict input guard refuses).
"""

import ctypes
import os
import sys

import numpy as np

from evcouplings_torch.kernels import _build

HAVE_NATIVE = True
HAVE_NATIVE_STOCKHOLM = True

# status of a parse (io_common.h)
_OK, _OS_ERROR, _VALUE_ERROR, _NO_MEMORY = 0, 1, 2, 3


class _EvcParse(ctypes.Structure):
    """io_common.h's EvcParse."""

    _fields_ = [
        ("status", ctypes.c_int),
        ("err_no", ctypes.c_int),
        ("message", ctypes.c_char * 256),
        ("n", ctypes.c_longlong),
        ("L", ctypes.c_longlong),
        ("seqs", ctypes.c_void_p),
        ("ids", ctypes.c_void_p),
        ("ids_len", ctypes.c_longlong),
        ("markup", ctypes.c_void_p),
        ("markup_len", ctypes.c_longlong),
        ("n_markup", ctypes.c_longlong),
    ]


def _records(ptr, nbytes):
    """The '\\n'-terminated ASCII records of a C block, as strings."""
    if not nbytes:
        return []
    return ctypes.string_at(ptr, nbytes).decode("ascii").split("\n")[:-1]


def _parse(source, symbol, path):
    """Run one reader (csrc/<source>.c, entry point `symbol`) on path:
    (ids, residue bytes, n, L, markup lines). Raises the JAX loaders'
    exceptions: OSError, ValueError, MemoryError."""
    parse_fn = getattr(_build.load(source, {
        symbol: [ctypes.c_char_p, ctypes.POINTER(_EvcParse)]}), symbol)
    free_fn = _build.load(source, {
        "evc_parse_free": [ctypes.POINTER(_EvcParse)]},
        restype=None).evc_parse_free

    result = _EvcParse()
    status = parse_fn(os.fsencode(path), ctypes.byref(result))
    try:
        message = result.message.decode("utf-8", "replace")
        if status == _OS_ERROR:
            if result.err_no:
                raise OSError(result.err_no, os.strerror(result.err_no),
                              message)
            raise OSError(message)
        if status == _VALUE_ERROR:
            raise ValueError(message)
        if status == _NO_MEMORY:
            raise MemoryError(message)
        if status != _OK:
            raise RuntimeError("{} returned status {}".format(symbol, status))
        n, L = result.n, result.L
        seq_bytes = ctypes.string_at(result.seqs, n * L) if n * L else b""
        ids = _records(result.ids, result.ids_len)
        markup = _records(result.markup, result.markup_len)
    finally:
        free_fn(ctypes.byref(result))
    return ids, seq_bytes, n, L, markup


def _parse_fasta(path):
    """(ids, residue bytes, N, L) of a FASTA/A2M file, the return of the
    JAX package's _fasta.parse_fasta."""
    ids, seq_bytes, n, L, _ = _parse("fasta_io", "evc_parse_fasta", path)
    return ids, seq_bytes, n, L


def _parse_stockholm(path):
    """(ids, residue bytes, N, L, markup lines) of a Stockholm file's
    first alignment, the return of the JAX package's
    _stockholm.parse_stockholm."""
    return _parse("stockholm_io", "evc_parse_stockholm", path)


def _bytes_to_char_matrix(seq_bytes, n, L):
    """(n*L,) ASCII bytes -> (n, L) '<U1' matrix without numpy's
    element-wise S->U astype (which costs ~20x the parse itself):
    UCS4 little-endian stores the ASCII byte first, so widening is a
    strided byte copy."""
    if sys.byteorder != "little":   # pragma: no cover
        return (
            np.frombuffer(seq_bytes, dtype="S1")
            .reshape(n, L).astype("U1")
        )
    out = np.zeros((n * L, 4), dtype=np.uint8)
    out[:, 0] = np.frombuffer(seq_bytes, dtype=np.uint8)
    return out.view("<U1").reshape(n, L)


def parse_fasta_native(path):
    """Parse an aligned FASTA/A2M file natively.

    Returns (ids, matrix) where ids is a list of full header strings
    and matrix is an (N, L) single-character numpy array — the same
    shape/dtype the Alignment container uses.

    Raises ValueError for ragged files (e.g. a3m with inserts) so
    callers can fall back to the insert-aware Python parser, OSError for
    a file that cannot be read, and KernelBuildError if the reader
    cannot be built.
    """
    ids, seq_bytes, n, L = _parse_fasta(path)

    if n * L != len(seq_bytes):
        raise ValueError(
            "inconsistent parse: {} rows x {} cols != {} bytes".format(
                n, L, len(seq_bytes)
            )
        )

    matrix = _bytes_to_char_matrix(seq_bytes, n, L)
    return ids, matrix


def parse_stockholm_native(path, read_annotation=True,
                           raise_hmmer_prefixes=True):
    """Parse the first alignment of a Stockholm file natively.

    Returns (ids, matrix, annotation) with annotation = {"GF", "GC",
    "GS", "GR"} dicts shaped exactly like the Python reader's
    StockholmAlignment fields (align/alignment.py read_stockholm). The
    residue accumulation (the hot loop for interleaved jackhmmer output)
    runs in C; only the markup lines are assembled here.

    Raises ValueError for files the C reader does not cover
    (truncated/ragged/invalid) so callers can fall back, OSError for a
    file that cannot be read, and KernelBuildError if the reader cannot
    be built.
    """
    from evcouplings_torch.align.alignment import HMMER_PREFIX_WARNING
    from evcouplings_torch.utils.helpers import DefaultOrderedDict

    ids, seq_bytes, n, L, markup = _parse_stockholm(path)

    if n * L != len(seq_bytes):
        raise ValueError(
            "inconsistent parse: {} rows x {} cols != {} bytes".format(
                n, L, len(seq_bytes)
            )
        )

    matrix = _bytes_to_char_matrix(seq_bytes, n, L)

    gf = DefaultOrderedDict(list)
    gc = DefaultOrderedDict(str)
    # single value per (row, tag), like the Python reader's per_seq
    # (missing-key reads must default to "" on both paths)
    gs = DefaultOrderedDict(lambda: DefaultOrderedDict(str))
    gr = DefaultOrderedDict(lambda: DefaultOrderedDict(str))

    for line in markup:
        if raise_hmmer_prefixes and line.startswith(HMMER_PREFIX_WARNING):
            raise ValueError(
                "HMMER added identifier prefixes to alignment because "
                "of non-unique sequence identifiers. Please ensure "
                "unique sequence identifiers in the database and for "
                "the target."
            )
        if not read_annotation:
            continue
        if line.startswith("#=GF"):
            _, feat, val = line.split(maxsplit=2)
            gf[feat].append(val)
        elif line.startswith("#=GC"):
            _, feat, seq = line.split(maxsplit=2)
            gc[feat] += seq
        elif line.startswith("#=GS"):
            _, seq_id, feat, val = line.split(maxsplit=3)
            gs[seq_id][feat] = val
        elif line.startswith("#=GR"):
            _, seq_id, feat, seq = line.split()
            gr[seq_id][feat] += seq

    annotation = {"GF": gf, "GC": gc, "GS": gs, "GR": gr}
    return ids, matrix, annotation
