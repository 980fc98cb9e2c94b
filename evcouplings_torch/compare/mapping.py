"""
Sequence index mapping between aligned sequences (port of
evcouplings_tpu/compare/mapping.py, on the port's Alignment; host
numpy/pandas).
"""

from functools import reduce

import numpy as np
import pandas as pd

from evcouplings_torch.align.alignment import Alignment, parse_header


def map_indices(seq_i, start_i, end_i, seq_j, start_j, end_j,
                gaps=("-", ".")):
    """Position mapping between two aligned sequences.

    Returns a DataFrame with columns i, A_i, j, A_j; indices are
    stored as strings, with NaN index/symbol cells where the other
    sequence has a gap. Columns where both sequences are gapped are
    dropped.
    """
    res_i = np.asarray(list(seq_i))
    res_j = np.asarray(list(seq_j))
    gaps = np.asarray(list(gaps))

    aligned_i = ~np.isin(res_i, gaps)
    aligned_j = ~np.isin(res_j, gaps)

    # running sequence positions (value only meaningful where aligned)
    pos_i = start_i + np.cumsum(aligned_i) - 1
    pos_j = start_j + np.cumsum(aligned_j) - 1

    if aligned_i.any() and pos_i[aligned_i][-1] != end_i:
        raise ValueError(
            "Sequence i does not span {}-{}".format(start_i, end_i)
        )
    if aligned_j.any() and pos_j[aligned_j][-1] != end_j:
        raise ValueError(
            "Sequence j does not span {}-{}".format(start_j, end_j)
        )

    keep = aligned_i | aligned_j

    def column(values, mask):
        col = pd.Series(values[keep], dtype=object)
        col[~mask[keep]] = np.nan
        return col.reset_index(drop=True)

    return pd.DataFrame({
        "i": column(pos_i.astype(str), aligned_i),
        "A_i": column(res_i, aligned_i),
        "j": column(pos_j.astype(str), aligned_j),
        "A_j": column(res_j, aligned_j),
    })


def alignment_index_mapping(alignment_file, format="stockholm",
                            target_seq=None):
    """Index mapping table centered on a target sequence of an
    alignment: columns i, A_i plus i_<id> / A_i_<id> for every other
    row, aligned by merging on the target positions."""
    ali = Alignment.from_path(alignment_file, format)

    target_index = 0
    if target_seq is not None:
        for idx, full_id in enumerate(ali.ids):
            if full_id.startswith(target_seq):
                target_index = idx

    _, target_start, target_end = parse_header(ali.ids[target_index])
    gap_chars = [ali._match_gap, ali._insert_gap]

    def row_mapping(row_index):
        full_id = ali.ids[row_index]
        _, row_start, row_end = parse_header(full_id)
        return map_indices(
            ali.matrix[target_index], target_start, target_end,
            ali.matrix[row_index], row_start, row_end,
            gap_chars,
        ).rename(columns={
            "j": "i_" + full_id,
            "A_j": "A_i_" + full_id,
        })

    per_row = [
        row_mapping(idx) for idx in range(ali.N)
        if idx != target_index
    ]
    if not per_row:
        return None

    return reduce(
        lambda acc, t: acc.merge(t, on=("i", "A_i"), how="left"),
        per_row,
    )
