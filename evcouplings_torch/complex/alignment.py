"""
Concatenated (paired) complex alignments (port of
evcouplings_tpu/complex/alignment.py). The concatenated target header is
`id1_id2/1-L1+L2`, which focus mode needs downstream. The alignments it
returns carry `device` (None: the CUDA device, "cpu": the host), where
the align stage's numerics on them run.
"""

from collections import OrderedDict

import numpy as np

from evcouplings_torch.align.alignment import Alignment, parse_header


def _unfilter(matrix):
    """Uppercase all symbols and turn insert gaps "." into match gaps
    "-" (undo a2m column filtering for pairing)."""
    matrix = np.char.upper(matrix)
    matrix[matrix == "."] = "-"
    return matrix


def _load_unfiltered(path, device):
    """Monomer alignment with a2m filtering undone on every column."""
    ali = Alignment.from_path(path, "fasta", device=device)
    return ali.apply(
        func=_unfilter, columns=np.arange(ali.matrix.shape[1])
    )


def write_concatenated_alignment(id_pairing, alignment_1, alignment_2,
                                 target_sequence_1, target_sequence_2,
                                 device=None):
    """Pair rows of two monomer alignments into one concatenated
    alignment.

    Returns (target_header, target_seq_index, full_alignment,
    monomer_alignment_1, monomer_alignment_2) where the monomer
    alignments contain only the rows that made it into the
    concatenation (in the same order).
    """
    ali_1 = _load_unfiltered(alignment_1, device)
    ali_2 = _load_unfiltered(alignment_2, device)

    def row(ali, seq_id):
        return ali.matrix[ali.id_to_index[seq_id], :]

    target_1 = row(ali_1, target_sequence_1)
    target_2 = row(ali_2, target_sequence_2)

    # target header must end with /1-<range> for correct focus mode
    target_header = "{}_{}/1-{}".format(
        parse_header(target_sequence_1)[0],
        parse_header(target_sequence_2)[0],
        target_1.size + target_2.size,
    )

    # the paired target leads (index 0), then the paired members
    triples = [(target_header, target_1, target_2)] + [
        ("{}_{}".format(id1, id2), row(ali_1, id1), row(ali_2, id2))
        for id1, id2 in zip(id_pairing.id_1, id_pairing.id_2)
    ]

    def as_alignment(pick):
        rows = OrderedDict(
            (header, pick(seq1, seq2)) for header, seq1, seq2 in triples
        )
        # the rows are character arrays already: stack them (what
        # Alignment.from_dict does with strings, one row at a time)
        return Alignment(np.array(list(rows.values())), rows.keys(),
                         device=device)

    return (
        target_header,
        0,   # the paired target is always the first row
        as_alignment(lambda a, b: np.concatenate([a, b])),
        as_alignment(lambda a, b: a),
        as_alignment(lambda a, b: b),
    )
