"""
Multiple sequence alignment reader (the subset of
evcouplings_tpu/align/alignment.py that the couplings fit uses).

Reads FASTA-family files (fasta, a2m) in pure Python into a numpy
character matrix. Format detection, Stockholm and a3m input, writers and
the alignment's numeric members are not ported yet.
"""

import re
from collections import OrderedDict

import numpy as np

GAP = "-"
MATCH_GAP = GAP
INSERT_GAP = "."

ALPHABET_PROTEIN_NOGAP = "ACDEFGHIKLMNPQRSTVWY"
ALPHABET_PROTEIN = GAP + ALPHABET_PROTEIN_NOGAP


def read_fasta(fileobj):
    """Yield (id, sequence) tuples from a FASTA-family file (fasta/a2m)."""
    header = None
    body = []

    for line in fileobj:
        if line.startswith(">"):
            if header is not None:
                yield header, "".join(body)
            header = line[1:].rstrip()
            body = []
        elif not line.startswith(";"):
            body.append(line.rstrip())

    yield header, "".join(body)


def parse_header(header):
    """Split a "seqid/start-end" header into (id, start, stop).

    Any annotation after the first whitespace is discarded. start/stop
    are None if no range is present.
    """
    token = header.split()[0]
    m = re.fullmatch(r"(.+)/(\d+)-(\d+)(.*)", token, flags=re.S)
    if m is None:
        return token, None, None
    return m.group(1), int(m.group(2)), int(m.group(3))


def sequences_to_matrix(sequences):
    """Stack aligned sequence strings into an N x L character matrix."""
    sequences = list(sequences)
    if not sequences:
        raise ValueError("Need at least one sequence")

    width = len(sequences[0])
    out = np.empty((len(sequences), width), dtype=str)
    for k, seq in enumerate(sequences):
        if len(seq) != width:
            raise ValueError(
                "Sequences have differing lengths: i={} L_0={} "
                "L_i={}".format(k, width, len(seq)))
        out[k] = np.array(list(seq))
    return out


class Alignment:
    """Multiple sequence alignment as a numpy character matrix."""

    def __init__(self, sequence_matrix, sequence_ids=None,
                 alphabet=ALPHABET_PROTEIN):
        self.matrix = np.array(sequence_matrix)
        self.N, self.L = self.matrix.shape
        self._match_gap = MATCH_GAP
        self._insert_gap = INSERT_GAP
        self.alphabet = alphabet

        if sequence_ids is None:
            sequence_ids = [str(i) for i in range(self.N)]
        else:
            sequence_ids = list(sequence_ids)
            if len(sequence_ids) != self.N:
                raise ValueError(
                    "Number of sequence IDs ({}) and length of alignment "
                    "({}) do not match".format(len(sequence_ids), self.N))
        self.ids = np.array(sequence_ids, dtype=np.object_)

    @classmethod
    def from_dict(cls, sequences, **kwargs):
        """Create an alignment from an {id: sequence} mapping."""
        matrix = sequences_to_matrix(sequences.values())
        return cls(matrix, sequences.keys(), **kwargs)

    @classmethod
    def from_file(cls, fileobj, format="fasta", split_header=False,
                  **kwargs):
        """Create an alignment by parsing a FASTA-family file (fasta and
        aligned a2m)."""
        if format != "fasta":
            raise NotImplementedError(
                "alignment format {!r} is not ported yet; the reader "
                "takes fasta and a2m".format(format))
        seqs = OrderedDict(read_fasta(fileobj))
        if split_header:
            seqs = {header.split()[0]: seq for header, seq in seqs.items()}
        return cls.from_dict(seqs, **kwargs)

    @classmethod
    def from_path(cls, path, format="fasta", split_header=False, **kwargs):
        """Create an alignment from a file path."""
        with open(path) as f:
            return cls.from_file(f, format=format, split_header=split_header,
                                 **kwargs)
