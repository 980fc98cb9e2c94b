"""
Multiple sequence alignment container and format I/O (port of
evcouplings_tpu/align/alignment.py).

The container is a numpy character matrix on the host, so string-level
operations (case changes, gap replacement, column selection) stay cheap.
Alignment.from_path reads FASTA/A2M and Stockholm files with the port's
C readers (evcouplings_torch.native, built from csrc/ at first use) and
everything else, or what they refuse, with the Python readers (fasta/a2m,
a3m, Stockholm), which from_file always uses. The numeric members
(set_weights, frequencies, pair_frequencies, identities_to, conservation)
run on the port's tensor operations: on the CUDA device unless the
alignment (or the call) names another device. set_weights' O(N^2 L)
identity counts are K1 (csrc/reweight.cu) on the card.
"""

import re
from collections import namedtuple, OrderedDict, defaultdict
from copy import deepcopy
from pathlib import Path

import numpy as np

from evcouplings_torch.utils.calculations import entropy_rows
from evcouplings_torch.utils.helpers import DefaultOrderedDict, wrap


# ---------------------------------------------------------------------
# Module-level entry points at the JAX package's import paths. They run
# the port's tensor operations on `device` (None: the CUDA device, "cpu":
# the host) and return float64 numpy arrays, as the JAX ones do; imports
# are deferred so loading an alignment does not need them.
# ---------------------------------------------------------------------

def frequencies(matrix, seq_weights, num_symbols, device=None):
    """Weighted single-site frequencies f_i (L x q)."""
    from evcouplings_torch.ops.frequencies import frequencies as _op
    return _op(matrix, seq_weights, num_symbols, device=device)


def pair_frequencies(matrix, seq_weights, num_symbols, fi, device=None):
    """Weighted pair frequencies f_ij (L x L x q x q)."""
    from evcouplings_torch.ops.frequencies import pair_frequencies as _op
    return _op(matrix, seq_weights, num_symbols, fi, device=device)


def num_cluster_members(matrix, identity_threshold, device=None):
    """Neighbor counts at >= identity_threshold (the O(N^2 L)
    reweighting pass; K1 on the card)."""
    from evcouplings_torch.ops.weights import num_cluster_members as _op
    return _op(matrix, identity_threshold, device=device).cpu().numpy()


def identities_to_seq(seq, matrix, device=None):
    """Absolute identity counts of every row to a target sequence."""
    from evcouplings_torch.ops.weights import identities_to_seq as _op
    return _op(seq, matrix, device=device).cpu().numpy()


# constants
GAP = "-"
MATCH_GAP = GAP
INSERT_GAP = "."

ALPHABET_PROTEIN_NOGAP = "ACDEFGHIKLMNPQRSTVWY"
ALPHABET_PROTEIN = GAP + ALPHABET_PROTEIN_NOGAP

# amino acid alphabet ordered by amino acid properties
ALPHABET_PROTEIN_NOGAP_ORDERED = "KRHEDNQTSCGAVLIMPYFW"
ALPHABET_PROTEIN_ORDERED = GAP + ALPHABET_PROTEIN_NOGAP_ORDERED

ALPHABET_DNA_NOGAP = "ACGT"
ALPHABET_DNA = GAP + ALPHABET_DNA_NOGAP

ALPHABET_RNA_NOGAP = "ACGU"
ALPHABET_RNA = GAP + ALPHABET_RNA_NOGAP

HMMER_PREFIX_WARNING = (
    "# WARNING: seq names have been made unique by adding a prefix of"
)

_STOCKHOLM_HEADER = "# STOCKHOLM 1.0"


def read_fasta(fileobj):
    """Yield (id, sequence) tuples from a FASTA-family file (fasta/a2m/a3m)."""
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


def write_fasta(sequences, fileobj, width=80):
    """Write (id, sequence) tuples in FASTA format."""
    for seq_id, seq in sequences:
        # ids may be non-str (e.g. integer keys from from_dict)
        fileobj.write(
            ">" + str(seq_id) + "\n" + wrap(seq, width=width) + "\n"
        )


def write_aln(sequences, fileobj, width=80):
    """Write sequences as a plain block matrix (ALN format, no headers)."""
    for _, seq in sequences:
        fileobj.write(seq + "\n")


# parsed Stockholm alignment: sequences plus the four markup namespaces
StockholmAlignment = namedtuple(
    "StockholmAlignment", ["seqs", "gf", "gc", "gs", "gr"]
)


class _StockholmBlock:
    """Accumulator for one `# STOCKHOLM 1.0` ... `//` block.

    Markup namespaces: GF per-file (multi-line -> list), GC per-column
    (wrapped -> concatenated), GS per-sequence (single value), GR
    per-residue (wrapped -> concatenated). Interleaved sequence rows
    concatenate by id.
    """

    def __init__(self, keep_markup):
        self.keep_markup = keep_markup
        self.rows = DefaultOrderedDict(str)
        self.per_file = DefaultOrderedDict(list)
        self.per_column = DefaultOrderedDict(str)
        self.per_seq = DefaultOrderedDict(
            # single value per (row, tag): repeated #=GS tags
            # overwrite (assignment below), they do not accumulate
            lambda: DefaultOrderedDict(str)
        )
        self.per_residue = DefaultOrderedDict(
            lambda: DefaultOrderedDict(str)
        )

    def markup(self, line):
        if not self.keep_markup:
            return
        if line.startswith("#=GF"):
            _, tag, text = line.rstrip().split(maxsplit=2)
            self.per_file[tag].append(text)
        elif line.startswith("#=GC"):
            _, tag, text = line.rstrip().split(maxsplit=2)
            self.per_column[tag] += text
        elif line.startswith("#=GS"):
            _, row_id, tag, text = line.rstrip().split(maxsplit=3)
            self.per_seq[row_id][tag] = text
        elif line.startswith("#=GR"):
            _, row_id, tag, text = line.rstrip().split()
            self.per_residue[row_id][tag] += text

    def sequence(self, line):
        parts = line.rstrip().split(maxsplit=2)
        # blank/ragged lines are silently skipped
        if len(parts) == 2:
            self.rows[parts[0]] += parts[1]

    def packaged(self):
        return StockholmAlignment(
            self.rows, self.per_file, self.per_column,
            self.per_seq, self.per_residue,
        )


def read_stockholm(fileobj, read_annotation=False, raise_hmmer_prefixes=True):
    """Yield StockholmAlignment tuples from a (possibly multi-)Stockholm file.

    Markup: #=GF per-file, #=GC per-column, #=GS per-sequence, #=GR
    per-residue. Truncated alignments (missing // terminator) are not
    yielded. Raises on HMMER made-unique prefix warnings when
    ``raise_hmmer_prefixes``.
    """
    block = None  # None until the block's header line is consumed

    for line in fileobj:
        if block is None:
            if not line.startswith(_STOCKHOLM_HEADER):
                raise ValueError(
                    "Not a valid Stockholm alignment: "
                    "Header missing. " + line.rstrip()
                )
            block = _StockholmBlock(read_annotation)
            continue

        if raise_hmmer_prefixes and line.startswith(
                HMMER_PREFIX_WARNING):
            raise ValueError(
                "HMMER added identifier prefixes to alignment "
                "because of non-unique sequence identifiers. Please "
                "ensure unique sequence identifiers in the database "
                "and for the target."
            )

        if line.startswith("//"):
            yield block.packaged()
            block = None
        elif line.startswith("#"):
            block.markup(line)
        else:
            block.sequence(line)


def read_a3m(fileobj, inserts="first"):
    """Read an a3m alignment and expand to a2m.

    inserts="first": keep insert columns present in the first (target)
    sequence, pad other sequences' match states into that template with
    "." insert gaps. inserts="delete": drop all lowercase/insert states.
    """
    if inserts not in ("first", "delete"):
        raise ValueError("Invalid option for inserts: " + str(inserts))

    expanded = OrderedDict()
    match_positions = None
    template_width = None

    for seq_id, seq in read_fasta(fileobj):
        seq = seq.replace(".", "")

        if inserts == "delete":
            expanded[seq_id] = "".join(
                c for c in seq if not c.islower()
            )
            continue

        match_states = [c for c in seq if not c.islower()]

        if match_positions is None:
            # the target sequence fixes the output template: its
            # non-insert positions are the match columns, everything
            # else fills with "." in the remaining rows
            match_positions = [
                j for j, c in enumerate(seq) if not c.islower()
            ]
            template_width = len(seq)
            expanded[seq_id] = seq
        else:
            if len(match_states) != len(match_positions):
                raise ValueError(
                    "a3m row {!r} has {} match states, template "
                    "expects {}".format(
                        seq_id, len(match_states),
                        len(match_positions),
                    )
                )
            row = ["."] * template_width
            for j, c in zip(match_positions, match_states):
                row[j] = c
            expanded[seq_id] = "".join(row)

    return expanded


def write_a3m(sequences, fileobj, insert_gap=INSERT_GAP, width=80):
    """Write sequences in a3m format (insert gaps removed)."""
    for seq_id, seq in sequences:
        fileobj.write(
            ">" + str(seq_id) + "\n"
            + seq.replace(insert_gap, "") + "\n"
        )


def detect_format(fileobj, filepath=""):
    """Detect alignment format: "stockholm", "a3m", "fasta", or None."""
    first = True
    for line in fileobj:
        if first and line.startswith(_STOCKHOLM_HEADER):
            return "stockholm"
        first = False

        if line.startswith(">"):
            # FASTA family; the .a3m extension disambiguates a3m
            suffix = Path(filepath).suffix.lower()
            return "a3m" if suffix == ".a3m" else "fasta"

        # comments/blank lines are inconclusive, keep scanning
        if line.startswith(";") or not line.strip():
            continue

        return None


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


def map_from_alphabet(alphabet=ALPHABET_PROTEIN, default=GAP):
    """Character -> integer code mapping; unknown characters map to default."""
    codes = {c: i for i, c in enumerate(alphabet)}
    if default not in codes:
        raise ValueError(
            "Default {} is not in alphabet {}".format(default, alphabet)
        )
    return defaultdict(lambda: codes[default], codes)


def map_matrix(matrix, map_):
    """Remap a character matrix to integer codes using an alphabet map.

    Vectorized via a 256-entry lookup table over the characters'
    codepoints (all alignment alphabets are ASCII).
    """
    matrix = np.asarray(matrix)
    lut = np.full(256, map_.default_factory(), dtype=np.int64)
    for c, i in map_.items():
        o = ord(c)
        if o < 256:
            lut[o] = i

    # view chars as uint32 codepoints; non-ASCII falls back to default
    codes = matrix.view(np.uint32).reshape(matrix.shape + (-1,))[..., 0]
    codes = np.where(codes < 256, codes, 0)
    return lut[codes.astype(np.int64)]


# from_file keywords that configure a parser, not the Alignment itself
_PARSER_ONLY_KWARGS = ("raise_hmmer_prefixes", "a3m_inserts")


class Alignment:
    """Container to store and manipulate multiple sequence alignments.

    The character matrix stays on the host (numpy). The numeric members
    run on `device` (None: the CUDA device; "cpu" runs the plain PyTorch
    versions); set_weights, identities_to and conservation also take a
    device for one call. Sub-alignments keep the device.
    """

    def __init__(self, sequence_matrix, sequence_ids=None, annotation=None,
                 alphabet=ALPHABET_PROTEIN, device=None):
        self.matrix = np.array(sequence_matrix)
        self.N, self.L = self.matrix.shape

        self._match_gap = MATCH_GAP
        self._insert_gap = INSERT_GAP

        self.alphabet = alphabet
        self.alphabet_default = self._match_gap
        self.alphabet_map = map_from_alphabet(
            self.alphabet, default=self.alphabet_default
        )
        self.num_symbols = len(self.alphabet_map)
        self.device = device

        # lazily computed quantities
        self.matrix_mapped = None
        self.num_cluster_members = None
        self.weights = None
        self._frequencies = None
        self._pair_frequencies = None

        if sequence_ids is None:
            sequence_ids = [str(i) for i in range(self.N)]
        else:
            sequence_ids = list(sequence_ids)
            if len(sequence_ids) != self.N:
                raise ValueError(
                    "Number of sequence IDs ({}) and length of "
                    "alignment ({}) do not match".format(
                        len(sequence_ids), self.N
                    )
                )

        self.ids = np.array(sequence_ids, dtype=np.object_)
        self.id_to_index = {id_: i for i, id_ in enumerate(self.ids)}

        self.annotation = annotation if annotation is not None else {}

    @classmethod
    def from_dict(cls, sequences, **kwargs):
        """Create an alignment from an {id: sequence} mapping."""
        matrix = sequences_to_matrix(sequences.values())
        return cls(matrix, sequences.keys(), **kwargs)

    @classmethod
    def from_file(cls, fileobj, format="fasta", a3m_inserts="first",
                  raise_hmmer_prefixes=True, split_header=False, **kwargs):
        """Create an alignment by parsing a fasta/stockholm/a3m file."""
        if format == "fasta":
            seqs = OrderedDict(read_fasta(fileobj))
        elif format == "stockholm":
            ali = next(
                read_stockholm(
                    fileobj, read_annotation=True,
                    raise_hmmer_prefixes=raise_hmmer_prefixes,
                )
            )
            seqs = ali.seqs
            kwargs["annotation"] = {
                "GF": ali.gf, "GC": ali.gc, "GS": ali.gs, "GR": ali.gr,
            }
        elif format == "a3m":
            seqs = read_a3m(fileobj, inserts=a3m_inserts)
        else:
            raise ValueError("Invalid alignment format: " + str(format))

        if split_header:
            seqs = {
                header.split()[0]: seq for header, seq in seqs.items()
            }

        return cls.from_dict(seqs, **kwargs)

    @classmethod
    def from_path(cls, path, format=None, split_header=False, **kwargs):
        """Create an alignment from a file path (format None: detected
        from the file's content and extension).

        FASTA/A2M and Stockholm files are read by the port's C readers
        (evcouplings_torch.native); a file they refuse with ValueError
        (ragged a3m-style rows, a truncated Stockholm file, bytes the
        strict input guard refuses) and every other format go through the
        Python readers. Behavior is identical to from_file on an open
        handle.
        """
        if format is None:
            with open(path) as f:
                format = detect_format(f, filepath=path)
            if format is None:
                raise ValueError(
                    "Format of alignment {} could not be "
                    "automatically detected.".format(path)
                )

        if format == "fasta":
            loaded = cls._from_native_fasta(path, split_header, kwargs)
            if loaded is not None:
                return loaded
        elif format == "stockholm":
            loaded = cls._from_native_stockholm(
                path, split_header, kwargs
            )
            if loaded is not None:
                return loaded

        with open(path) as f:
            return cls.from_file(
                f, format=format, split_header=split_header, **kwargs
            )

    @classmethod
    def _from_native_fasta(cls, path, split_header, kwargs):
        """The C fasta reader; None means "use the Python reader" (ragged
        a3m-style input, or bytes the strict guard refuses)."""
        from evcouplings_torch.native import parse_fasta_native

        try:
            ids, matrix = parse_fasta_native(path)
        except ValueError:
            return None

        # duplicate headers: the Python path dedups FULL headers first
        # (OrderedDict: the first occurrence keeps its position, the last
        # supplies the sequence), THEN splits, then dedups the split ids
        # the same way; both stages are replicated here
        def _dedup(names, mat):
            if len(set(names)) == len(names):
                return names, mat
            last = {n: k for k, n in enumerate(names)}
            seen = set()
            order = [
                n for n in names if not (n in seen or seen.add(n))
            ]
            return order, mat[[last[n] for n in order]]

        ids, matrix = _dedup(ids, matrix)
        if split_header:
            ids = [i.split()[0] for i in ids]
            ids, matrix = _dedup(ids, matrix)

        ctor_kwargs = {
            k: v for k, v in kwargs.items()
            if k not in _PARSER_ONLY_KWARGS
        }
        return cls(matrix, ids, **ctor_kwargs)

    @classmethod
    def _from_native_stockholm(cls, path, split_header, kwargs):
        """The C stockholm reader; None means "use the Python reader"
        (a layout it does not cover); HMMER's prefix warning is raised."""
        from evcouplings_torch.native import parse_stockholm_native

        rhp = kwargs.get("raise_hmmer_prefixes", True)
        try:
            ids, matrix, annotation = parse_stockholm_native(
                path, raise_hmmer_prefixes=rhp,
            )
        except ValueError as e:
            if "HMMER added identifier prefixes" in str(e):
                raise
            return None

        if split_header:
            ids = [i.split()[0] for i in ids]

        ctor_kwargs = {
            k: v for k, v in kwargs.items()
            # the parsed annotation wins, as in the Python from_file path
            # (which overwrites a user-passed annotation kwarg)
            if k not in _PARSER_ONLY_KWARGS and k != "annotation"
        }
        return cls(matrix, ids, annotation=annotation, **ctor_kwargs)

    def __getitem__(self, index):
        row = self.id_to_index.get(index)
        if row is None and isinstance(index, (int, np.integer)):
            if 0 <= index < self.N:
                row = index
        if row is None:
            raise KeyError(
                "Not a valid index for sequence alignment: "
                "{}".format(index)
            )
        return self.matrix[row, :]

    def __len__(self):
        return self.N

    def count(self, char, axis="pos", normalize=True):
        """Count (optionally relative) occurrences of a character along an axis."""
        try:
            naxis = {"pos": 0, "seq": 1}[axis]
        except KeyError:
            raise ValueError("Invalid axis: " + str(axis)) from None

        hits = (self.matrix == char).sum(axis=naxis)
        if normalize:
            return hits / self.matrix.shape[naxis]
        return hits

    def select(self, columns=None, sequences=None):
        """Sub-alignment with a subset of columns and/or sequences
        (annotation is dropped, indices are not renumbered)."""
        if columns is None and sequences is None:
            return self

        picked = self.matrix
        ids = self.ids
        if columns is not None:
            picked = picked[:, columns]
        if sequences is not None:
            picked = picked[sequences, :]
            ids = ids[sequences]

        return Alignment(
            np.copy(picked), np.copy(ids), alphabet=self.alphabet,
            device=self.device,
        )

    def apply(self, columns=None, sequences=None, func=np.char.lower):
        """Apply a vectorized function to selected columns and/or rows
        (applied independently, columns first). Keeps annotation."""
        if columns is None and sequences is None:
            return self

        edited = np.copy(self.matrix)
        # guard empty selections: np.char funcs reject zero-size arrays
        if columns is not None and edited[:, columns].size:
            edited[:, columns] = func(edited[:, columns])
        if sequences is not None and edited[sequences, :].size:
            edited[sequences, :] = func(edited[sequences, :])

        return Alignment(
            edited, deepcopy(self.ids), deepcopy(self.annotation),
            alphabet=self.alphabet, device=self.device,
        )

    def replace(self, original, replacement, columns=None, sequences=None):
        """Replace a character in the full matrix or a subset."""
        return self.apply(
            columns, sequences,
            func=lambda x: np.char.replace(x, original, replacement),
        )

    def lowercase_columns(self, columns):
        """Lowercase a subset of columns and turn "-" into "." there
        (marks them as excluded from EC calculation)."""
        return self.apply(
            columns=columns, func=np.char.lower
        ).replace(
            self._match_gap, self._insert_gap, columns=columns
        )

    def _ensure_mapped_matrix(self):
        if self.matrix_mapped is None:
            self.matrix_mapped = map_matrix(self.matrix, self.alphabet_map)

    def _effective_weights(self):
        """Sequence weights if set_weights() ran, else uniform ones."""
        if self.weights is None:
            return np.ones(self.N)
        return self.weights

    def _device(self, device):
        return self.device if device is None else device

    def set_weights(self, identity_threshold=0.8, device=None):
        """Compute clustering-based sequence weights (K1 on the card).

        weight(s) = 1 / #{s': seqid(s, s') >= identity_threshold}; sets
        self.weights / self.num_cluster_members, resets cached
        frequencies. Gap positions participate in the identity count.
        """
        from evcouplings_torch.ops.weights import num_cluster_members

        self._ensure_mapped_matrix()
        self.num_cluster_members = num_cluster_members(
            self.matrix_mapped, identity_threshold,
            device=self._device(device),
        ).cpu().numpy()
        self.weights = 1.0 / self.num_cluster_members

        self._frequencies = None
        self._pair_frequencies = None

    def _frequencies_on(self, device):
        if self._frequencies is None:
            from evcouplings_torch.ops.frequencies import frequencies

            self._ensure_mapped_matrix()
            self._frequencies = frequencies(
                self.matrix_mapped, self._effective_weights(),
                self.num_symbols, device=device,
            )
        return self._frequencies

    @property
    def frequencies(self):
        """Weighted single-site frequencies (L x num_symbols), computed on
        the alignment's device. Uses self.weights if set_weights() was
        called."""
        return self._frequencies_on(self.device)

    @property
    def pair_frequencies(self):
        """Weighted pairwise frequencies (L x L x q x q) with
        f_ij[i,i,a,a] = f_i[i,a] on the diagonal."""
        if self._pair_frequencies is None:
            from evcouplings_torch.ops.frequencies import pair_frequencies

            self._ensure_mapped_matrix()
            self._pair_frequencies = pair_frequencies(
                self.matrix_mapped, self._effective_weights(),
                self.num_symbols, self.frequencies, device=self.device,
            )
        return self._pair_frequencies

    def identities_to(self, seq, normalize=True, device=None):
        """Sequence identity of every alignment row to the given sequence."""
        from evcouplings_torch.ops.weights import identities_to_seq

        self._ensure_mapped_matrix()
        target = map_matrix(np.array(list(seq)), self.alphabet_map)
        counts = identities_to_seq(
            target, self.matrix_mapped, device=self._device(device)
        ).cpu().numpy()
        return counts / self.L if normalize else counts

    def conservation(self, normalize=True, device=None):
        """Per-column conservation from single-column frequency entropy."""
        return entropy_rows(
            self._frequencies_on(self._device(device)), normalize=normalize
        )

    def write(self, fileobj, format="fasta", width=80):
        """Write alignment in fasta, a3m, or aln format."""
        writers = {
            "fasta": lambda s: write_fasta(s, fileobj, width),
            "a3m": lambda s: write_a3m(
                s, fileobj, self._insert_gap, width
            ),
            "aln": lambda s: write_aln(s, fileobj, width),
        }
        if format not in writers:
            raise ValueError("Invalid alignment format: " + str(format))

        writers[format](
            (id_, "".join(self.matrix[i]))
            for i, id_ in enumerate(self.ids)
        )
