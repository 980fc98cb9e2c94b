"""
CouplingsModel: storage and calculations for pairwise undirected graphical
models of sequences (Potts models): statistical energies, mutation effects
and coupling scores (port of evcouplings_tpu/couplings/model.py).

Parameters are float64 numpy arrays on the host; the binary codec writes
the plmc_v2 and plmc_v1 formats byte for byte as the JAX package does.

plmc_v2 layout (all little-endian):
  int32[5]   L, num_symbols, N_valid, N_invalid, num_iter
  float[5]   theta, lambda_h, lambda_J, lambda_group, N_eff
  S1[q]      alphabet
  float[N]   sequence weights (N = N_valid + N_invalid)
  S1[L]      target sequence
  int32[L]   index list
  float[L,q]      f_i
  float[L,q]      h_i
  float[P,q,q]    f_ij upper triangle (i<j, row-major pair order)
  float[P,q,q]    J_ij upper triangle
A negative lambda_h marks a mean-field model (couplings/mean_field.py).
"""

from collections.abc import Iterable
from copy import deepcopy

import numpy as np
import pandas as pd

from evcouplings_torch.ops import hamiltonian as _ham
from evcouplings_torch.ops import scores as _scores

_SLICE = np.s_[:]
HAMILTONIAN_COMPONENTS = [FULL, COUPLINGS, FIELDS] = [0, 1, 2]
NUM_COMPONENTS = len(HAMILTONIAN_COMPONENTS)


def _read_array(f, dtype, count):
    """np.fromfile that also works on non-file buffers (e.g. BytesIO)."""
    dtype = np.dtype(dtype)
    try:
        data = np.fromfile(f, dtype, count)
    except (AttributeError, OSError, TypeError, ValueError):
        raw = f.read(dtype.itemsize * count)
        data = np.frombuffer(raw, dtype=dtype).copy()
    if data.size != count:
        raise ValueError(
            "Premature end of model file (wanted {} x {}, got {})".format(
                count, dtype, data.size
            )
        )
    return data


def _triu_pairs(L):
    """Upper-triangle pair indices in the file's row-major (i<j) order."""
    return np.triu_indices(L, k=1)


def _ec_derived(attr, doc):
    """Lazy property over an EC-derived cache slot: trigger one
    _calculate_ecs() pass when the slot is still empty."""
    def getter(self):
        if getattr(self, attr) is None:
            self._calculate_ecs()
        return getattr(self, attr)
    getter.__doc__ = doc
    return property(getter)


class CouplingsModel:
    """Potts model parameter container with EC scoring and mutation deltas."""

    def __init__(self, model_file=None, precision="float32",
                 file_format="plmc_v2", device=None, **kwargs):
        """Initialize from a binary model file (path or open handle).

        A plmc_v2 file of a mean-field model (negative lambda_h) gives a
        couplings.mean_field.MeanFieldCouplingsModel, whose DI scores are
        computed on `device` (None: the CUDA device). Use from_params() to
        construct directly from in-memory arrays (e.g. from the PLM
        fitter).
        """
        if model_file is None:
            # bare object; from_params fills the fields
            return
        self.device = device

        is_file_obj = hasattr(model_file, "read")

        if file_format == "plmc_v2":
            if is_file_obj:
                self._read_plmc_v2(model_file, precision)
            else:
                with open(model_file, "rb") as f:
                    self._read_plmc_v2(f, precision)
        elif file_format == "plmc_v1":
            if is_file_obj:
                self._read_plmc_v1(model_file, precision,
                                   kwargs.get("alphabet", None))
            else:
                with open(model_file, "rb") as f:
                    self._read_plmc_v1(f, precision,
                                       kwargs.get("alphabet", None))
        else:
            raise ValueError(
                "Illegal file format {}, valid options are: "
                "plmc_v2, plmc_v1".format(file_format)
            )

        self._finalize_init()

    def _finalize_init(self):
        self.alphabet_map = {s: i for i, s in enumerate(self.alphabet)}

        # in non-gap mode the focus sequence may contain the gap character
        # even though gap is not in the model alphabet; a failing mapping
        # means there is no usable target sequence
        try:
            self.target_seq_mapped = np.array(
                [self.alphabet_map[x] for x in self.target_seq]
            )
            self.has_target_seq = (np.sum(self.target_seq_mapped) > 0)
        except KeyError:
            self.target_seq_mapped = np.zeros((self.L), dtype=np.int32)
            self.has_target_seq = False

        self._reset_precomputed()

    @classmethod
    def from_params(cls, J_ij, h_i, f_i, f_ij, alphabet, target_seq,
                    index_list, weights=None, theta=0.8, lambda_h=0.01,
                    lambda_J=0.01, lambda_group=0.0, N_valid=None,
                    N_invalid=0, num_iter=0, N_eff=None):
        """Construct a model from in-memory parameters (fitter output)."""
        m = cls(model_file=None)
        m.L, m.num_symbols = h_i.shape
        m.N_valid = int(N_valid) if N_valid is not None else (
            len(weights) if weights is not None else 0
        )
        m.N_invalid = int(N_invalid)
        m.num_iter = int(num_iter)
        m.theta = float(theta)
        m.lambda_h = float(lambda_h)
        m.lambda_J = float(lambda_J)
        m.lambda_group = float(lambda_group)
        m.N_eff = float(N_eff) if N_eff is not None else (
            float(np.sum(weights)) if weights is not None else float(m.N_valid)
        )
        m.alphabet = np.array(list(alphabet), dtype="U1")
        m.weights = (
            np.asarray(weights, dtype=np.float64)
            if weights is not None
            else np.ones(m.N_valid)
        )
        m._target_seq = np.array(list(target_seq), dtype="U1")
        m.index_list = np.asarray(index_list, dtype=np.int64)
        m.f_i = np.asarray(f_i, dtype=np.float64)
        m.h_i = np.asarray(h_i, dtype=np.float64)
        m.f_ij = np.asarray(f_ij, dtype=np.float64)
        m.J_ij = np.asarray(J_ij, dtype=np.float64)
        m._finalize_init()
        return m

    def _reset_precomputed(self):
        """Drop precomputed mutation matrices and scores."""
        self._single_mut_mat_full = None
        self._double_mut_mat = None
        self._coupling_field_cache = None
        self._cn_scores = None
        self._fn_scores = None
        self._mi_scores_raw = None
        self._mi_scores_apc = None
        self._ecs = None

    # ------------------------------------------------------------------
    # binary codec
    # ------------------------------------------------------------------

    def _read_plmc_v2(self, f, precision):
        """Read the plmc_v2 binary format (reference model.py:317-400).

        The pair-block triangles are read in single bulk reads instead of a
        Python loop per pair.
        """
        (self.L, self.num_symbols, self.N_valid, self.N_invalid,
         self.num_iter) = _read_array(f, "int32", 5)

        (self.theta, self.lambda_h, self.lambda_J, self.lambda_group,
         self.N_eff) = _read_array(f, precision, 5)

        self.alphabet = _read_array(f, "S1", self.num_symbols).astype("U1")
        self.weights = _read_array(
            f, precision, int(self.N_valid) + int(self.N_invalid)
        )
        self._target_seq = _read_array(f, "S1", self.L).astype("U1")
        self.index_list = _read_array(f, "int32", self.L)

        L, q = int(self.L), int(self.num_symbols)
        self.f_i = _read_array(f, precision, L * q).reshape(L, q).astype(
            np.float64
        )
        self.h_i = _read_array(f, precision, L * q).reshape(L, q).astype(
            np.float64
        )

        n_pairs = L * (L - 1) // 2
        ii, jj = _triu_pairs(L)

        self.f_ij = np.zeros((L, L, q, q))
        blocks = _read_array(f, precision, n_pairs * q * q).reshape(
            n_pairs, q, q
        )
        self.f_ij[ii, jj] = blocks
        self.f_ij[jj, ii] = blocks.transpose(0, 2, 1)

        self.J_ij = np.zeros((L, L, q, q))
        blocks = _read_array(f, precision, n_pairs * q * q).reshape(
            n_pairs, q, q
        )
        self.J_ij[ii, jj] = blocks
        self.J_ij[jj, ii] = blocks.transpose(0, 2, 1)

        # negative lambda_h marks a mean-field model (stores -pseudocount)
        if self.lambda_h < 0:
            from evcouplings_torch.couplings.mean_field import (
                MeanFieldCouplingsModel,
            )

            self.__class__ = MeanFieldCouplingsModel
            self.transform_from_plmc_model()

    def _read_plmc_v1(self, f, precision, alphabet=None):
        """Read the legacy plmc_v1 format (reference model.py:402-512):
        interleaved (i, j, f_ij, J_ij) with 1-based indices, no metadata."""
        GAP = "-"
        ALPHABET_PROTEIN_NOGAP = "ACDEFGHIKLMNPQRSTVWY"
        ALPHABET_PROTEIN = GAP + ALPHABET_PROTEIN_NOGAP

        self.L, = _read_array(f, "int32", 1)
        self.num_symbols, = _read_array(f, "int32", 1)

        if alphabet is None:
            if self.num_symbols == 21:
                alphabet = ALPHABET_PROTEIN
            elif self.num_symbols == 20:
                alphabet = ALPHABET_PROTEIN_NOGAP
            else:
                raise ValueError(
                    "Could not guess default alphabet for {} states, "
                    "specify alphabet parameter.".format(self.num_symbols)
                )
        else:
            if len(alphabet) != self.num_symbols:
                raise ValueError(
                    "Size of alphabet ({}) does not agree with number of "
                    "states in model ({})".format(
                        len(alphabet), self.num_symbols
                    )
                )

        self.alphabet = np.array(list(alphabet))
        self._target_seq = _read_array(f, "S1", self.L).astype("U1")
        self.index_list = _read_array(f, "int32", self.L)

        # information missing from v1 files
        for absent in ("N_valid", "N_invalid", "num_iter", "theta",
                       "lambda_h", "lambda_J", "lambda_group", "N_eff",
                       "weights"):
            setattr(self, absent, None)

        L, q = int(self.L), int(self.num_symbols)
        self.f_i = _read_array(f, precision, L * q).reshape(L, q).astype(
            np.float64
        )
        self.h_i = _read_array(f, precision, L * q).reshape(L, q).astype(
            np.float64
        )

        self.f_ij = np.zeros((L, L, q, q))
        self.J_ij = np.zeros((L, L, q, q))

        for i in range(L - 1):
            for j in range(i + 1, L):
                file_i, file_j = _read_array(f, "int32", 2)
                if i + 1 != file_i or j + 1 != file_j:
                    raise ValueError(
                        "Error: column pair indices inconsistent. "
                        "Expected: {} {}; File: {} {}".format(
                            i + 1, j + 1, file_i, file_j
                        )
                    )
                block = _read_array(f, precision, q * q).reshape(q, q)
                self.f_ij[i, j] = block
                self.f_ij[j, i] = block.T
                block = _read_array(f, precision, q * q).reshape(q, q)
                self.J_ij[i, j] = block
                self.J_ij[j, i] = block.T

    def to_file(self, out_file, precision="float32", file_format="plmc_v2"):
        """Write the model in plmc_v2 (default) or plmc_v1 binary format.

        Byte-level parity with reference model.py:1200-1253.
        """
        new = file_format.lower() == "plmc_v2"
        L, q = int(self.L), int(self.num_symbols)
        ii, jj = _triu_pairs(L)

        with open(out_file, "wb") as f:
            np.array([self.L, self.num_symbols], dtype="int32").tofile(f)
            if new:
                np.array(
                    [self.N_valid, self.N_invalid, self.num_iter],
                    dtype="int32",
                ).tofile(f)
                np.array(
                    [self.theta, self.lambda_h, self.lambda_J,
                     self.lambda_group, self.N_eff],
                    dtype=precision,
                ).tofile(f)
                alphabet_bytes = self.alphabet.astype("S1")
                alphabet_bytes[alphabet_bytes != b""].tofile(f)
                self.weights.astype(precision).tofile(f)

            target_bytes = self.target_seq.astype("S1")
            target_bytes[target_bytes != b""].tofile(f)
            np.asarray(self.index_list).astype("int32").tofile(f)
            for site_arr in (self.f_i, self.h_i):
                site_arr.astype(precision).tofile(f)

            if not new:
                # v1 interleaves an int32 (i+1, j+1) header per pair
                for i, j in zip(ii, jj):
                    np.array([i + 1, j + 1], dtype="int32").tofile(f)
                    self.f_ij[i, j].astype(precision).tofile(f)
                    self.J_ij[i, j].astype(precision).tofile(f)
            else:
                self.f_ij[ii, jj].astype(precision).tofile(f)
                self.J_ij[ii, jj].astype(precision).tofile(f)

    # ------------------------------------------------------------------
    # target sequence / index mapping
    # ------------------------------------------------------------------

    @property
    def target_seq(self):
        """Target/focus sequence used for delta_hamiltonian calculations."""
        return self._target_seq

    @target_seq.setter
    def target_seq(self, sequence):
        self._reset_precomputed()

        if len(sequence) != self.L:
            raise ValueError(
                "Sequence length inconsistent with model length: "
                "{} {}".format(len(sequence), self.L)
            )

        if isinstance(sequence, str):
            sequence = list(sequence)

        self._target_seq = np.array(sequence)
        self.target_seq_mapped = np.array(
            [self.alphabet_map[x] for x in self.target_seq]
        )
        self.has_target_seq = True

    @property
    def index_list(self):
        """Mapping of model positions to sequence numbering."""
        return self._index_list

    @index_list.setter
    def index_list(self, mapping):
        if len(mapping) != self.L:
            raise ValueError(
                "Mapping length inconsistent with model length: "
                "{} {}".format(len(mapping), self.L)
            )

        self._index_list = deepcopy(mapping)
        self.index_map = {b: a for a, b in enumerate(self.index_list)}

        # refresh only a STALE table: _reset_precomputed always
        # creates the attribute (as None), so hasattr would eagerly
        # pay the full O(L^2 q^2) EC computation on every renumbering
        # (e.g. SegmentIndexMapper.patch_model for every complex
        # model) even when nothing had been computed yet — the lazy
        # properties handle the never-computed case on demand
        if getattr(self, "_ecs", None) is not None:
            self._calculate_ecs()

    # ------------------------------------------------------------------
    # energies / mutation deltas
    # ------------------------------------------------------------------

    def convert_sequences(self, sequences):
        """Map sequence strings to integer symbol matrices."""
        seq_lens = list(set(map(len, sequences)))
        if len(seq_lens) != 1:
            raise ValueError(
                "Input sequences have different lengths: " + str(seq_lens)
            )

        L_seq = seq_lens[0]
        if L_seq != self.L:
            raise ValueError(
                "Sequence lengths do not correspond to model length: "
                "{} {}".format(L_seq, self.L)
            )

        S = np.empty((len(sequences), L_seq), dtype=int)
        for i, s in enumerate(sequences):
            try:
                S[i] = [self.alphabet_map[x] for x in s]
            except KeyError:
                raise ValueError(
                    "Invalid symbol in sequence {}: {}".format(i, s)
                )
        return S

    def hamiltonians(self, sequences):
        """Statistical energies (total, couplings, fields) per sequence."""
        if isinstance(sequences, list):
            sequences = self.convert_sequences(sequences)
        return _ham.hamiltonians(sequences, self.J_ij, self.h_i)

    @property
    def single_mut_mat_full(self):
        """(L, q, 3) delta Hamiltonians for all single mutants."""
        if self._single_mut_mat_full is None:
            self._single_mut_mat_full = _ham.single_mutant_hamiltonians(
                self.target_seq_mapped, self.J_ij, self.h_i
            )
        return self._single_mut_mat_full

    @property
    def single_mut_mat(self):
        """(L, q) total delta Hamiltonians for all single mutants."""
        return self.single_mut_mat_full[:, :, FULL]

    def delta_hamiltonian(self, substitutions, verify_mutants=True):
        """Delta energy for a list of (pos, subs_from, subs_to) tuples."""
        pos = np.empty(len(substitutions), dtype=int)
        subs = np.empty(len(substitutions), dtype=int)

        try:
            for i, (subs_pos, subs_from, subs_to) in enumerate(substitutions):
                pos[i] = self.index_map[subs_pos]
                subs[i] = self.alphabet_map[subs_to]
                if verify_mutants and subs_from != self.target_seq[pos[i]]:
                    raise ValueError(
                        "Inconsistency with target sequence: "
                        "pos={} target={} subs={}".format(
                            subs_pos, self.target_seq[pos[i]], subs_from
                        )
                    )
        except KeyError:
            raise ValueError(
                "Illegal substitution: {}{}{}\nAlphabet: {}\n"
                "Positions: {}".format(
                    subs_from, subs_pos, subs_to,
                    self.alphabet_map, self.index_list
                )
            )

        # the coupling field depends only on (J_ij, target_seq):
        # computed once, it turns the per-mutant cost of large
        # mutation-table scans from O(L^2 q) into O(M L)
        if self._coupling_field_cache is None:
            self._coupling_field_cache = _ham._coupling_field(
                self.J_ij, self.target_seq_mapped
            )
        return _ham.delta_hamiltonian(
            pos, subs, self.target_seq_mapped, self.J_ij, self.h_i,
            coupling_field=self._coupling_field_cache,
        )

    @property
    def double_mut_mat(self):
        """(L, L, q, q) delta Hamiltonians for all double mutants."""
        if self._double_mut_mat is None:
            self._double_mut_mat = _ham.double_mutant_matrix(
                self.single_mut_mat, self.J_ij, self.target_seq_mapped
            )
        return self._double_mut_mat

    # ------------------------------------------------------------------
    # EC scores
    # ------------------------------------------------------------------

    @classmethod
    def apc(cls, matrix):
        """Average product correction (Dunn et al., 2008)."""
        return _scores.apc(matrix)

    def _calculate_ecs(self):
        """FN/CN scores (Ekeberg et al., 2013) and MI scores + EC table."""
        self._fn_scores = _scores.fn_scores(self.J_ij)
        self._mi_scores_raw = _scores.mi_scores(self.f_ij, self.f_i)
        self._cn_scores = _scores.apc(self._fn_scores)
        self._mi_scores_apc = _scores.apc(self._mi_scores_raw)

        L = int(self.L)
        ii, jj = _triu_pairs(L)
        index_arr = np.asarray(self.index_list)
        if index_arr.ndim > 1:
            # (segment, position) tuple numbering (a model patched by
            # SegmentIndexMapper): keep one tuple per entry instead of
            # letting numpy spread tuples into a 2D array
            index_arr = np.empty(len(self.index_list), dtype=object)
            index_arr[:] = [tuple(x) for x in self.index_list]
        try:
            seqdist = np.abs(index_arr[ii] - index_arr[jj])
        except TypeError:
            seqdist = np.full(len(ii), np.nan)

        self._ecs = pd.DataFrame(
            {
                "i": index_arr[ii],
                "A_i": self.target_seq[ii],
                "j": index_arr[jj],
                "A_j": self.target_seq[jj],
                "seqdist": seqdist,
                "mi_raw": self._mi_scores_raw[ii, jj],
                "mi_apc": self._mi_scores_apc[ii, jj],
                "fn": self._fn_scores[ii, jj],
                "cn": self._cn_scores[ii, jj],
            }
        ).sort_values(by="cn", ascending=False)

    # EC-derived quantities are computed lazily by one _calculate_ecs
    # pass and cached on their underscored slots
    cn_scores = _ec_derived(
        "_cn_scores", "(L, L) corrected-norm scores.")
    fn_scores = _ec_derived(
        "_fn_scores", "(L, L) Frobenius-norm scores.")
    mi_scores_raw = _ec_derived(
        "_mi_scores_raw", "(L, L) mutual information scores (no APC).")
    mi_scores_apc = _ec_derived(
        "_mi_scores_apc",
        "(L, L) mutual information scores (APC-corrected).")
    ecs = _ec_derived("_ecs", "EC DataFrame sorted by CN score.")

    def to_independent_model(self):
        """Single-site model fit with L2 regularization (BFGS per site).

        Parity: reference model.py:882-925 (scipy fmin_bfgs with identical
        objective/gradient).
        """
        from scipy.optimize import fmin_bfgs

        lam, n_eff = self.lambda_h, self.N_eff

        def _site_objective(x, fi):
            ex = np.exp(x)
            return (n_eff * (np.log(ex.sum()) - (fi * x).sum())
                    + lam * (x ** 2).sum())

        def _site_gradient(x, fi):
            ex = np.exp(x)
            return n_eff * (ex / ex.sum() - fi) + lam * 2 * x

        h_i = np.stack([
            fmin_bfgs(
                _site_objective, np.zeros(self.num_symbols),
                _site_gradient, args=(self.f_i[i],), disp=False,
            )
            for i in range(self.L)
        ])

        c0 = deepcopy(self)
        c0.h_i, c0.J_ij = h_i, np.zeros_like(self.J_ij)
        c0._reset_precomputed()
        return c0

    # ------------------------------------------------------------------
    # index-mapped accessors (syntactic sugar); the method names and
    # signatures are the reference's public API, the bodies are
    # generated by the _mapped_* factories below the class
    # ------------------------------------------------------------------

    def _map_key(self, indices, mapping):
        # single indices may be tuples ((segment, pos) keys), so only
        # non-tuple/non-string iterables are index sequences
        if (isinstance(indices, Iterable)
                and not isinstance(indices, (str, tuple))):
            return np.array([mapping[k] for k in indices])
        return mapping[indices]

    def _resolve_axes(self, axes):
        """(value, mapping) pairs -> index tuple (None -> full slice)."""
        return tuple(
            _SLICE if v is None else self._map_key(v, m)
            for v, m in axes
        )

    def mn(self, i=None):
        """Map sequence numbering to internal model numbering."""
        if i is None:
            return np.array(sorted(self.index_map.values()))
        return self._map_key(i, self.index_map)

    def mui(self, i=None):
        """Legacy alias of mn()."""
        return self.mn(i)

    def sn(self, i=None):
        """Map internal numbering to sequence numbering."""
        if i is None:
            return np.array(self.index_list)
        return self._map_key(i, self.index_list)

    def itu(self, i=None):
        """Legacy alias of sn()."""
        return self.sn(i)

    def seq(self, i=None):
        """Target sequence symbols (optionally at mapped positions)."""
        if i is None:
            return self.target_seq
        internal = self._map_key(i, self.index_map)
        return self._map_key(internal, self.target_seq)


def _mapped_tensor4(source, doc):
    """Accessor factory for (L, L, q, q) tensors: positions i/j and
    symbols A_i/A_j translate through the model's index/alphabet maps,
    with None selecting the full axis."""
    def accessor(self, i=None, j=None, A_i=None, A_j=None):
        pos, sym = self.index_map, self.alphabet_map
        return getattr(self, source)[self._resolve_axes(
            ((i, pos), (j, pos), (A_i, sym), (A_j, sym))
        )]
    accessor.__doc__ = doc
    return accessor


def _mapped_site(source, doc):
    """Accessor factory for (L, q) matrices (position + symbol)."""
    def accessor(self, i=None, A_i=None):
        return getattr(self, source)[self._resolve_axes(
            ((i, self.index_map), (A_i, self.alphabet_map))
        )]
    accessor.__doc__ = doc
    return accessor


def _mapped_pair(source, doc):
    """Accessor factory for (L, L) score matrices (two positions)."""
    def accessor(self, i=None, j=None):
        return getattr(self, source)[self._resolve_axes(
            ((i, self.index_map), (j, self.index_map))
        )]
    accessor.__doc__ = doc
    return accessor


# the reference's sugar accessor API (model.py:927-1098): method name,
# factory shape, backing attribute/property
for _name, _factory, _source, _doc in [
    ("Jij", _mapped_tensor4, "J_ij",
     "J_ij with index/symbol mapping applied."),
    ("fij", _mapped_tensor4, "f_ij",
     "f_ij with index/symbol mapping applied."),
    ("dmm", _mapped_tensor4, "double_mut_mat",
     "Double-mutant delta Hamiltonians with index/symbol mapping."),
    ("hi", _mapped_site, "h_i",
     "h_i with index/symbol mapping applied."),
    ("fi", _mapped_site, "f_i",
     "f_i with index/symbol mapping applied."),
    ("smm", _mapped_site, "single_mut_mat",
     "Single-mutant delta Hamiltonians with index/symbol mapping."),
    ("cn", _mapped_pair, "cn_scores",
     "CN scores with index mapping applied."),
    ("fn", _mapped_pair, "fn_scores",
     "FN scores with index mapping applied."),
    ("mi_apc", _mapped_pair, "mi_scores_apc",
     "APC-corrected MI scores with index mapping applied."),
    ("mi_raw", _mapped_pair, "mi_scores_raw",
     "Raw MI scores with index mapping applied."),
]:
    _accessor = _factory(_source, _doc)
    _accessor.__name__ = _name
    _accessor.__qualname__ = "CouplingsModel." + _name
    setattr(CouplingsModel, _name, _accessor)
