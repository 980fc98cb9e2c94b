"""
Mean-field direct coupling analysis (DCA) (port of
evcouplings_tpu/couplings/mean_field.py).

MeanFieldDCA reweights a focus-mode alignment (K1 on the card, through
Alignment.set_weights), regularizes its frequencies with a pseudo-count,
inverts the covariance matrix (float64 on the alignment's device by
default) and derives couplings and fields; MeanFieldCouplingsModel adds
direct information (DI) to the EC scores.

Model-file convention: a mean-field model is stored in the plmc_v2 binary
format with lambda_h = -pseudo_count as its marker and placeholder values
for the plmc-only fields; CouplingsModel turns such a file back into a
MeanFieldCouplingsModel.
"""

from copy import deepcopy

import numpy as np

from evcouplings_torch.align.alignment import parse_header
from evcouplings_torch.couplings.model import CouplingsModel
from evcouplings_torch.ops import mean_field as _mf

# kernel entry points under the reference's names (ops/mean_field.py)
compute_covariance_matrix = _mf.compute_covariance_matrix
reshape_invC_to_4d = _mf.reshape_invC_to_4d
fields = _mf.fields_from_couplings
tilde_fields = _mf.tilde_fields
direct_information = _mf.direct_information

# value written to file for the plmc-specific parameters
_PLACEHOLDER = -1


def regularize_frequencies(f_i, pseudo_count=0.5):
    """Pseudo-count-regularized single-site frequencies:
    f~ = (1 - pc) f + pc / q."""
    num_symbols = f_i.shape[-1]
    return (1.0 - pseudo_count) * f_i + pseudo_count / float(num_symbols)


def regularize_pair_frequencies(f_ij, pseudo_count=0.5):
    """Pseudo-count-regularized pair frequencies: off-diagonal pairs get
    pc / q^2; the diagonal (i, i) blocks (1 - pc) f_ij[i, i] + (pc / q) I,
    so that f~_ij[i, i, a, a] tracks the regularized f~_i."""
    L, _, num_symbols, _ = f_ij.shape
    reg = (1.0 - pseudo_count) * f_ij + pseudo_count / float(num_symbols ** 2)
    idx = np.arange(L)
    reg[idx, idx] = (
        (1.0 - pseudo_count) * f_ij[idx, idx]
        + (pseudo_count / num_symbols) * np.identity(num_symbols)[None]
    )
    return reg


class MeanFieldDCA:
    """Mean-field DCA inference from a focus-mode (a2m) alignment.

    The target sequence is the alignment's first record; the focus
    columns are its uppercase non-gap positions. The numerics run on the
    alignment's device (None: the CUDA device).
    """

    def __init__(self, alignment):
        self._raw_alignment = alignment
        target_seq = alignment[0]

        gaps = (alignment._match_gap, alignment._insert_gap)
        focus_cols = np.fromiter(
            (c.isupper() and c not in gaps for c in target_seq),
            dtype=bool, count=len(target_seq),
        )
        focus_ali = alignment.select(columns=focus_cols)

        # target-sequence numbering restricted to the focus columns
        _, start, stop = parse_header(alignment.ids[0])
        self.index_list = np.arange(start, stop + 1)[focus_cols]

        # drop sequences with symbols outside the alphabet
        alphabet_arr = np.asarray(list(focus_ali.alphabet))
        valid = np.isin(focus_ali.matrix, alphabet_arr).all(axis=1)
        self.alignment = focus_ali.select(sequences=valid)
        self._reset()

    def _reset(self):
        """Drop weights, frequencies and covariance state (fit() may run
        again with another theta or pseudo-count)."""
        self.alignment.weights = None
        self.alignment._frequencies = None
        self.alignment._pair_frequencies = None
        for attr in ("regularized_frequencies",
                     "regularized_pair_frequencies",
                     "covariance_matrix", "covariance_matrix_inv"):
            setattr(self, attr, None)

    def fit(self, theta=0.8, pseudo_count=0.5, device=False, mesh=None):
        """Run mean-field DCA; returns a MeanFieldCouplingsModel.

        Reweight at theta, regularize f_i/f_ij with the pseudo-count,
        build the covariance matrix C, J = -C^-1, then the fields.

        device=True inverts C in float32 (the JAX package's device path);
        the default inverts it in float64. Either runs on the alignment's
        device. mesh (an evcouplings_torch.parallel mesh on which every
        rank calls fit): the reweighting is split over its "data" ranks
        (parallel.num_cluster_members_sharded) and the float64 inversion's
        solves too (ops/mean_field.invert_covariance_sharded); the
        alignment's device should be the mesh's.
        """
        self._reset()
        self.alignment.set_weights(identity_threshold=theta, mesh=mesh)
        self.regularize_frequencies(pseudo_count=pseudo_count)
        self.regularize_pair_frequencies(pseudo_count=pseudo_count)

        self.compute_covariance_matrix()
        if mesh is not None:
            inv = _mf.invert_covariance_sharded(self.covariance_matrix, mesh)
        elif device:
            inv = _mf.invert_covariance_device(self.covariance_matrix)
        else:
            inv = _mf.invert_covariance(self.covariance_matrix)
        self.covariance_matrix_inv = inv

        J_ij = self.reshape_invC_to_4d()
        h_i = _mf.fields_from_couplings(J_ij, self.regularized_frequencies,
                                        device=J_ij.device)
        return MeanFieldCouplingsModel(
            alignment=self.alignment,
            index_list=self.index_list,
            regularized_f_i=self.regularized_frequencies,
            regularized_f_ij=self.regularized_pair_frequencies,
            h_i=h_i.cpu().numpy(),
            J_ij=J_ij.cpu().numpy(),
            theta=theta,
            pseudo_count=pseudo_count,
        )

    def regularize_frequencies(self, pseudo_count=0.5):
        self.regularized_frequencies = regularize_frequencies(
            self.alignment.frequencies, pseudo_count=pseudo_count)
        return self.regularized_frequencies

    def regularize_pair_frequencies(self, pseudo_count=0.5):
        self.regularized_pair_frequencies = regularize_pair_frequencies(
            self.alignment.pair_frequencies, pseudo_count=pseudo_count)
        return self.regularized_pair_frequencies

    def compute_covariance_matrix(self):
        """(L(q-1), L(q-1)) float64 tensor on the alignment's device."""
        self.covariance_matrix = _mf.compute_covariance_matrix(
            self.regularized_frequencies, self.regularized_pair_frequencies,
            device=self.alignment.device)
        return self.covariance_matrix

    def reshape_invC_to_4d(self):
        return _mf.reshape_invC_to_4d(
            self.covariance_matrix_inv, self.alignment.L,
            self.alignment.num_symbols)

    def fields(self):
        J_ij = self.reshape_invC_to_4d()
        return _mf.fields_from_couplings(
            J_ij, self.regularized_frequencies, device=J_ij.device)


class MeanFieldCouplingsModel(CouplingsModel):
    """CouplingsModel for mean-field results: keeps the regularized
    frequencies and adds DI (direct information) scores, computed on
    `device` (the alignment's; for a model read from a file, the device
    given to CouplingsModel)."""

    def __init__(self, alignment=None, index_list=None, regularized_f_i=None,
                 regularized_f_ij=None, h_i=None, J_ij=None, theta=None,
                 pseudo_count=None):
        # also made by CouplingsModel._read_plmc_v2 through a __class__
        # swap + transform_from_plmc_model(), without __init__
        self.L, self.num_symbols = alignment.L, alignment.num_symbols
        # only valid-sequence weights are stored, so N_invalid = 0
        self.N_valid, self.N_invalid = alignment.N, 0
        w = alignment.weights
        self.weights = np.ones(alignment.N) if w is None else w
        self.N_eff = self.weights.sum()
        self.device = alignment.device

        self.alphabet = np.array(list(alignment.alphabet))
        self.alphabet_map = {s: k for k, s in enumerate(self.alphabet)}

        # numbering before the target_seq setter, so no EC table is
        # computed here (the lazy properties do it on demand)
        self.index_list = index_list
        self.target_seq = list(alignment.matrix[0])

        self.f_i, self.f_ij = (alignment.frequencies,
                               alignment.pair_frequencies)
        self.regularized_f_i = regularized_f_i
        self.regularized_f_ij = regularized_f_ij
        self.h_i, self.J_ij = h_i, J_ij
        self.theta, self.pseudo_count = theta, pseudo_count

        self._decode_unused_fields(save_pseudo_count=False)
        self._reset_precomputed()

    @classmethod
    def from_params(cls, J_ij, h_i, f_i, f_ij, alphabet, target_seq,
                    index_list, regularized_f_i, regularized_f_ij,
                    pseudo_count, weights=None, theta=0.8, N_valid=None,
                    N_eff=None, device=None, **ignored):
        """A mean-field model from in-memory arrays (e.g. a JAX-package
        MeanFieldCouplingsModel's, see convert.model_from_jax)."""
        del ignored
        m = CouplingsModel.from_params(
            J_ij=J_ij, h_i=h_i, f_i=f_i, f_ij=f_ij, alphabet=alphabet,
            target_seq=target_seq, index_list=index_list, weights=weights,
            theta=theta, N_valid=N_valid, N_invalid=0, N_eff=N_eff)
        m.__class__ = cls
        m.device = device
        m.regularized_f_i = np.asarray(regularized_f_i, dtype=np.float64)
        m.regularized_f_ij = np.asarray(regularized_f_ij, dtype=np.float64)
        m.pseudo_count = pseudo_count
        m._decode_unused_fields(save_pseudo_count=False)
        m._reset_precomputed()
        return m

    def _reset_precomputed(self):
        """Additionally reset the DI scores."""
        super()._reset_precomputed()
        self._di_scores = None

    def _calculate_ecs(self):
        """FN/CN/MI scores via the parent, then DI appended. The stored
        table is sorted by (i, j) with a "di" column; the return value is
        sorted by DI, descending."""
        super()._calculate_ecs()
        self._di_scores = _mf.direct_information(
            self.J_ij, self.regularized_f_i,
            device=getattr(self, "device", None)).cpu().numpy()

        ii, jj = np.triu_indices(self.L, k=1)
        self._ecs = self._ecs.sort_values(by=["i", "j"])
        self._ecs.loc[:, "di"] = self._di_scores[ii, jj]
        return self._ecs.sort_values(by="di", ascending=False)

    def regularize_f_i(self):
        self.regularized_f_i = regularize_frequencies(self.f_i,
                                                      self.pseudo_count)
        return self.regularized_f_i

    def regularize_f_ij(self):
        self.regularized_f_ij = regularize_pair_frequencies(
            self.f_ij, self.pseudo_count)
        return self.regularized_f_ij

    def tilde_fields(self, i, j):
        """h-tilde fields of the two-site model of positions (i, j)."""
        return _mf.tilde_fields(
            np.exp(self.J_ij[i, j]), self.regularized_f_i[i],
            self.regularized_f_i[j], device=getattr(self, "device", None))

    @property
    def di_scores(self):
        """(L, L) direct information scores."""
        if self._di_scores is None:
            self._calculate_ecs()
        return self._di_scores

    def to_independent_model(self):
        """Single-site model: h = log f~, J = 0."""
        independent = deepcopy(self)
        independent.h_i = np.log(self.regularized_f_i)
        independent.J_ij.fill(0)
        independent._reset_precomputed()
        return independent

    def to_raw_ec_file(self, couplings_file):
        """Write the mean-field raw EC file: `i A_i j A_j mi_raw mi_apc di
        cn` per pair (i < j), 6 decimals."""
        with open(couplings_file, "w") as f:
            for i, j in zip(*np.triu_indices(self.L, k=1)):
                f.write(
                    "{} {} {} {} {:.6f} {:.6f} {:.6f} {:.6f}\n".format(
                        self.index_list[i], self.target_seq[i],
                        self.index_list[j], self.target_seq[j],
                        self.mi_scores_raw[i, j], self.mi_scores_apc[i, j],
                        self.di_scores[i, j], self.cn_scores[i, j]))

    def transform_from_plmc_model(self):
        """Fix up a model read from a plmc_v2 file (called by the codec on
        lambda_h < 0): decode the pseudo-count, restore the f_ij diagonal
        and regularize the frequencies."""
        self._decode_unused_fields()
        # each (i, i) block becomes diag(f_i[i])
        sites = np.arange(self.L)
        self.f_ij[sites, sites] = (
            self.f_i[:, :, None] * np.identity(self.num_symbols))
        self.regularize_f_i()
        self.regularize_f_ij()
        self._di_scores = None

    def _encode_unused_fields(self):
        """The pseudo-count as -lambda_h and placeholders for the
        plmc-only fields, for serialization."""
        for plmc_only in ("lambda_J", "lambda_group", "num_iter"):
            setattr(self, plmc_only, _PLACEHOLDER)
        self.lambda_h = -self.pseudo_count

    def _decode_unused_fields(self, save_pseudo_count=True):
        """Null the plmc-only fields; optionally recover the pseudo-count
        from lambda_h."""
        if save_pseudo_count:
            self.pseudo_count = -self.lambda_h
        for plmc_only in ("lambda_J", "lambda_group", "num_iter",
                          "lambda_h"):
            setattr(self, plmc_only, None)

    def to_file(self, out_file, precision="float32", file_format="plmc_v2"):
        """Write in plmc_v2 format (plmc_v1 cannot hold a mean-field
        model)."""
        if file_format == "plmc_v1":
            raise ValueError(
                "Illegal file format: plmc_v1. Valid option: plmc_v2.")
        self._encode_unused_fields()
        try:
            super().to_file(out_file, precision=precision,
                            file_format=file_format)
        finally:
            self._decode_unused_fields()
