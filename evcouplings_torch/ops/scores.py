"""
Evolutionary-coupling scores: Frobenius norm (FN), APC-corrected norm
(CN), mutual information (raw/APC). Port of evcouplings_tpu/ops/scores.py.

FN/CN follow Ekeberg et al., Phys Rev E, 2013; APC follows Dunn et al.,
Bioinformatics, 2008. The numpy functions are the float64 host path the
model artifacts use; the *_device functions compute the same on tensors.
"""

import numpy as np
import torch

from evcouplings_torch._device import matmul_precision
from evcouplings_torch.ops.encode import one_hot
from evcouplings_torch.ops.gauge import zero_sum_gauge, zero_sum_gauge_device


def apc(matrix):
    """Average product correction with zeroed diagonal; column means and
    the total mean are rescaled by L / (L - 1)."""
    matrix = np.asarray(matrix)
    L = matrix.shape[0]
    if L != matrix.shape[1]:
        raise ValueError(
            "Input matrix is not symmetric: {}".format(matrix.shape))

    col_means = matrix.mean(axis=0) * L / (L - 1)
    matrix_mean = matrix.mean() * L / (L - 1)

    correction = np.outer(col_means, col_means) / matrix_mean
    corrected = matrix - correction
    corrected[np.diag_indices(L)] = 0
    return corrected


def fn_scores(J_ij):
    """Frobenius norms of the zero-sum-gauge couplings, (L, L), zero diag."""
    J0 = zero_sum_gauge(J_ij)
    return np.sqrt(np.sum(J0 ** 2, axis=(2, 3)))


def cn_scores(J_ij):
    """APC-corrected Frobenius norm scores."""
    return apc(fn_scores(J_ij))


def mi_scores(f_ij, f_i):
    """Mutual information per pair, (L, L): sum over f_ij > 0 of
    f_ij log(f_ij / (f_i(a) f_j(b))), diagonal zeroed."""
    f_ij = np.asarray(f_ij)
    f_i = np.asarray(f_i)
    L = f_i.shape[0]

    m = f_i[:, None, :, None] * f_i[None, :, None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(f_ij > 0, f_ij / np.where(m > 0, m, 1.0), 1.0)
        terms = np.where(f_ij > 0, f_ij * np.log(ratio), 0.0)
    mi = terms.sum(axis=(2, 3))
    mi[np.diag_indices(L)] = 0.0
    return mi


def all_scores(J_ij, f_ij, f_i):
    """(fn, cn, mi_raw, mi_apc) with a single gauge pass."""
    fn = fn_scores(J_ij)
    cn = apc(fn)
    mi_raw = mi_scores(f_ij, f_i)
    mi_apc = apc(mi_raw)
    return fn, cn, mi_raw, mi_apc


# ---------------------------------------------------------------------------
# tensor path
# ---------------------------------------------------------------------------

def _zero_diag(matrix):
    L = matrix.shape[0]
    eye = torch.eye(L, dtype=torch.bool, device=matrix.device)
    return torch.where(eye, torch.zeros((), dtype=matrix.dtype,
                                        device=matrix.device), matrix)


def apc_device(matrix):
    """apc on an (L, L) tensor."""
    L = matrix.shape[0]
    col_means = matrix.mean(dim=0) * L / (L - 1)
    matrix_mean = matrix.mean() * L / (L - 1)
    return _zero_diag(matrix - torch.outer(col_means, col_means)
                      / matrix_mean)


def fn_cn_scores_device(J_ij):
    """(FN, CN) scores from an (L, L, q, q) coupling tensor."""
    J0 = zero_sum_gauge_device(J_ij)
    fn = torch.sqrt(torch.sum(J0 ** 2, dim=(2, 3)))
    return fn, apc_device(fn)


def mi_scores_device(f_ij, f_i):
    """mi_scores on tensors (terms only where f_ij > 0, diagonal zeroed)."""
    m = f_i[:, None, :, None] * f_i[None, :, None, :]
    live = f_ij > 0
    one = torch.ones((), dtype=f_ij.dtype, device=f_ij.device)
    ratio = torch.where(live, f_ij, one) / torch.where(m > 0, m, one)
    mi = torch.sum(torch.where(live, f_ij * torch.log(ratio), 0 * one),
                   dim=(2, 3))
    return _zero_diag(mi)


def mi_apc_from_codes(matrix_mapped, identity_threshold, num_symbols=None,
                      device=None):
    """MI + APC coupling scores straight from an integer-coded MSA:
    reweighting at identity_threshold (through num_cluster_members, so
    K1 on a CUDA device), weighted f_i / f_ij in float32, MI, APC.

    Returns (mi_raw, mi_apc) as float64 numpy.
    """
    from evcouplings_torch.ops.weights import _as_tensor, num_cluster_members

    codes = _as_tensor(matrix_mapped, device)
    n, L = codes.shape
    if num_symbols is None:
        num_symbols = int(codes.max()) + 1
    q = num_symbols
    lq = L * q

    counts = num_cluster_members(codes, identity_threshold)
    w = 1.0 / torch.clamp(counts, min=1.0).to(torch.float32)

    oh = one_hot(codes, q, dtype=torch.float32).reshape(n, lq)
    w_sum = w.sum()
    # IEEE products whatever the caller's TF32 setting (the JAX package
    # pins these to Precision.HIGHEST)
    with matmul_precision("highest"):
        fi = (w @ oh).reshape(L, q) / w_sum
        fij = ((oh * w[:, None]).T @ oh).reshape(L, q, L, q).permute(
            0, 2, 1, 3) / w_sum
    diag = fi[:, :, None] * torch.eye(q, dtype=fi.dtype, device=fi.device)
    eye = torch.eye(L, dtype=torch.bool, device=fi.device)[:, :, None, None]
    fij = torch.where(eye, diag[:, None], fij)

    mi_raw = mi_scores_device(fij, fi)
    mi_apc = apc_device(mi_raw)
    return (mi_raw.cpu().double().numpy(), mi_apc.cpu().double().numpy())
