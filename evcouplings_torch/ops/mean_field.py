"""
Mean-field DCA numerics: covariance build, inversion, coupling and field
extraction, direct information (port of evcouplings_tpu/ops/mean_field.py).

Every function is a torch function on an explicit device (None: the CUDA
device; pass "cpu" for the host) and returns float64 tensors. The
covariance inversion is a dense library solve (cuSOLVER on the card):
float64 by default (the JAX package's parity path inverts on the host in
float64; the H100 has float64 tensor cores), float32 as the JAX device
path does. Direct information iterates the two-site fixed point of ALL
L(L-1)/2 pairs at once as batched (P, q, q) x (P, q) products, each pair
frozen at its own convergence sweep, so every pair's result is the one
its own loop would give; the host reads whether any pair is still active
only every _DI_CHECK_EVERY sweeps. On the host, exp and log go through
numpy (_exp, _log), not torch's threaded CPU kernels.
"""

import warnings

import numpy as np
import torch

from evcouplings_torch._device import matmul_precision, resolve_device

F64 = torch.float64

# numerator / denominator floor of the DI logarithm (float64)
_TINY = 1.0e-100

# sweeps between host reads of direct_information's active-pair flags
_DI_CHECK_EVERY = 8


def _t(a, device):
    """a (array or tensor) as a float64 tensor on device."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=F64)
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)


def _exp(x):
    """exp of a float64 tensor on its device. On the host numpy computes
    it: torch's CPU exp and log split a tensor of more than 2048 elements
    over their threads and call MKL's vector math there, and a process's
    first such call gave one thread's block of the result at ~1e-8
    relative error on the host CPU of an NVIDIA H100 80GB HBM3 system
    (ROADMAP C14)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.exp(x.numpy()))
    return torch.exp(x)


def _log(x):
    """log of a float64 tensor on its device; on the host through numpy,
    as _exp."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.log(x.numpy()))
    return torch.log(x)


def compute_covariance_matrix(f_i, f_ij, device=None):
    """Excess pair correlations, (L(q-1), L(q-1)) float64:

        C[(i,a),(j,b)] = f_ij[i,j,a,b] - f_i[i,a] f_i[j,b]

    with the last symbol dropped (its covariances are fixed by the others,
    which makes C invertible); index i*(q-1)+a."""
    device = resolve_device(device)
    f_i, f_ij = _t(f_i, device), _t(f_ij, device)
    L, q = f_i.shape
    fm = f_i[:, :q - 1]
    C = (f_ij[:, :, :q - 1, :q - 1]
         - fm[:, None, :, None] * fm[None, :, None, :])
    return C.permute(0, 2, 1, 3).reshape(L * (q - 1), L * (q - 1))


def invert_covariance(C, dtype=F64):
    """-inv(C) on C's device, computed in `dtype` (float64: the parity
    default; float32: the JAX device path), returned as float64."""
    return -torch.linalg.inv(C.to(dtype)).to(F64)


def invert_covariance_device(C):
    """-inv(C) in float32 (the JAX package's device inversion)."""
    return invert_covariance(C, torch.float32)


def invert_covariance_sharded(C, mesh, axis="data"):
    """-inv(C) in float64 with the solves split over the ranks of a mesh
    axis: C is replicated (every rank passes it), each rank LU-factorizes
    its copy once (cuSOLVER on the card, through torch.linalg) and solves
    only its own block of identity columns, built on its device; the
    blocks come back by one all-reduce of a zeroed (D, D_pad) float64
    buffer (exact: each entry has one nonzero term), D_pad = D padded to
    a multiple of the axis size. The factorization is not split, so the
    gain is the solves' time, not memory. Returns (D, D) float64 on the
    mesh's device, equal on every rank."""
    from evcouplings_torch.parallel import all_reduce

    C = _t(C, mesh.device)
    D = C.shape[0]
    n = mesh.shape[axis]
    blk = -(-D // n)
    col0 = mesh.index(axis) * blk
    LU, pivots = torch.linalg.lu_factor(C)
    rows = torch.arange(D, device=C.device)[:, None]
    cols = torch.arange(col0, col0 + blk, device=C.device)[None, :]
    X = torch.zeros((D, blk * n), dtype=F64, device=C.device)
    X[:, col0:col0 + blk] = -torch.linalg.lu_solve(
        LU, pivots, (rows == cols).to(F64))
    return all_reduce(X, mesh, axis)[:, :D]


def reshape_invC_to_4d(inv_cov_matrix, L, num_symbols):
    """Un-flatten the (L(q-1))^2 matrix to (L, L, q, q), zero-padding the
    dropped last symbol."""
    q = num_symbols
    inv = torch.as_tensor(inv_cov_matrix).to(F64)
    J = torch.zeros((L, L, q, q), dtype=F64, device=inv.device)
    J[:, :, :q - 1, :q - 1] = inv.reshape(L, q - 1, L, q - 1).permute(
        0, 2, 1, 3)
    return J


def fields_from_couplings(J_ij, f_i, device=None):
    """Single-site fields of the mean-field model, (L, q):

        h_i = log(f_i / f_i[:, -1]) - sum_{j != i} J_ij[i, j] @ f_i[j]
    """
    device = resolve_device(device)
    J_ij, f_i = _t(J_ij, device), _t(f_i, device)
    L = f_i.shape[0]
    log_fi = _log(f_i / f_i[:, -1][:, None])
    idx = torch.arange(L, device=device)
    # float64 (no TF32 route), pinned as the JAX package pins its products
    with matmul_precision("highest"):
        total = torch.einsum("ijab,jb->ia", J_ij, f_i)
        diag = torch.einsum("iab,ib->ia", J_ij[idx, idx], f_i)
    return log_fi - (total - diag)


def tilde_fields(J_ij, f_i, f_j, epsilon=1e-4, device=None):
    """h-tilde fields of the two-site model of one pair, iterated to the
    fixed point

        h_i <- normalize(f_i / (h_j @ W^T)),  h_j <- normalize(f_j / (h_i @ W))

    until max|update| <= epsilon. J_ij receives the EXPONENTIATED pair
    couplings W = exp(J[i, j]) (q, q), as the JAX package's kernel does.
    Returns ((1, q), (1, q)) tensors."""
    device = resolve_device(device)
    W = _t(J_ij, device)
    f_i = _t(f_i, device).reshape(1, -1)
    f_j = _t(f_j, device).reshape(1, -1)
    q = f_i.shape[1]
    h_i = torch.full((1, q), 1.0 / q, dtype=F64, device=device)
    h_j = torch.full((1, q), 1.0 / q, dtype=F64, device=device)
    diff = float("inf")
    sweeps = 0
    max_sweeps = 10000
    # float64 (no TF32 route), pinned as the JAX package pins its products
    with matmul_precision("highest"):
        while diff > epsilon and sweeps < max_sweeps:
            h_i_new = f_i / (h_j @ W.T)
            h_i_new = h_i_new / h_i_new.sum()
            h_j_new = f_j / (h_i @ W)
            h_j_new = h_j_new / h_j_new.sum()
            diff = max(float((h_i_new - h_i).abs().max()),
                       float((h_j_new - h_j).abs().max()))
            h_i, h_j = h_i_new, h_j_new
            sweeps += 1
    if diff > epsilon:
        warnings.warn(
            "tilde_fields did not reach the epsilon={} fixed-point "
            "criterion within {} sweeps (last update {})".format(
                epsilon, max_sweeps, diff), RuntimeWarning)
    return h_i, h_j


def direct_information(J_ij, f_i, epsilon=1e-4, max_sweeps=10000,
                       device=None):
    """Direct information matrix, (L, L) float64 tensor, symmetric, zero
    diagonal.

    All pairs iterate their two-site fixed point at once; a pair freezes
    at its own convergence sweep (converged pairs are left untouched), so
    testing for remaining active pairs only every _DI_CHECK_EVERY sweeps
    changes no pair's result. Adds the sweeps run and the host reads of
    the active flags to direct_information.sweeps / .syncs."""
    device = resolve_device(device)
    J_ij, f_i = _t(J_ij, device), _t(f_i, device)
    L, q = f_i.shape
    ii, jj = np.triu_indices(L, k=1)
    di = torch.zeros((L, L), dtype=F64, device=device)
    if len(ii) == 0:
        return di
    ii_t = torch.as_tensor(ii, device=device)
    jj_t = torch.as_tensor(jj, device=device)

    W = _exp(J_ij[ii_t, jj_t])                      # (P, q, q)
    fi, fj = f_i[ii_t], f_i[jj_t]
    h_i = torch.full_like(fi, 1.0 / q)
    h_j = torch.full_like(fj, 1.0 / q)
    active = torch.ones(len(ii), dtype=torch.bool, device=device)

    sweep = 0
    while sweep < max_sweeps:
        # h_j @ W^T and h_i @ W for every pair
        tmp1 = torch.bmm(W, h_j[:, :, None])[:, :, 0]
        tmp2 = torch.bmm(h_i[:, None, :], W)[:, 0, :]
        h_i_new = fi / tmp1
        h_i_new = h_i_new / h_i_new.sum(dim=1, keepdim=True)
        h_j_new = fj / tmp2
        h_j_new = h_j_new / h_j_new.sum(dim=1, keepdim=True)
        diff = torch.maximum((h_i_new - h_i).abs().amax(dim=1),
                             (h_j_new - h_j).abs().amax(dim=1))
        m = active[:, None]
        h_i = torch.where(m, h_i_new, h_i)
        h_j = torch.where(m, h_j_new, h_j)
        active = active & (diff > epsilon)
        sweep += 1
        if sweep % _DI_CHECK_EVERY == 0 or sweep == max_sweeps:
            direct_information.syncs += 1
            if not bool(active.any()):
                break
    direct_information.sweeps += sweep

    if bool(active.any()):
        bad = torch.nonzero(active).flatten().cpu().numpy()
        warnings.warn(
            "direct_information: {} pair(s) did not reach the epsilon={} "
            "fixed-point criterion within {} sweeps (e.g. pair ({}, {})); "
            "their DI values are the last iterate, not the converged "
            "two-site model".format(bad.size, epsilon, max_sweeps,
                                    ii[bad[0]], jj[bad[0]]),
            RuntimeWarning)

    # two-site model distribution and its mutual information against the
    # product of the single-site frequencies
    p = W * h_i[:, :, None] * h_j[:, None, :]
    p = p / p.sum(dim=(1, 2), keepdim=True)
    prod = fi[:, :, None] * fj[:, None, :]
    di_pairs = torch.sum(p * _log((p + _TINY) / (prod + _TINY)),
                         dim=(1, 2))
    _warn_nan_di(di_pairs, ii, jj)
    di[ii_t, jj_t] = di_pairs
    di[jj_t, ii_t] = di_pairs
    return di


direct_information.sweeps = 0
direct_information.syncs = 0


def direct_information_device(J_ij, f_i, epsilon=1e-4, device=None):
    """direct_information under the JAX package's device-variant name and
    signature: the (L, L) matrix as a float64 numpy array."""
    return direct_information(J_ij, f_i, epsilon=epsilon,
                              device=device).cpu().numpy()


def _warn_nan_di(di_pairs, ii, jj):
    """NaN DI pairs (e.g. exp-underflowed coupling rows) freeze as
    'converged' in the sweep loop (NaN > eps is False) and would slip into
    the EC table unnoticed: surface them."""
    bad = np.flatnonzero(np.isnan(np.asarray(
        di_pairs.cpu() if isinstance(di_pairs, torch.Tensor) else di_pairs)))
    if bad.size:
        warnings.warn(
            "direct_information produced NaN for {} pair(s) (e.g. pair "
            "({}, {})): degenerate two-site distributions (underflowed "
            "couplings?)".format(bad.size, ii[bad[0]], jj[bad[0]]),
            RuntimeWarning)
