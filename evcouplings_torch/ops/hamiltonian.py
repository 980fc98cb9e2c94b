"""
Potts-model statistical energies (Hamiltonians) and mutation-effect
deltas (port of evcouplings_tpu/ops/hamiltonian.py).

- numpy host path (float64): the arithmetic CouplingsModel uses;
  vectorized gathers over the (L, L, q, q) coupling tensor.
- tensor path (`hamiltonians_device`): the batch Hamiltonian as the same
  (N, Lq) @ (Lq, Lq) product the PLM fit uses for its logits.

Convention: J has zero diagonal blocks (J[i,i] == 0) and is symmetric,
J[j,i,b,a] == J[i,j,a,b], as produced by the plmc_v2 codec.
"""

import numpy as np
import torch

from evcouplings_torch._device import matmul_precision, resolve_device
from evcouplings_torch.ops.encode import flatten_J, one_hot

# component order in all *_full outputs
FULL, COUPLINGS, FIELDS = 0, 1, 2
NUM_COMPONENTS = 3


def hamiltonians(sequences, J_ij, h_i):
    """H = sum_i h_i(A_i) + sum_{i<j} J_ij(A_i, A_j) per sequence.

    sequences : (N, L) int array
    Returns (N, 3): total, couplings sub-sum, fields sub-sum.
    """
    sequences = np.asarray(sequences)
    N, L = sequences.shape

    ii, jj = np.triu_indices(L, k=1)
    H = np.empty((N, NUM_COMPONENTS))

    # chunk over N: the coupling gather materializes three
    # (chunk, L(L-1)/2) temporaries; bound them to ~64 MB each
    n_pairs = max(1, len(ii))
    chunk = max(1, min(N, (1 << 23) // n_pairs))
    for start in range(0, N, chunk):
        seq_c = sequences[start:start + chunk]
        hi_sum = h_i[np.arange(L)[None, :], seq_c].sum(axis=1)
        Jij_sum = J_ij[
            ii[None, :], jj[None, :], seq_c[:, ii], seq_c[:, jj]
        ].sum(axis=1)

        sl = slice(start, start + len(seq_c))
        H[sl, FULL] = Jij_sum + hi_sum
        H[sl, COUPLINGS] = Jij_sum
        H[sl, FIELDS] = hi_sum
    return H


def _coupling_field(J_ij, target_seq):
    """Jsel[i, a] = sum_{j != i} J[i, j, a, s_j] (uses zero diagonal)."""
    L = J_ij.shape[0]
    gathered = J_ij[
        np.arange(L)[:, None],
        np.arange(L)[None, :],
        :,
        np.asarray(target_seq)[None, :],
    ]
    return gathered.sum(axis=1)


def single_mutant_hamiltonians(target_seq, J_ij, h_i):
    """Delta Hamiltonians for all single substitutions, (L, q, 3)."""
    target_seq = np.asarray(target_seq)
    L, q = h_i.shape

    Jsel = _coupling_field(J_ij, target_seq)
    h_wt = np.take_along_axis(h_i, target_seq[:, None], axis=1)
    J_wt = np.take_along_axis(Jsel, target_seq[:, None], axis=1)

    delta_h = h_i - h_wt
    delta_J = Jsel - J_wt

    H = np.empty((L, q, NUM_COMPONENTS))
    H[:, :, FULL] = delta_J + delta_h
    H[:, :, COUPLINGS] = delta_J
    H[:, :, FIELDS] = delta_h
    return H


def delta_hamiltonian(pos, subs, target_seq, J_ij, h_i,
                      coupling_field=None):
    """Delta Hamiltonian for a multi-substitution, returns (3,).

    Single-site deltas against the wild-type background plus pairwise
    corrections among the substituted positions. coupling_field:
    optional precomputed _coupling_field(J_ij, target_seq).
    """
    pos = np.asarray(pos)
    subs = np.asarray(subs)
    target_seq = np.asarray(target_seq)
    M = pos.shape[0]

    delta_hi = (h_i[pos, subs] - h_i[pos, target_seq[pos]]).sum()

    Jsel = (
        coupling_field if coupling_field is not None
        else _coupling_field(J_ij, target_seq)
    )
    delta_Jij = (Jsel[pos, subs] - Jsel[pos, target_seq[pos]]).sum()

    if M > 1:
        im, jn = np.triu_indices(M, k=1)
        i, j = pos[im], pos[jn]
        a, b = subs[im], subs[jn]
        si, sj = target_seq[i], target_seq[j]
        delta_Jij += (
            J_ij[i, j, a, b]
            - J_ij[i, j, a, sj]
            - J_ij[i, j, si, b]
            + J_ij[i, j, si, sj]
        ).sum()

    return np.array([delta_Jij + delta_hi, delta_Jij, delta_hi])


def double_mutant_matrix(single_mut_mat, J_ij, target_seq):
    """Delta Hamiltonians for all double mutants, (L, L, q, q), zero
    diagonal:

    dmm[i,j,a,b] = smm[i,a] + smm[j,b]
                   + J[i,j,a,b] - J[i,j,a,s_j] - J[i,j,s_i,b] + J[i,j,s_i,s_j]
    """
    target_seq = np.asarray(target_seq)
    L, q = single_mut_mat.shape

    s_i = target_seq[:, None, None, None]
    s_j = target_seq[None, :, None, None]
    li = np.arange(L)[:, None, None, None]
    lj = np.arange(L)[None, :, None, None]
    a = np.arange(q)[None, None, :, None]
    b = np.arange(q)[None, None, None, :]

    dmm = np.broadcast_to(
        single_mut_mat[:, None, :, None], J_ij.shape
    ).copy()
    dmm += single_mut_mat[None, :, None, :]
    dmm += J_ij
    dmm -= J_ij[li, lj, a, s_j]
    dmm -= J_ij[li, lj, s_i, b]
    dmm += J_ij[li, lj, s_i, s_j]
    dmm[np.arange(L), np.arange(L)] = 0.0
    return dmm


def hamiltonians_device(sequences, J_ij, h_i, dtype=torch.float32,
                        device=None):
    """Batch Hamiltonians as (N, Lq) @ (Lq, Lq) products on `device`
    (None: the CUDA device); same contract as `hamiltonians`, float64
    numpy out."""
    sequences = np.asarray(sequences)
    L, q = np.shape(h_i)
    if sequences.shape[1] != L:
        raise ValueError(
            "sequences have {} columns, model expects L={}".format(
                sequences.shape[1], L))
    if sequences.size and (sequences.min() < 0 or sequences.max() >= q):
        raise ValueError(
            "sequence codes must lie in [0, {}) for the device path "
            "(got range [{}, {}])".format(
                q, sequences.min(), sequences.max()))
    device = resolve_device(device)

    # the 0.5 * quadratic form would count diagonal blocks the host
    # path's strict triangle never sees: enforce the zero diagonal
    J_in = np.array(J_ij, copy=True)
    J_in[np.arange(L), np.arange(L)] = 0.0
    J_flat = flatten_J(torch.as_tensor(J_in)).to(device=device, dtype=dtype)
    h_flat = torch.as_tensor(np.asarray(h_i)).to(
        device=device, dtype=dtype).reshape(-1)
    codes = torch.as_tensor(sequences.astype(np.int64), device=device)

    out = []
    for start in range(0, codes.shape[0], 4096):
        oh = one_hot(codes[start:start + 4096], q, dtype=dtype).reshape(
            -1, L * q)
        # IEEE products whatever the caller's TF32 setting (the JAX
        # package pins this one to Precision.HIGHEST)
        with matmul_precision("highest"):
            j_sum = 0.5 * torch.sum(oh * (oh @ J_flat.T), dim=1)
        h_sum = torch.sum(oh * h_flat[None, :], dim=1)
        out.append(torch.stack([j_sum + h_sum, j_sum, h_sum], dim=1))
    if not out:
        return np.empty((0, NUM_COMPONENTS))
    return torch.cat(out).cpu().double().numpy()
