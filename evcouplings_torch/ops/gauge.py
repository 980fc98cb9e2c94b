"""
Zero-sum gauge transform of the coupling tensor (port of
evcouplings_tpu/ops/gauge.py).

For each pair (i, j): J0[i,j,a,b] = J[i,j,a,b] - mean_b J[i,j,a,:]
- mean_a J[i,j,:,b] + mean_ab J[i,j], so every ij-submatrix has zero row
and column sums; the diagonal blocks (i == j) are zero.
"""

import numpy as np
import torch


def zero_sum_gauge(J_ij):
    """Vectorized zero-sum gauge (numpy host path, dtype-preserving)."""
    J_ij = np.asarray(J_ij)
    L = J_ij.shape[0]

    avg_a = J_ij.mean(axis=3, keepdims=True)
    avg_b = J_ij.mean(axis=2, keepdims=True)
    avg_ab = J_ij.mean(axis=(2, 3), keepdims=True)

    J0 = J_ij - avg_a - avg_b + avg_ab
    J0[np.arange(L), np.arange(L)] = 0.0
    return J0


def zero_sum_gauge_device(J_ij):
    """Tensor path: the same transform on an (L, L, q, q) tensor, on its
    device."""
    L = J_ij.shape[0]
    avg_a = J_ij.mean(dim=3, keepdim=True)
    avg_b = J_ij.mean(dim=2, keepdim=True)
    avg_ab = J_ij.mean(dim=(2, 3), keepdim=True)
    J0 = J_ij - avg_a - avg_b + avg_ab
    eye = torch.eye(L, dtype=torch.bool, device=J_ij.device)[:, :, None, None]
    return torch.where(eye, torch.zeros((), dtype=J0.dtype,
                                        device=J0.device), J0)
