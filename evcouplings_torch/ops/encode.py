"""
MSA integer/one-hot encodings (port of evcouplings_tpu/ops/encode.py).

The alignment's character matrix is remapped to integer codes on the host;
these helpers move codes onto a device and expand them to one-hot. Code -1
(gap in ignore-gaps mode, row or site padding) expands to an all-zero row:
it contributes neither a conditional term nor context anywhere downstream.
"""

import numpy as np
import torch


def device_codes(matrix_mapped, device, dtype=torch.int8):
    """Move an integer-coded MSA (N x L) onto `device` as int8 (enough for
    q <= 127 symbol alphabets)."""
    if isinstance(matrix_mapped, torch.Tensor):
        return matrix_mapped.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(
        np.ascontiguousarray(matrix_mapped), dtype=dtype, device=device
    )


def one_hot(codes, num_symbols, dtype=torch.float32):
    """One-hot encode integer codes: (...,) -> (..., num_symbols); codes
    outside [0, num_symbols) (e.g. -1) give all-zero rows."""
    codes = codes.long()
    symbols = torch.arange(num_symbols, device=codes.device)
    return (codes.unsqueeze(-1) == symbols).to(dtype)


def pad_rows(array, multiple):
    """Pad axis 0 of a numpy array with zeros up to a multiple of
    `multiple`. Returns (padded_array, original_length)."""
    n = array.shape[0]
    n_pad = (-n) % multiple
    if n_pad == 0:
        return array, n
    pad_width = [(0, n_pad)] + [(0, 0)] * (array.ndim - 1)
    return np.pad(array, pad_width), n


def flatten_J(J_ij):
    """(L, L, q, q) coupling tensor -> flat (Lq, Lq) matrix with
    J_flat[(i, a), (j, b)] = J[i, j, a, b] — the layout in which the
    conditional logits of a one-hot row are one matrix product."""
    J_ij = torch.as_tensor(J_ij)
    L, _, q, _ = J_ij.shape
    return J_ij.permute(0, 2, 1, 3).reshape(L * q, L * q)


def unflatten_J(J_flat, L, q, zero_diag=True):
    """Inverse of flatten_J: (Lq, Lq) -> (L, L, q, q) float64 numpy (an
    owned copy), optionally zeroing the L diagonal q x q self-blocks."""
    if isinstance(J_flat, torch.Tensor):
        J_flat = J_flat.detach().cpu().double().numpy()
    J = np.array(J_flat, dtype=np.float64, copy=True).reshape(
        L, q, L, q
    ).transpose(0, 2, 1, 3)
    if zero_diag:
        J[np.arange(L), np.arange(L)] = 0.0
    return J
