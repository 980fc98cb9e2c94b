"""
Weighted single-site and pairwise symbol frequencies (port of
evcouplings_tpu/ops/frequencies.py).

f_i is a weighted one-hot reduction over sequences; f_ij is the Gram
matrix of the weighted one-hot MSA,

    f_ij[i,j,a,b] = sum_n w_n onehot[n,i,a] onehot[n,j,b]

i.e. one (Lq, N) @ (N, Lq) matrix product, blocked over N so the one-hot
never exceeds a fixed working set. Sums run in `dtype` (float32 by
default; pass torch.float64 for bit-level parity work). Results come
back as float64 numpy arrays, the form the model artifacts store.
"""

import numpy as np
import torch

from evcouplings_torch._device import matmul_precision
from evcouplings_torch.ops.encode import one_hot
from evcouplings_torch.ops.weights import _as_tensor

# rows of the one-hot per block
_BLOCK = 4096


def _weighted_sums(matrix_mapped, seq_weights, num_symbols, dtype, device,
                   pairs):
    codes = _as_tensor(matrix_mapped, device)
    n, L = codes.shape
    lq = L * num_symbols
    w = torch.as_tensor(
        np.asarray(seq_weights, dtype=np.float64), device=codes.device
    ).to(dtype)
    acc = torch.zeros((lq, lq) if pairs else (lq,), dtype=dtype,
                      device=codes.device)
    # IEEE products whatever the caller's TF32 setting (the JAX package
    # pins these to Precision.HIGHEST)
    with matmul_precision("highest"):
        for start in range(0, n, _BLOCK):
            oh = one_hot(codes[start:start + _BLOCK], num_symbols,
                         dtype=dtype).reshape(-1, lq)
            wb = w[start:start + _BLOCK]
            if pairs:
                acc += (oh * wb[:, None]).T @ oh
            else:
                acc += wb @ oh
    return acc.cpu().double().numpy()


def frequencies(matrix_mapped, seq_weights, num_symbols,
                dtype=torch.float32, device=None):
    """Weighted relative single-site frequencies, (L x num_symbols)
    float64 numpy, normalized by the sum of weights.

    A tensor input stays on its device; anything else goes to `device`
    (None: the CUDA device).
    """
    L = np.shape(matrix_mapped)[1]
    seq_weights = np.asarray(seq_weights, dtype=np.float64)
    fi = _weighted_sums(matrix_mapped, seq_weights, num_symbols, dtype,
                        device, pairs=False)
    return fi.reshape(L, num_symbols) / seq_weights.sum()


def pair_frequencies(matrix_mapped, seq_weights, num_symbols, fi,
                     dtype=torch.float32, device=None):
    """Weighted relative pairwise frequencies, (L x L x q x q) float64
    numpy. The diagonal blocks are f_ij[i,i,a,b] = f_i[i,a] * delta_ab."""
    L = np.shape(matrix_mapped)[1]
    q = num_symbols
    seq_weights = np.asarray(seq_weights, dtype=np.float64)
    fij = _weighted_sums(matrix_mapped, seq_weights, q, dtype, device,
                         pairs=True)
    fij = fij.reshape(L, q, L, q).transpose(0, 2, 1, 3) / seq_weights.sum()

    idx = np.arange(L)
    diag = np.zeros((L, q, q))
    diag[:, np.arange(q), np.arange(q)] = np.asarray(fi)
    fij[idx, idx] = diag
    return fij
