"""Inputs and a float64 reference of the bf16 block epilogue
(evcouplings_torch/kernels/block_epilogue.py, K6), for the CPU tests and
the card's (torch and numpy only: the machine with the card has no JAX).

epilogue_f64 evaluates K6's formula in float64 from the same bf16 logits,
codes and float32 weights; as_k6 puts that reference where ops/plm.py
launches K6, so that a CPU test can run the fused route's plumbing.
"""

import numpy as np
import torch

from evcouplings_torch.kernels.block_epilogue import SOFTMAX_SHIFT_FLOOR


def epilogue_problem(seed, B, L, q, scale=2.0):
    """(logits (B, L q) bf16, codes (B, L) int8, weights (B,) float32):
    random logits; gaps (-1) in a few sites of every 5th row; row 1 all
    gaps with a nonzero weight; the last 3 rows padding (all gaps, weight
    0); in row 2 one site pushed 120 nats below the row's max, past the
    clamp at SOFTMAX_SHIFT_FLOOR."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L * q)) * scale
    if B > 2 and L > 1:
        x[2, :q] -= 120.0
    codes = rng.integers(0, q, size=(B, L))
    codes[::5, : max(1, L // 3)] = -1
    w = rng.uniform(0.2, 1.5, size=B)
    if B > 1:
        codes[1] = -1
    if B > 6:
        codes[-3:] = -1
        w[-3:] = 0.0
    return (torch.as_tensor(x, dtype=torch.float32).to(torch.bfloat16),
            torch.as_tensor(codes.astype(np.int8)),
            torch.as_tensor(w, dtype=torch.float32))


def epilogue_f64(logits, codes, weights, q):
    """K6's formula in float64: (residual (B, L q), terms (B,)), numpy,
    with terms[s] = w_s sum_r m_r (x_obs - rowmax - log Z_r)."""
    x = logits.detach().cpu().double().numpy()
    c = codes.detach().cpu().numpy().astype(np.int64)
    w = weights.detach().cpu().double().numpy()
    B, L = c.shape
    rowmax = x.max(axis=1, keepdims=True)
    e = np.exp(np.maximum(x - rowmax, SOFTMAX_SHIFT_FLOOR)).reshape(B, L, q)
    Z = e.sum(axis=2)
    m = c >= 0
    oh = (np.arange(q)[None, None, :] == c[:, :, None]).astype(np.float64)
    x_obs = (x.reshape(B, L, q) * oh).sum(axis=2)
    terms = w * np.where(m, x_obs - rowmax - np.log(Z), 0.0).sum(axis=1)
    r = w[:, None, None] * (e * np.where(m, 1.0 / Z, 0.0)[:, :, None] - oh)
    return r.reshape(B, L * q), terms


def as_k6(logits, codes, weights, q, r_out, terms_out):
    """block_epilogue's contract by the float64 reference: the residual
    rounded once into r_out's dtype, the terms into terms_out's."""
    r, terms = epilogue_f64(logits, codes, weights, q)
    r_out.copy_(torch.as_tensor(r).to(r_out.dtype))
    terms_out.copy_(torch.as_tensor(terms).to(terms_out.dtype))


def bf16_ulp(x):
    """One bf16 ulp at |x| (float64 numpy), the smallest normal's below
    it."""
    a = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)
