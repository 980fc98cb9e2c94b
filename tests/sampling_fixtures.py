"""
Small Potts models and exact references for the Gibbs sampler's tests and
chip_smoke.py (numpy only): the Boltzmann distribution by enumeration, and
the zero-temperature chain (every site update an argmax) with the smallest
gap between a site's best and second-best logit along the way.
"""

import itertools

import numpy as np


def tiny_model(seed, L, q, h_scale=0.5, J_scale=0.7):
    """Fields and symmetric couplings with zero diagonal blocks."""
    rng = np.random.default_rng(seed)
    h = rng.normal(scale=h_scale, size=(L, q))
    J = np.zeros((L, L, q, q))
    for i in range(L):
        for j in range(i + 1, L):
            block = rng.normal(scale=J_scale, size=(q, q))
            J[i, j] = block
            J[j, i] = block.T
    return J, h


def potts_logp(codes, J_ij, h_i):
    """Unnormalized log probability of integer sequences."""
    L = h_i.shape[0]
    e = sum(h_i[i, codes[:, i]] for i in range(L))
    for i in range(L):
        for j in range(i + 1, L):
            e = e + J_ij[i, j, codes[:, i], codes[:, j]]
    return e


def boltzmann(J_ij, h_i):
    """The exact distribution over all q^L states (lexicographic order)."""
    L, q = h_i.shape
    states = np.array(list(itertools.product(range(q), repeat=L)))
    logp = potts_logp(states, J_ij, h_i)
    p = np.exp(logp - logp.max())
    return p / p.sum()


def total_variation(codes, p_exact, q):
    """Total variation distance of the sampled states from p_exact."""
    L = codes.shape[1]
    idx = sum(codes[:, i].astype(int) * q ** (L - 1 - i) for i in range(L))
    counts = np.bincount(idx, minlength=q ** L)
    return 0.5 * np.abs(counts / counts.sum() - p_exact).sum()


def argmax_chain(J_ij, h_i, init_codes, n_sweeps):
    """The sampler at zero temperature, in float64: every site takes the
    symbol of its largest conditional logit. Returns (final codes, the
    smallest gap between a site's best and second-best logit over every
    update of every chain)."""
    L, q = h_i.shape
    codes = np.array(init_codes, dtype=np.int64)
    rows = np.arange(len(codes))
    min_gap = np.inf
    for _ in range(n_sweeps):
        for i in range(L):
            logits = h_i[i][None, :] + sum(
                J_ij[i, j][:, codes[:, j]].T for j in range(L) if j != i)
            top2 = np.sort(logits, axis=1)[:, -2:]
            min_gap = min(min_gap, float((top2[:, 1] - top2[:, 0]).min()))
            codes[rows, i] = logits.argmax(axis=1)
    return codes.astype(np.int8), min_gap
