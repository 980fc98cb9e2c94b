"""Reweighting: the port's num_cluster_members (K1's plain version on the
CPU) against the JAX package's XLA path and its Pallas kernel in
interpret mode. Counts are integers, so they must agree EXACTLY."""

import numpy as np
import pytest
import torch

from evcouplings_tpu.ops import weights as jw
from evcouplings_tpu.ops.weights_pallas import num_cluster_members_pallas
from evcouplings_torch.ops import weights as tw


def _codes(rng, n, L, q, gaps=False, missing=False):
    m = rng.integers(0, q, size=(n, L))
    m[5] = m[3]
    m[n - 1] = m[0]
    m[n // 2] = m[0]
    if gaps:
        # gap-rich rows (gap code 0 participates in identity)
        m[7:n:9] = np.where(rng.random((len(m[7:n:9]), L)) < 0.6, 0,
                            m[7:n:9])
    if missing:
        # -1 matches nothing, not even another -1
        m[2:n:11, : L // 3] = -1
        m[4] = m[2]
    return m


@pytest.mark.parametrize("n,L,q,theta", [
    (100, 23, 21, 0.8), (300, 150, 21, 0.8), (57, 300, 5, 0.5),
])
def test_matches_jax_and_pallas_exactly(n, L, q, theta):
    m = _codes(np.random.default_rng(17), n, L, q, gaps=True)
    got = tw.num_cluster_members(m, theta, device="cpu")
    assert got.dtype == torch.float64 and got.shape == (n,)
    got = got.numpy()
    assert np.array_equal(got, jw.num_cluster_members(m, theta))
    assert np.array_equal(
        got, num_cluster_members_pallas(m, theta, interpret=True))
    assert got.min() >= 1.0 and got.max() > 1.0


def test_missing_codes_match_nothing():
    m = _codes(np.random.default_rng(3), 120, 30, 21, gaps=True,
               missing=True)
    got = tw.num_cluster_members(m, 0.5, device="cpu").numpy()
    assert np.array_equal(got, jw.num_cluster_members(m, 0.5))


@pytest.mark.parametrize("L,theta", [
    (20, 0.85), (20, 0.8), (40, 0.7), (100, 0.29), (37, 1.0), (13, 0.0),
])
def test_threshold_on_a_k_over_L_boundary(L, theta):
    # theta * L is an integer k (up to binary rounding): rows with
    # exactly k identities must count, rows with k - 1 must not
    k = tw._identity_count_threshold(L, theta)
    assert k == jw._identity_count_threshold(L, theta)
    assert k / L >= theta and (k == 0 or (k - 1) / L < theta)
    base = np.zeros(L, dtype=np.int64)
    rows = [base]
    for ident in (k, k - 1):
        if 0 <= ident <= L:
            r = base.copy()
            r[ident:] = 1
            rows.append(r)
    m = np.stack(rows)
    got = tw.num_cluster_members(m, theta, device="cpu").numpy()
    assert np.array_equal(got, jw.num_cluster_members(m, theta))


def test_int8_product_does_not_wrap():
    # a CPU int8 @ int8 product returns int8 and wraps (100 * 100 -> 16);
    # identity counts above 127 must survive the plain version
    assert int((torch.tensor([[100]], dtype=torch.int8)
                @ torch.tensor([[100]], dtype=torch.int8))[0, 0]) == 16
    n, L = 9, 200
    m = np.tile(np.arange(L) % 21, (n, 1))
    got = tw.num_cluster_members(m, 0.9, device="cpu").numpy()
    assert np.array_equal(got, np.full(n, float(n)))
    assert np.array_equal(got, jw.num_cluster_members(m, 0.9))


def test_identities_to_seq_matches_jax():
    rng = np.random.default_rng(5)
    m = rng.integers(0, 21, size=(50, 40))
    seq = m[0]
    got = tw.identities_to_seq(seq, m, device="cpu").numpy()
    assert np.array_equal(got, jw.identities_to_seq(seq, m))


def test_large_codes_are_refused():
    with pytest.raises(ValueError):
        tw.num_cluster_members(np.full((3, 4), 200), 0.8, device="cpu")
