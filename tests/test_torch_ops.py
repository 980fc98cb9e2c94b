"""Encodings, frequencies, gauge, scores and Hamiltonians of the PyTorch
port against the JAX package, in float64 unless a test says otherwise.

Tolerance 1e-12 relative (1e-12 absolute) for float64: the same
formulas, summed in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evcouplings_tpu.ops import encode as je
from evcouplings_tpu.ops import frequencies as jf
from evcouplings_tpu.ops import gauge as jg
from evcouplings_tpu.ops import hamiltonian as jh
from evcouplings_tpu.ops import scores as js
from evcouplings_torch.ops import encode as te
from evcouplings_torch.ops import frequencies as tf
from evcouplings_torch.ops import gauge as tg
from evcouplings_torch.ops import hamiltonian as th
from evcouplings_torch.ops import scores as ts

F64 = dict(rtol=1e-12, atol=1e-12)


def _msa(seed=0, n=60, L=9, q=5):
    rng = np.random.default_rng(seed)
    m = rng.integers(0, q, size=(n, L))
    m[3] = m[1]
    return m, rng.random(n) + 0.1


def _couplings(seed=1, L=7, q=4):
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(L, L, q, q))
    J = 0.5 * (J + J.transpose(1, 0, 3, 2))
    J[np.arange(L), np.arange(L)] = 0.0
    return J, rng.normal(size=(L, q))


def test_one_hot_of_minus_one_is_zero():
    codes = np.array([[0, 2, -1], [-1, 1, 3]])
    got = te.one_hot(torch.as_tensor(codes), 4).numpy()
    want = np.asarray(je.one_hot(jnp.asarray(codes), 4))
    np.testing.assert_array_equal(got, want)
    assert got[0, 2].sum() == 0 and got[1, 0].sum() == 0


def test_flatten_unflatten_and_pad_match_jax():
    J, _ = _couplings()
    L, q = J.shape[0], J.shape[2]
    flat = te.flatten_J(torch.as_tensor(J)).numpy()
    np.testing.assert_array_equal(flat, np.asarray(je.flatten_J(J)))
    np.testing.assert_array_equal(
        te.unflatten_J(torch.as_tensor(flat), L, q),
        je.unflatten_J(flat, L, q))
    a = np.arange(14).reshape(7, 2)
    for mult in (4, 7):
        g, n = te.pad_rows(a, mult)
        w, nw = je.pad_rows(a, mult)
        np.testing.assert_array_equal(g, w)
        assert n == nw
    d = te.device_codes(a, device="cpu")
    assert d.dtype == torch.int8 and d.is_contiguous()


def test_frequencies_match_jax_in_f64():
    m, w = _msa()
    q = 5
    fi = tf.frequencies(m, w, q, dtype=torch.float64, device="cpu")
    fi_j = jf.frequencies(m, w, q, dtype=jnp.float64)
    np.testing.assert_allclose(fi, fi_j, **F64)
    fij = tf.pair_frequencies(m, w, q, fi, dtype=torch.float64,
                              device="cpu")
    fij_j = jf.pair_frequencies(m, w, q, fi_j, dtype=jnp.float64)
    np.testing.assert_allclose(fij, fij_j, **F64)
    # diagonal blocks carry f_i on their diagonal
    L = m.shape[1]
    np.testing.assert_allclose(
        fij[np.arange(L), np.arange(L)][:, np.arange(q), np.arange(q)], fi)


def test_gauge_matches_jax():
    J, _ = _couplings()
    np.testing.assert_allclose(tg.zero_sum_gauge(J), jg.zero_sum_gauge(J),
                               **F64)
    np.testing.assert_allclose(
        tg.zero_sum_gauge_device(torch.as_tensor(J)).numpy(),
        np.asarray(jg.zero_sum_gauge_device(jnp.asarray(J))), **F64)


def test_scores_match_jax():
    J, _ = _couplings()
    m, w = _msa(L=7, q=4)
    fi = jf.frequencies(m, w, 4, dtype=jnp.float64)
    fij = jf.pair_frequencies(m, w, 4, fi, dtype=jnp.float64)
    for name in ("fn_scores", "cn_scores"):
        np.testing.assert_allclose(getattr(ts, name)(J),
                                   getattr(js, name)(J), **F64)
    np.testing.assert_allclose(ts.mi_scores(fij, fi),
                               js.mi_scores(fij, fi), **F64)
    for got, want in zip(ts.all_scores(J, fij, fi),
                         js.all_scores(J, fij, fi)):
        np.testing.assert_allclose(got, want, **F64)
    fn = js.fn_scores(J)
    np.testing.assert_allclose(ts.apc(fn), js.apc(fn), **F64)
    with pytest.raises(ValueError):
        ts.apc(np.zeros((3, 4)))


def test_device_scores_match_jax():
    J, _ = _couplings()
    m, w = _msa(L=7, q=4)
    fi = jf.frequencies(m, w, 4, dtype=jnp.float64)
    fij = jf.pair_frequencies(m, w, 4, fi, dtype=jnp.float64)
    fn, cn = ts.fn_cn_scores_device(torch.as_tensor(J))
    fn_j, cn_j = js.fn_cn_scores_device(jnp.asarray(J))
    np.testing.assert_allclose(fn.numpy(), np.asarray(fn_j), **F64)
    np.testing.assert_allclose(cn.numpy(), np.asarray(cn_j), **F64)
    np.testing.assert_allclose(
        ts.mi_scores_device(torch.as_tensor(fij),
                            torch.as_tensor(fi)).numpy(),
        np.asarray(js.mi_scores_device(jnp.asarray(fij), jnp.asarray(fi))),
        **F64)
    np.testing.assert_allclose(
        ts.apc_device(torch.as_tensor(fn.numpy())).numpy(),
        np.asarray(js.apc_device(jnp.asarray(fn.numpy()))), **F64)


def test_mi_apc_from_codes_matches_jax():
    # both compute in float32 after exact integer reweighting: 1e-5
    m, _ = _msa(seed=4, n=120, L=12, q=6)
    got = ts.mi_apc_from_codes(m, 0.8, device="cpu")
    want = js.mi_apc_from_codes(m, 0.8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_hamiltonians_match_jax():
    J, h = _couplings()
    L, q = h.shape
    rng = np.random.default_rng(2)
    seqs = rng.integers(0, q, size=(25, L))
    target = seqs[0]
    np.testing.assert_allclose(th.hamiltonians(seqs, J, h),
                               jh.hamiltonians(seqs, J, h), **F64)
    np.testing.assert_allclose(
        th.hamiltonians_device(seqs, J, h, dtype=torch.float64,
                               device="cpu"),
        jh.hamiltonians_device(seqs, J, h, dtype=jnp.float64), **F64)
    smm = th.single_mutant_hamiltonians(target, J, h)
    np.testing.assert_allclose(
        smm, jh.single_mutant_hamiltonians(target, J, h), **F64)
    np.testing.assert_allclose(
        th.double_mutant_matrix(smm[:, :, 0], J, target),
        jh.double_mutant_matrix(smm[:, :, 0], J, target), **F64)
    pos, subs = np.array([1, 4, 5]), np.array([2, 0, 3])
    np.testing.assert_allclose(
        th.delta_hamiltonian(pos, subs, target, J, h),
        jh.delta_hamiltonian(pos, subs, target, J, h), **F64)
