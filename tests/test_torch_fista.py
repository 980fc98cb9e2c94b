"""The port's objective (make_plm_loss) and its FISTA solver for the exact
group-L1 penalty against the JAX package's and against the certified
float64 prox oracle (tests/oracle_plm.py), on the host."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle_plm as oracle
from evcouplings_tpu.couplings.fitter import run_plm as jax_run_plm
from evcouplings_tpu.couplings.pairs import read_raw_ec_file
from evcouplings_tpu.ops import plm as jp
from evcouplings_torch.couplings.fitter import run_plm
from evcouplings_torch.couplings.model import CouplingsModel
from evcouplings_torch.ops import plm as tp

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "golden")


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread (the test runners share the
    host's cores, and thread pools of tiny ops then spin against each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sparse_case():
    """The oracle suite's sparse regime: lambda_group zeroes most pair
    blocks (tests/test_plm_oracle.py)."""
    codes = oracle.synthetic_msa(24, 6, 4, seed=17, n_coupled=2)
    return codes, np.ones(24), 6, 4, 0.01, 0.05, 12.0


def _fista_cfg(max_iter, **kw):
    return tp.PlmConfig(lambda_h=0.01, lambda_J=0.05, lambda_group=12.0,
                        solver="fista", max_iter=max_iter, conv_tol=1e-9,
                        block_size=8, dtype="float64", **kw)


@pytest.mark.parametrize("cfg_kw,symmetric", [
    ({}, False), ({}, True),
    ({"lambda_group": 0.7, "group_mode": "smoothed"}, False),
    ({"lambda_group": 0.7, "group_mode": "smoothed", "lambda_h": 0.3,
      "lambda_J": 2.5}, True),
])
def test_make_plm_loss_matches_jax(cfg_kw, symmetric):
    """Value of the objective in float64, 1e-12 relative, at random
    parameters (asymmetric P unless symmetric) and weights."""
    L, q, n = 5, 4, 24
    rng = np.random.default_rng(11)
    codes = rng.integers(-1, q, size=(n, L)).astype(np.int8)
    w = rng.uniform(0.2, 1.5, size=n)
    P = rng.normal(size=(L * q, L * q))
    if symmetric:
        P = 0.5 * (P + P.T)
    h = rng.normal(size=(L, q))
    cfg = tp.PlmConfig(dtype="float64", block_size=8, **cfg_kw)
    got = tp.make_plm_loss(L, q, cfg, symmetric_params=symmetric)(
        {"J": torch.tensor(P), "h": torch.tensor(h)}, torch.tensor(codes),
        torch.tensor(w))
    want = jp.make_plm_loss(L, q, jp.PlmConfig(**cfg.__dict__),
                            symmetric_params=symmetric)(
        {"J": jnp.asarray(P), "h": jnp.asarray(h)}, jnp.asarray(codes),
        jnp.asarray(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


def test_loss_agrees_with_value_and_grad():
    """The loss and the closed-form value path price the same point
    (float64, 1e-12 relative): FISTA compares the two."""
    L, q, n = 4, 3, 16
    rng = np.random.default_rng(2)
    codes = torch.tensor(rng.integers(0, q, size=(n, L)).astype(np.int8))
    w = torch.tensor(rng.uniform(0.5, 1.0, size=n))
    P = rng.normal(size=(L * q, L * q))
    params = {"J": torch.tensor(0.5 * (P + P.T)),
              "h": torch.tensor(rng.normal(size=(L, q)))}
    cfg = tp.PlmConfig(dtype="float64", block_size=8)
    loss = tp.make_plm_loss(L, q, cfg, symmetric_params=True)
    value, _ = tp.make_plm_value_and_grad(L, q, cfg, symmetric_params=True)(
        params, codes, w)
    np.testing.assert_allclose(float(loss(params, codes, w)), float(value),
                               rtol=1e-12)


def test_smoothed_group_term_at_zero():
    """The smoothed group term adds 0.5 lambda_g sqrt(1e-12) per block at
    J = 0 and nothing to the gradient there (the JAX package's
    test_group_l1_smoothing_is_the_documented_deviation, on the port)."""
    L, q, n = 4, 5, 8
    rng = np.random.default_rng(3)
    codes = torch.tensor(rng.integers(0, q, size=(n, L)).astype(np.int8))
    w = torch.ones(n)
    base = dict(lambda_h=0.0, lambda_J=0.0, dtype="float32", block_size=8)
    loss = tp.make_plm_loss(L, q, tp.PlmConfig(
        lambda_group=1e4, group_mode="smoothed", **base))
    nll = tp.make_plm_loss(L, q, tp.PlmConfig(**base))
    J = torch.zeros((L * q, L * q), requires_grad=True)
    h = torch.zeros((L, q))
    v, v0 = loss({"J": J, "h": h}, codes, w), nll({"J": J, "h": h}, codes, w)
    np.testing.assert_allclose(float((v - v0).detach()),
                               0.5 * 1e4 * 1e-6 * L * L, rtol=1e-3)
    g, = torch.autograd.grad(v, J)
    g0, = torch.autograd.grad(nll({"J": J, "h": h}, codes, w), J)
    assert float((g - g0).abs().max()) == 0.0


def test_fista_matches_certified_prox_oracle():
    """The oracle's exact zero set, h within 5e-6, J within 2e-6 (the JAX
    package's gate, tests/test_plm_oracle.py), after 1000 iterations."""
    codes, w, L, q, lh, lj, lg = _sparse_case()
    ref = oracle.fit_prox(codes, w, q, lambda_h=lh, lambda_J=lj,
                          lambda_group=lg, tol=1e-8, max_iter=3000)
    assert ref["result"]["converged"] and ref["kkt_margin"] > 0.1
    assert 0 < len(ref["zero_pairs"]) < L * (L - 1) // 2
    fit = tp.fit_plm(codes, w, q, _fista_cfg(1000), device="cpu")
    np.testing.assert_allclose(fit.h_i, ref["h"], atol=5e-6)
    np.testing.assert_allclose(fit.J_ij, ref["J"], atol=2e-6)
    bn = np.sqrt((fit.J_ij ** 2).sum(axis=(2, 3)))
    ii, jj = np.triu_indices(L, k=1)
    np.testing.assert_array_equal(np.flatnonzero(bn[ii, jj] == 0.0),
                                  np.sort(ref["zero_pairs"]))


def test_fista_matches_jax_iterate_by_iterate():
    """float64: the objective at each of 80 iterates within 1e-12
    relative of the JAX package's, and the parameters within 1e-10."""
    codes, w, L, q, *_ = _sparse_case()
    cfg = _fista_cfg(80)
    got = tp.fit_plm(codes, w, q, cfg, device="cpu")
    want = jp.fit_plm(codes, w, q, jp.PlmConfig(**cfg.__dict__))
    for key in ("fx", "gnorm", "xnorm"):
        np.testing.assert_allclose(
            [r[key] for r in got.iteration_table],
            [r[key] for r in want.iteration_table], rtol=1e-12, err_msg=key)
    np.testing.assert_allclose(got.J_ij, want.J_ij, atol=1e-10)
    np.testing.assert_allclose(got.h_i, want.h_i, atol=1e-10)
    assert got.final_loss == pytest.approx(want.final_loss, rel=1e-12)


@pytest.mark.parametrize("conv_tol", [1e-5, 1e-6])
def test_fista_matches_jax_at_convergence(conv_tol):
    """float64, run to the gradient-mapping criterion: both packages stop
    converged at the same iteration, parameters within 1e-12 and the
    final objective within 1e-12 relative."""
    codes, w, L, q, *_ = _sparse_case()
    cfg = tp.PlmConfig(lambda_h=0.01, lambda_J=0.05, lambda_group=12.0,
                       solver="fista", max_iter=3000, conv_tol=conv_tol,
                       block_size=8, dtype="float64")
    got = tp.fit_plm(codes, w, q, cfg, device="cpu")
    want = jp.fit_plm(codes, w, q, jp.PlmConfig(**cfg.__dict__))
    assert got.converged and want.converged
    assert got.num_iter == want.num_iter
    np.testing.assert_allclose(got.J_ij, want.J_ij, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.h_i, want.h_i, rtol=0, atol=1e-12)
    assert got.final_loss == pytest.approx(want.final_loss, rel=1e-12)


def test_fista_backtracks_are_counted():
    codes, w, L, q, *_ = _sparse_case()
    before = dict(tp.fista_counts)
    tp.fit_plm(codes, w, q, _fista_cfg(30), device="cpu")
    assert tp.fista_counts["steps"] - before["steps"] == 30
    assert tp.fista_counts["backtracks"] > before["backtracks"]


def test_fista_without_group_penalty_descends():
    """lambda_group = 0: the prox is the identity (accelerated gradient
    descent); the objective falls and nothing is zeroed."""
    codes, w, L, q, *_ = _sparse_case()
    fit = tp.fit_plm(codes, w, q, tp.PlmConfig(
        solver="fista", max_iter=40, block_size=8, dtype="float64",
        lambda_J=0.05), device="cpu")
    fx = [r["fx"] for r in fit.iteration_table]
    assert fx[-1] < fx[0]
    assert np.all(np.sqrt((fit.J_ij ** 2).sum(axis=(2, 3)))
                  [np.triu_indices(L, k=1)] > 0)


def test_fista_refuses_smoothed_group():
    codes, w, L, q, *_ = _sparse_case()
    with pytest.raises(ValueError, match="EXACT"):
        tp.fit_plm(codes, w, q, tp.PlmConfig(
            solver="fista", lambda_group=1.0, group_mode="smoothed"),
            device="cpu")


def test_run_plm_routes_exact_group_l1_to_fista(tmp_path):
    """lambda_g > 0 without group_mode: run_plm fits the exact penalty
    with FISTA (exact zero blocks), as the JAX package does; the two
    float32 fits agree within 1e-4 in J and cn over 30 iterations."""
    a2m = os.path.join(GOLDEN, "golden.a2m")
    kw = dict(focus_seq="TARGET_SEQ/11-28", theta=0.8, iterations=30,
              lambda_h=0.01, lambda_J=1.0, lambda_g=40.0)
    run_plm(a2m, str(tmp_path / "t.txt"), str(tmp_path / "t.model"),
            device="cpu", **kw)
    jax_run_plm(a2m, str(tmp_path / "j.txt"), str(tmp_path / "j.model"),
                **kw)
    got = CouplingsModel(str(tmp_path / "t.model"))
    L = got.L
    bn = np.sqrt((got.J_ij ** 2).sum(axis=(2, 3)))[np.triu_indices(L, 1)]
    assert np.any(bn == 0.0)
    want = CouplingsModel(str(tmp_path / "j.model"))
    np.testing.assert_allclose(got.J_ij, want.J_ij, atol=1e-4)
    ec_got = read_raw_ec_file(str(tmp_path / "t.txt"), sort=False)
    ec_want = read_raw_ec_file(str(tmp_path / "j.txt"), sort=False)
    np.testing.assert_allclose(ec_got.cn.values, ec_want.cn.values,
                               atol=1e-4)
