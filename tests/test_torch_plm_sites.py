"""The port's asymmetric per-site fit (ops/plm_sites.py) against the JAX
package's on the host, and its golden3 gate.

The JAX asymmetric path is float32 only (it refuses float64), so its fits
are compared in float32, iterate by iterate over 10 iterations: the
objective within 1e-6 relative, the norms within 5e-5 (the gradient norm,
small near the end, is the least resolved) and the parameters within
5e-6."""

import os

import numpy as np
import pytest
import torch

import oracle_plm as oracle
from evcouplings_tpu.couplings.fitter import run_plm as jax_run_plm
from evcouplings_tpu.couplings.pairs import read_raw_ec_file
from evcouplings_tpu.ops import plm as jp
from evcouplings_tpu.ops import plm_sites as js
from evcouplings_torch.couplings.fitter import run_plm
from evcouplings_torch.couplings.model import CouplingsModel
from evcouplings_torch.ops import plm as tp
from evcouplings_torch.ops import plm_sites as ts
from test_golden_regression import ATOL, RTOL, assert_exact_rank_order

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "golden")
GOLDEN3_KW = dict(focus_seq="TARGET_SEQ/11-28", theta=0.8, lambda_h=0.01,
                  lambda_J=16.15, parametrization="asymmetric",
                  solver="lbfgs", compute_dtype="float32",
                  matmul_precision="highest")


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread (the test runners share the
    host's cores, and thread pools of tiny ops then spin against each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data():
    codes = oracle.synthetic_msa(64, 8, 5, seed=3, n_coupled=3)
    w = np.random.default_rng(5).uniform(0.5, 1.0, 64)
    return codes, w


def _excess(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want) / (ATOL + RTOL * np.abs(want))))


@pytest.mark.parametrize("solver,extra", [
    ("adam", {}),
    ("adam", {"grad_layout": "two_phase"}),
    ("adam", {"lambda_group": 0.5, "group_mode": "smoothed"}),
    ("lbfgs", {}),
    ("lbfgs", {"lambda_group": 0.5, "group_mode": "smoothed"}),
])
def test_fit_matches_jax_iterate_by_iterate(solver, extra):
    codes, w = _data()
    cfg = tp.PlmConfig(solver=solver, max_iter=10, block_size=16,
                       conv_tol=0.0, lambda_J=0.3, **extra)
    got = ts.fit_plm_asym(codes, w, 5, cfg, device="cpu")
    want = js.fit_plm_asym(codes, w, 5, jp.PlmConfig(**cfg.__dict__))
    for key, rtol in (("fx", 1e-6), ("gnorm", 5e-5), ("xnorm", 5e-5),
                      ("hnorm", 5e-5), ("Jnorm", 5e-5)):
        np.testing.assert_allclose(
            [r[key] for r in got.iteration_table],
            [r[key] for r in want.iteration_table], rtol=rtol, err_msg=key)
    np.testing.assert_allclose(got.J_ij, want.J_ij, atol=5e-6)
    np.testing.assert_allclose(got.h_i, want.h_i, atol=5e-6)
    np.testing.assert_allclose(got.final_loss, want.final_loss, rtol=1e-6)
    assert (got.num_iter, got.converged, got.ls_failed) == (
        want.num_iter, want.converged, want.ls_failed)


def test_block_residual_matches_jax():
    """One block's per-site NLL and residual (float32, 1e-6)."""
    L, q, B = 4, 3, 8
    rng = np.random.default_rng(1)
    rows = rng.integers(-1, q, size=(B, L)).astype(np.int8)
    wb = rng.uniform(0.5, 1.0, size=B).astype(np.float32)
    J = (rng.normal(size=(L * q, L * q)) * 0.3).astype(np.float32)
    h = rng.normal(size=(L, q)).astype(np.float32)
    oh = np.eye(q, dtype=np.float32)[np.maximum(rows, 0)] * (
        rows >= 0)[..., None]
    oh = oh.reshape(B, L * q)
    mask = ts._site_mask(L, q, torch.float32, "cpu")
    got = ts._make_block_residual(L, q)(
        torch.tensor(J) * mask, torch.tensor(h), torch.tensor(rows),
        torch.tensor(wb), torch.tensor(oh))
    want = js._make_block_residual(L, q, B, jp._precision("highest"))(
        J * mask.numpy(), h, rows, wb, oh, 0)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(js._site_mask(L, L, q, 0, np.float32)))


def test_refusals():
    codes, w = _data()
    for cfg, match in (
            (tp.PlmConfig(solver="fista"), "solver"),
            (tp.PlmConfig(solver="adam", dtype="float64"), "float64"),
            (tp.PlmConfig(solver="adam", lambda_group=0.1), "SMOOTHED"),
            (tp.PlmConfig(solver="lbfgs", grad_layout="two_phase"),
             "two_phase")):
        with pytest.raises(ValueError, match=match):
            ts.fit_plm_asym(codes, w, 5, cfg, device="cpu")
    # a mesh without a "model" axis (sites shard along it)
    from evcouplings_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="'model'"):
        ts.fit_plm_asym(codes, w, 5, mesh=make_mesh(1, device="cpu"),
                        device="cpu")


def test_lbfgs_converges_per_site():
    """With a loose tolerance every site converges and the fit stops with
    'converged', as the JAX package's."""
    codes, w = _data()
    cfg = tp.PlmConfig(solver="lbfgs", max_iter=200, block_size=16,
                       conv_tol=1e-3, lambda_J=0.3)
    got = ts.fit_plm_asym(codes, w, 5, cfg, device="cpu")
    want = js.fit_plm_asym(codes, w, 5, jp.PlmConfig(**cfg.__dict__))
    assert got.converged and want.converged
    assert abs(got.num_iter - want.num_iter) <= 1
    np.testing.assert_allclose(got.J_ij, want.J_ij, atol=1e-4)


def test_golden3_gate(tmp_path):
    """The asymmetric golden fixture's gate (RTOL 1e-4, ATOL 1e-5, exact
    rank order) on the host, at 12 iterations against the JAX package's
    run_plm (which reproduces tests/data/golden/golden3.model bit for bit
    at 25). 12 is the largest count the port passes: the fit amplifies
    one-ulp differences of the gradient past the gate by iteration 14
    (test_golden3_ulp_envelope). Prints the excess at 12 and 14 (pytest
    -s)."""
    a2m = os.path.join(GOLDEN, "golden.a2m")
    excess = {}
    for its in (12, 14):
        run_plm(a2m, str(tmp_path / "t.txt"), str(tmp_path / "t.model"),
                iterations=its, device="cpu", **GOLDEN3_KW)
        jax_run_plm(a2m, str(tmp_path / "j.txt"),
                    str(tmp_path / "j.model"), iterations=its, **GOLDEN3_KW)
        got = read_raw_ec_file(str(tmp_path / "t.txt"), sort=False)
        want = read_raw_ec_file(str(tmp_path / "j.txt"), sort=False)
        gm, wm = (CouplingsModel(str(tmp_path / n))
                  for n in ("t.model", "j.model"))
        excess[its] = {"cn": _excess(got.cn.values, want.cn.values),
                       "J_ij": _excess(gm.J_ij, wm.J_ij),
                       "h_i": _excess(gm.h_i, wm.h_i)}
        if its == 12:
            assert (got.i == want.i).all() and (got.j == want.j).all()
            assert max(excess[12].values()) <= 1.0, excess
            assert_exact_rank_order(got, want)
    print("golden3 port vs JAX, excess over the gate by iterations:", excess)


def test_golden3_ulp_envelope(tmp_path, monkeypatch):
    """At the fixture's 25 iterations one f32 ulp of relative noise on the
    host gradient moves the fit far past the gate (J excess ~260, h
    ~9000); the port lands inside twice the drift that noise causes (J
    3e-3, h 0.3). Prints both (pytest -s)."""
    a2m = os.path.join(GOLDEN, "golden.a2m")
    clean = ts._make_local_vg_site
    gen = torch.Generator().manual_seed(0)

    def noisy(*args, **kw):
        vg = clean(*args, **kw)

        def vg_noisy(J, h, codes, w):
            f, dJ, dh = vg(J, h, codes, w)
            return f, *(g * (1 + 6e-8 * torch.randn(g.shape, generator=gen))
                        for g in (dJ, dh))
        return vg_noisy

    fits = {}
    for tag in ("clean", "noisy"):
        monkeypatch.setattr(ts, "_make_local_vg_site",
                            noisy if tag == "noisy" else clean)
        run_plm(a2m, str(tmp_path / (tag + ".txt")),
                str(tmp_path / (tag + ".model")), iterations=25,
                device="cpu", **GOLDEN3_KW)
        fits[tag] = CouplingsModel(str(tmp_path / (tag + ".model")))
    drift = {k: float(np.abs(getattr(fits["clean"], k)
                             - getattr(fits["noisy"], k)).max())
             for k in ("J_ij", "h_i")}
    noise_excess = {k: _excess(getattr(fits["noisy"], k),
                               getattr(fits["clean"], k))
                    for k in ("J_ij", "h_i")}
    assert noise_excess["J_ij"] > 10
    fixture = CouplingsModel(os.path.join(GOLDEN, "golden3.model"))
    err = {k: float(np.abs(getattr(fits["clean"], k)
                           - getattr(fixture, k)).max())
           for k in ("J_ij", "h_i")}
    got = read_raw_ec_file(str(tmp_path / "clean.txt"), sort=False)
    want = read_raw_ec_file(os.path.join(GOLDEN, "golden3_ECs.txt"),
                            sort=False)
    err["cn"] = float(np.abs(got.cn.values - want.cn.values).max())
    print("golden3, 25 iterations: 1-ulp noise drift", drift,
          "(excess over the gate", noise_excess, "); port against the "
          "fixture", err)
    envelope = {"J_ij": 6e-3, "h_i": 0.5, "cn": 4e-3}
    assert all(err[k] <= envelope[k] for k in envelope), err


def test_run_plm_asymmetric_adam_default(tmp_path):
    """parametrization="asymmetric" without a solver fits Adam (the JAX
    default), block 1024 capped at N; fx within 5e-6 relative over 15
    steps, the models within 1e-5."""
    a2m = os.path.join(GOLDEN, "golden.a2m")
    kw = dict(focus_seq="TARGET_SEQ/11-28", iterations=15, lambda_J=1.0,
              parametrization="asymmetric")
    res = run_plm(a2m, str(tmp_path / "t.txt"), str(tmp_path / "t.model"),
                  device="cpu", **kw)
    jres = jax_run_plm(a2m, str(tmp_path / "j.txt"),
                       str(tmp_path / "j.model"), **kw)
    np.testing.assert_allclose(res.iteration_table.fx.values,
                               jres.iteration_table.fx.values, rtol=5e-6)
    np.testing.assert_allclose(
        CouplingsModel(str(tmp_path / "t.model")).J_ij,
        CouplingsModel(str(tmp_path / "j.model")).J_ij, atol=1e-5)
