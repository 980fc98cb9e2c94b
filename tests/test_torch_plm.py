"""The symmetric PLM fit of the PyTorch port against the JAX package, on
small problems: the closed-form value+grad in float64 (both gradient
layouts), whole fits with both solvers, the fused Adam epilogue against
the unfused step, a bfloat16 value+grad, and the configuration surface.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evcouplings_tpu.ops import plm as jp
from evcouplings_torch.ops import plm as tp


def _problem(seed=0, N=40, L=5, q=4, block=16, missing=True):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, q, size=(N, L)).astype(np.int8)
    codes[3] = codes[1]
    if missing:
        codes[::7, 1] = -1
    w = rng.random(N) + 0.2
    n_pad = -(-N // block) * block
    cp = np.full((n_pad, L), -1, np.int8)
    cp[:N] = codes
    wp = np.zeros(n_pad)
    wp[:N] = w
    lq = L * q
    A = rng.normal(size=(lq, lq)) * 0.3
    site = np.arange(lq) // q
    P = 0.5 * (A + A.T) * (site[:, None] != site[None, :])
    h = rng.normal(size=(L, q)) * 0.5
    return codes, w, cp, wp, P, h, A


@pytest.mark.parametrize("layout", ["carried", "two_phase"])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("lambda_group", [0.0, 0.3])
def test_value_and_grad_match_jax_f64(layout, symmetric, lambda_group):
    # float64, same formulas: 1e-12 relative on the value, 1e-10 on grads
    codes, w, cp, wp, P, h, A = _problem()
    L, q = codes.shape[1], 4
    J = P if symmetric else A
    kw = dict(lambda_h=0.02, lambda_J=0.7, lambda_group=lambda_group,
              group_mode="smoothed", dtype="float64", block_size=16,
              grad_layout=layout)
    vj, gj = jp.make_plm_value_and_grad(
        L, q, jp.PlmConfig(**kw), symmetric_params=symmetric)(
        {"J": jnp.asarray(J), "h": jnp.asarray(h)}, jnp.asarray(cp),
        jnp.asarray(wp))
    vt, gt = tp.make_plm_value_and_grad(
        L, q, tp.PlmConfig(**kw), symmetric_params=symmetric)(
        {"J": torch.as_tensor(J), "h": torch.as_tensor(h)},
        torch.as_tensor(cp), torch.as_tensor(wp))
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-12)
    for k in ("J", "h"):
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(gj[k]),
                                   rtol=1e-10, atol=1e-10)


def test_raw_nll_gradient_matches_jax_f64():
    codes, w, cp, wp, P, h, _ = _problem(seed=3)
    L, q = codes.shape[1], 4
    lq_aug = tp._augmented_width(L * q)
    assert lq_aug == jp._augmented_width(L * q)
    cfg = dict(dtype="float64", block_size=16)
    params_t = {"J": torch.as_tensor(P), "h": torch.as_tensor(h)}
    J_aug_t = tp._build_j_aug(params_t, L, q, torch.float64, lq_aug)
    J_aug_j = jp._build_j_aug({"J": jnp.asarray(P), "h": jnp.asarray(h)},
                              L, q, jnp.float64, lq_aug)
    np.testing.assert_array_equal(J_aug_t.numpy(), np.asarray(J_aug_j))
    nt, dt = tp.make_plm_nll_vg(L, q, tp.PlmConfig(**cfg))(
        J_aug_t, torch.as_tensor(cp), torch.as_tensor(wp))
    nj, dj = jp.make_plm_nll_vg(L, q, jp.PlmConfig(**cfg))(
        J_aug_j, jnp.asarray(cp), jnp.asarray(wp), None)
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-12)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-10,
                               atol=1e-10)


def test_bfloat16_value_and_grad():
    # bf16 operands (8-bit significand) against the float64 objective:
    # the value within 1e-2 relative, the gradient within 3e-2 of its
    # norm (bf16 rounding of the logits and residuals, f32 accumulation)
    codes, w, cp, wp, P, h, _ = _problem(seed=5, N=64, L=6, q=5)
    L, q = 6, 5
    params = {"J": torch.as_tensor(P, dtype=torch.float32),
              "h": torch.as_tensor(h, dtype=torch.float32)}
    for layout in ("carried", "two_phase"):
        cfg = dict(lambda_h=0.01, lambda_J=0.5, block_size=16,
                   grad_layout=layout)
        v16, g16 = tp.make_plm_value_and_grad(
            L, q, tp.PlmConfig(dtype="bfloat16", **cfg),
            symmetric_params=True)(params, torch.as_tensor(cp),
                                   torch.as_tensor(wp, dtype=torch.float32))
        vj, gj = jp.make_plm_value_and_grad(
            L, q, jp.PlmConfig(dtype="float64", **cfg),
            symmetric_params=True)(
            {"J": jnp.asarray(P), "h": jnp.asarray(h)}, jnp.asarray(cp),
            jnp.asarray(wp))
        assert v16.dtype == torch.float32 and g16["J"].dtype == torch.float32
        np.testing.assert_allclose(float(v16), float(vj), rtol=1e-2)
        for k in ("J", "h"):
            ref = np.asarray(gj[k])
            err = np.linalg.norm(g16[k].double().numpy() - ref)
            assert err <= 3e-2 * np.linalg.norm(ref), (k, err)


def _fit_both(cfg_kw, seed=7, N=64, L=7, q=4):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, q, size=(N, L)).astype(np.int8)
    weights = rng.random(N) + 0.5
    rj = jp.fit_plm(codes, weights, q, jp.PlmConfig(**cfg_kw))
    rt = tp.fit_plm(codes, weights, q, tp.PlmConfig(**cfg_kw), device="cpu")
    return rj, rt


def test_lbfgs_fit_matches_jax_f64():
    # float64: the trajectories agree to reduction-order noise
    rj, rt = _fit_both(dict(solver="lbfgs", max_iter=15, block_size=32,
                            dtype="float64", lambda_h=0.01, lambda_J=0.5))
    assert rt.num_iter == rj.num_iter
    np.testing.assert_allclose(rt.J_ij, rj.J_ij, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(rt.h_i, rj.h_i, rtol=1e-8, atol=1e-10)
    for a, b in zip(rt.iteration_table, rj.iteration_table):
        for k in ("iter", "fx", "gnorm", "xnorm", "hnorm", "Jnorm"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6)
    np.testing.assert_allclose(rt.final_loss, rj.final_loss, rtol=1e-10)


def test_lbfgs_parity_fit_matches_jax_f32():
    # float32 parity mode: the LBFGS dots are the JAX engine's sequential
    # FMA chain, so the trajectories agree to 1e-5 (the products of the
    # value+grad round alike on the host)
    rj, rt = _fit_both(dict(solver="lbfgs", max_iter=15, block_size=32,
                            dtype="float32", lambda_h=0.01, lambda_J=0.5))
    np.testing.assert_allclose(rt.J_ij, rj.J_ij, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rt.h_i, rj.h_i, rtol=1e-5, atol=1e-6)
    assert (rt.converged, rt.ls_failed) == (rj.converged, rj.ls_failed)


def test_adam_fit_matches_optax_fit():
    # the unfused step is optax.adam's formula: float32 trajectories
    # agree to 1e-5 relative over 30 steps
    rj, rt = _fit_both(dict(solver="adam", adam_lr=1e-2, max_iter=30,
                            block_size=32, dtype="float32",
                            steps_per_call=5, lambda_h=0.01,
                            lambda_J=0.5))
    np.testing.assert_allclose(rt.J_ij, rj.J_ij, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rt.h_i, rj.h_i, rtol=1e-5, atol=1e-6)
    fx_t = [r["fx"] for r in rt.iteration_table]
    fx_j = [r["fx"] for r in rj.iteration_table]
    np.testing.assert_allclose(fx_t, fx_j, rtol=1e-6)
    np.testing.assert_allclose(rt.final_loss, rj.final_loss, rtol=1e-6)


def test_fused_update_matches_unfused():
    # the tolerances of the JAX package's own fused-vs-unfused gate
    rng = np.random.default_rng(7)
    N, L, q = 64, 7, 4
    codes = rng.integers(0, q, size=(N, L)).astype(np.int8)
    weights = np.ones(N)
    base = dict(solver="adam", adam_lr=1e-2, max_iter=25, block_size=32,
                dtype="float32", precision="highest", steps_per_call=5,
                lambda_h=0.01, lambda_J=0.5)
    r_off = tp.fit_plm(codes, weights, q,
                       tp.PlmConfig(fused_update="off", **base),
                       device="cpu")
    r_on = tp.fit_plm(codes, weights, q,
                      tp.PlmConfig(fused_update="on", **base), device="cpu")
    np.testing.assert_allclose(r_on.J_ij, r_off.J_ij, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(r_on.h_i, r_off.h_i, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose([r["fx"] for r in r_on.iteration_table],
                               [r["fx"] for r in r_off.iteration_table],
                               rtol=1e-4)
    np.testing.assert_allclose([r["gnorm"] for r in r_on.iteration_table],
                               [r["gnorm"] for r in r_off.iteration_table],
                               rtol=1e-3, atol=1e-6)


def test_production_mode_fit_descends():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 5, size=(96, 8)).astype(np.int8)
    r = tp.fit_plm(codes, np.ones(96), 5, tp.PlmConfig(
        solver="adam", dtype="bfloat16", block_size=32, max_iter=12,
        grad_layout="two_phase", fused_update="on"), device="cpu")
    fx = [row["fx"] for row in r.iteration_table]
    assert np.all(np.isfinite(fx)) and fx[-1] < fx[0]
    assert r.J_ij.shape == (8, 8, 5, 5)


def test_config_defaults_match_jax():
    got = {f.name: f.default for f in dataclasses.fields(tp.PlmConfig)}
    want = {f.name: f.default for f in dataclasses.fields(jp.PlmConfig)}
    assert got == want


@pytest.mark.parametrize("kw", [
    dict(dtype="bfloat16", block_size=8192),
    dict(dtype="bfloat16", block_size=512),
    dict(dtype="float32", block_size=8192),
    dict(dtype="bfloat16", block_size=4096, grad_layout="carried"),
], ids=["bf16_8192", "bf16_512", "f32_8192", "forced_carried"])
def test_layout_and_memory_estimate_match_jax(kw):
    for solver in ("lbfgs", "adam"):
        cj = jp.PlmConfig(solver=solver, **kw)
        ct = tp.PlmConfig(solver=solver, **kw)
        dt = torch.bfloat16 if kw["dtype"] == "bfloat16" else torch.float32
        dj = jnp.bfloat16 if kw["dtype"] == "bfloat16" else jnp.float32
        assert (tp._resolve_grad_layout(ct, dt, 16384, 3456)
                == jp._resolve_grad_layout(cj, dj, 16384, 3456))
        for par in ("symmetric", "asymmetric"):
            assert (tp.estimate_fit_hbm_bytes(16384, 160, 21, ct, par)
                    == jp.estimate_fit_hbm_bytes(16384, 160, 21, cj, par))


def test_fused_update_resolution():
    assert not tp._resolve_fused_update(
        tp.PlmConfig(solver="adam"), None, torch.float32)
    assert tp._resolve_fused_update(
        tp.PlmConfig(solver="adam", fused_update="on"), None, torch.float32)
    with pytest.raises(ValueError):
        tp._resolve_fused_update(
            tp.PlmConfig(solver="lbfgs", fused_update="on"), None,
            torch.float32)
    with pytest.raises(ValueError):
        tp._resolve_fused_update(
            tp.PlmConfig(solver="adam", fused_update="maybe"), None,
            torch.float32)


def test_fused_update_auto_follows_the_device():
    # "auto" is on for an eligible fit on a CUDA device (the card's
    # measurement), off on the CPU (the JAX package's rule) and off for
    # an ineligible fit anywhere; no card is needed to resolve it
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    adam = tp.PlmConfig(solver="adam")
    assert tp._resolve_fused_update(adam, None, torch.float32, cuda)
    assert not tp._resolve_fused_update(adam, None, torch.float32, cpu)
    assert not tp._resolve_fused_update(adam, None, torch.float32)
    for cfg, master in ((tp.PlmConfig(solver="lbfgs"), torch.float32),
                        (tp.PlmConfig(solver="adam", lambda_group=0.1),
                         torch.float32),
                        (adam, torch.float64)):
        assert not tp._resolve_fused_update(cfg, None, master, cuda)
    # a mesh of one rank keeps it; a mesh of more turns it off (K2 updates
    # the replicated arrays outside the sharded gradient)
    from types import SimpleNamespace

    from evcouplings_torch.parallel import make_mesh

    assert tp._resolve_fused_update(adam, make_mesh(1, device="cpu"),
                                    torch.float32, cuda)
    assert not tp._resolve_fused_update(adam, SimpleNamespace(size=2),
                                        torch.float32, cuda)
    assert not tp._resolve_fused_update(
        tp.PlmConfig(solver="adam", fused_update="off"), None,
        torch.float32, cuda)


def test_unported_options_raise(tmp_path):
    codes = np.zeros((8, 3), np.int8)
    # a mesh over more ranks than the run has (one process here)
    from evcouplings_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="needs 2 ranks"):
        tp.fit_plm(codes, np.ones(8), 2, tp.PlmConfig(), device="cpu",
                   mesh=make_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="smoothed"):
        tp.fit_plm(codes, np.ones(8), 2, tp.PlmConfig(lambda_group=0.1),
                   device="cpu")


def test_device_hbm_budget(monkeypatch):
    monkeypatch.delenv("EVCOUPLINGS_HBM_BYTES", raising=False)
    assert tp.device_hbm_budget("cpu") == 16 * 1024 ** 3
    assert tp.device_hbm_budget() == 16 * 1024 ** 3
    monkeypatch.setenv("EVCOUPLINGS_HBM_BYTES", "1e9")
    assert tp.device_hbm_budget("cpu") == 10 ** 9


def test_matmul_precision_restores_flags():
    from evcouplings_torch._device import matmul_precision

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    with matmul_precision("highest"):
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    with matmul_precision("high"):
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == saved
    with pytest.raises(ValueError):
        with matmul_precision("fastest"):
            pass
