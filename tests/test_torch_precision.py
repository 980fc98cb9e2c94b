"""The port's matmul precision names against the JAX package's definition
of them, in bf16 limbs of the float32 operand of the fits' products
(evcouplings_torch/_device.py, ops/plm.py, Precision): the limb split,
the limb product against a float64 emulation of its passes, the
structured names against the unstructured ones, and the builders at
"high" and "default" against the JAX twin on the host, where both
packages form exact float32 products. The card's limb route is also run
here by letting the CPU take it (each pass's bf16 products are exact in
float32 and the passes accumulate in float32, as K5 does on the card,
kernels/limb_mm.py); the card's own cases are in tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evcouplings_tpu.ops import plm as jp
from evcouplings_torch import _device
from evcouplings_torch.ops import plm as tp
from evcouplings_torch.ops import plm_sites as ts

# the golden gate of the repository (tests/test_golden_regression.py)
RTOL, ATOL = 1e-4, 1e-5
EPS32 = 2.0 ** -24


def _f32(rng, shape, scale=1.0):
    # values over several binades, and exact zeros
    x = rng.normal(size=shape) * scale * np.exp2(rng.integers(-6, 6, shape))
    x[rng.random(shape) < 0.05] = 0.0
    return torch.as_tensor(x.astype(np.float32))


def _one_hot_rows(rng, n, L, q):
    codes = rng.integers(-1, q, size=(n, L))
    oh = np.zeros((n, L, q), np.float32)
    rows, sites = np.nonzero(codes >= 0)
    oh[rows, sites, codes[rows, sites]] = 1.0
    return torch.as_tensor(oh.reshape(n, L * q))


def _limbs_f64(limbs):
    return [limb.double() for limb in limbs]


def test_precision_names_are_the_twins_limb_counts():
    assert {name: _device.precision_limbs(name)
            for name in _device.PRECISIONS} == {
        "highest": None, "highest_unstructured": None, "high": 2,
        "high_unstructured": 2, "default": 1}
    with pytest.raises(ValueError, match="Unknown precision"):
        _device.precision_limbs("fastest")
    # every name the JAX package accepts, and no other
    for name in _device.PRECISIONS:
        jp._precision(name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_limbs_sum_back_to_the_input(seed):
    """Three limbs sum back to the float32 input exactly, two within
    2^-17 of it relative, and one limb is the input rounded to bf16."""
    x = _f32(np.random.default_rng(seed), (64, 97))
    xd = x.double()
    one, = tp._split_limbs(x, 1)
    assert one.dtype == torch.bfloat16
    assert torch.equal(one, x.bfloat16())
    two = tp._split_limbs(x, 2)
    err2 = (sum(_limbs_f64(two)) - xd).abs()
    assert bool((err2 <= 2.0 ** -17 * xd.abs()).all()), float(
        (err2 / xd.abs().clamp(min=1e-300)).max())
    three = tp._split_limbs(x, 3)
    assert all(limb.dtype == torch.bfloat16 for limb in three)
    assert torch.equal(sum(_limbs_f64(three)), xd)
    # the first limbs are the same whatever the number of limbs
    assert torch.equal(three[0], two[0]) and torch.equal(three[1], two[1])


@pytest.mark.parametrize("limbs", [1, 2, 3])
@pytest.mark.parametrize("side", ["logits", "gradient"])
def test_limb_product_matches_float64_emulation(limbs, side):
    """The limb product on CPU tensors against a float64 emulation of the
    same limb passes: equal within float32 accumulation, |err| <=
    (K + passes) 2^-24 (|limbs| @ |one-hot|), K the contraction depth."""
    rng = np.random.default_rng(10 + limbs)
    n, L, q = 48, 9, 5
    oh = _one_hot_rows(rng, n, L, q)
    if side == "logits":            # one-hot @ J, the couplings in limbs
        x = _f32(rng, (L * q, 33), 0.05)
        parts = tp._split_limbs(x, limbs)
        got = tp._mm(oh, parts, torch.float32)
        terms = [oh.double() @ p for p in _limbs_f64(parts)]
        absolute = oh.double() @ sum(p.abs() for p in _limbs_f64(parts))
        depth = L * q
    else:                           # r^T @ one-hot, the residual in limbs
        x = _f32(rng, (n, L * q))
        parts = tp._split_limbs(x.T, limbs)
        got = tp._mm(parts, oh, torch.float32)
        terms = [p @ oh.double() for p in _limbs_f64(parts)]
        absolute = sum(p.abs() for p in _limbs_f64(parts)) @ oh.double()
        depth = n
    assert got.dtype == torch.float32
    want = sum(terms)
    bound = (depth + limbs) * EPS32 * absolute
    assert bool(((got.double() - want).abs() <= bound).all())
    if limbs == 3:
        # three limbs: the float64 product of the float32 operands
        exact = (oh.double() @ x.double() if side == "logits"
                 else x.double().T @ oh.double())
        assert bool(((got.double() - exact).abs() <= bound).all())


def _twin_problem():
    # tests/test_plm.py::test_structured_precision_matches_unstructured
    L, q, N = 12, 7, 64
    rng = np.random.default_rng(11)
    codes = rng.integers(0, q, size=(N, L)).astype(np.int8)
    weights = np.ones((N,), np.float32)
    A = 0.1 * rng.normal(size=(L * q, L * q)).astype(np.float32)
    params = {"J": 0.5 * (A + A.T),
              "h": 0.1 * rng.normal(size=(L, q)).astype(np.float32)}
    return L, q, codes, weights, params


def _emulate_card_route(monkeypatch):
    """Let CPU tensors take the limb route that CUDA tensors take."""
    monkeypatch.setattr(tp, "_takes_limbs", lambda dtype, limbs, device: (
        limbs is not None and dtype == torch.float32))


@pytest.mark.parametrize("route", ["host", "card_route"])
@pytest.mark.parametrize("mode,ref_mode", [
    ("highest", "highest_unstructured"),
    ("high", "high_unstructured"),
])
def test_structured_precision_matches_unstructured(mode, ref_mode, route,
                                                   monkeypatch):
    """Twin of tests/test_plm.py::test_structured_precision_matches_
    unstructured: the structured name and its unstructured reference give
    the same loss bit for bit and gradients within 1e-5 (the port takes
    one route for both), on the host and on the card's limb route."""
    if route == "card_route":
        _emulate_card_route(monkeypatch)
    L, q, codes, weights, params = _twin_problem()
    args = ({k: torch.as_tensor(v) for k, v in params.items()},
            torch.as_tensor(codes), torch.as_tensor(weights))
    outs = {}
    for m in (mode, ref_mode):
        cfg = tp.PlmConfig(block_size=16, dtype="float32", precision=m,
                           lambda_h=0.01, lambda_J=0.5)
        v, g = tp.make_plm_value_and_grad(L, q, cfg,
                                          symmetric_params=True)(*args)
        outs[m] = (float(v), g["J"].numpy(), g["h"].numpy())
    v_s, gJ_s, gh_s = outs[mode]
    v_u, gJ_u, gh_u = outs[ref_mode]
    assert v_s == v_u
    np.testing.assert_allclose(gJ_s, gJ_u, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gh_s, gh_u, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["carried", "two_phase"])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_builders_match_jax_twin(precision, layout):
    """make_plm_value_and_grad and make_plm_loss at "high" and "default"
    against the JAX twin on the host (exact float32 products in both
    packages) at the golden gate's RTOL 1e-4 / ATOL 1e-5."""
    L, q, codes, weights, params = _twin_problem()
    kw = dict(block_size=16, dtype="float32", precision=precision,
              lambda_h=0.01, lambda_J=0.5, grad_layout=layout)
    pt = {k: torch.as_tensor(v) for k, v in params.items()}
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    vt, gt = tp.make_plm_value_and_grad(L, q, tp.PlmConfig(**kw),
                                        symmetric_params=True)(
        pt, torch.as_tensor(codes), torch.as_tensor(weights))
    vj, gj = jp.make_plm_value_and_grad(L, q, jp.PlmConfig(**kw),
                                        symmetric_params=True)(
        pj, jnp.asarray(codes), jnp.asarray(weights))
    np.testing.assert_allclose(float(vt), float(vj), rtol=RTOL, atol=ATOL)
    for k in ("J", "h"):
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(gj[k]),
                                   rtol=RTOL, atol=ATOL)
    lt = tp.make_plm_loss(L, q, tp.PlmConfig(**kw), symmetric_params=True)(
        pt, torch.as_tensor(codes), torch.as_tensor(weights))
    lj = jp.make_plm_loss(L, q, jp.PlmConfig(**kw), symmetric_params=True)(
        pj, jnp.asarray(codes), jnp.asarray(weights))
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(lt), float(vt), rtol=1e-6)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("layout", ["carried", "two_phase"])
def test_card_route_against_float64(layout, monkeypatch):
    """The limb route of the fits' builders (let the CPU take it): "high"
    within 1e-5 of the float64 evaluation of the same float32 inputs
    (relative to the largest value), "default" within 1e-2, "high" at
    least 10x closer than "default"; the loss builder agrees with the
    value+grad's value within 1e-5 (it adds the fields in float32 after
    the product, where the value+grad takes them through it as row Lq of
    J_aug: the JAX package's builders do the same; 1.6e-6 apart at
    "default" here)."""
    L, q, codes, weights, params = _twin_problem()
    p64 = {k: torch.as_tensor(v, dtype=torch.float64)
           for k, v in params.items()}
    c, w = torch.as_tensor(codes), torch.as_tensor(weights)
    kw = dict(block_size=16, lambda_h=0.01, lambda_J=0.5, grad_layout=layout)
    v64, g64 = tp.make_plm_value_and_grad(
        L, q, tp.PlmConfig(dtype="float64", **kw), symmetric_params=True)(
        p64, c, w.double())
    _emulate_card_route(monkeypatch)
    p32 = {k: torch.as_tensor(v) for k, v in params.items()}
    errs = {}
    for precision in ("high", "default"):
        cfg = tp.PlmConfig(dtype="float32", precision=precision, **kw)
        v, g = tp.make_plm_value_and_grad(L, q, cfg, symmetric_params=True)(
            p32, c, w)
        errs[precision] = max(_rel(float(v), float(v64)),
                              _rel(g["J"], g64["J"]), _rel(g["h"], g64["h"]))
        loss = tp.make_plm_loss(L, q, cfg, symmetric_params=True)(p32, c, w)
        np.testing.assert_allclose(float(loss), float(v), rtol=1e-5)
    assert errs["high"] <= 1e-5, errs
    assert errs["default"] <= 1e-2, errs
    assert errs["high"] * 10 <= errs["default"], errs


@pytest.mark.parametrize("two_phase", [False, True])
def test_asymmetric_card_route_against_float64(two_phase, monkeypatch):
    """The asymmetric fit's value+grad on the limb route (let the CPU take
    it) at "high": within 1e-5 of its float32 "highest" evaluation,
    relative to the largest value."""
    L, q, codes, weights, params = _twin_problem()
    J = torch.as_tensor(params["J"])
    h = torch.as_tensor(params["h"])
    c, w = torch.as_tensor(codes).long(), torch.as_tensor(weights)
    oh = torch.as_tensor(np.eye(q, dtype=np.float32)[codes].reshape(
        len(codes), L * q))
    outs = {}
    for precision in ("highest", "high"):
        if precision == "high":
            _emulate_card_route(monkeypatch)
        cfg = tp.PlmConfig(dtype="float32", precision=precision,
                           block_size=16)
        vg = ts._make_local_vg(L, q, cfg, two_phase=two_phase)
        outs[precision] = vg(J, h, c, w, oh.bfloat16() if (
            two_phase and precision == "high") else oh)
    for got, want in zip(outs["high"], outs["highest"]):
        assert _rel(got, want) <= 1e-5


def test_card_route_balanced_drift_split(tmp_path, monkeypatch):
    """The complex example config's balanced LBFGS fit (60 iterations,
    "high") on the card's route, let onto the CPU, against the host's own
    fit (exact float32 products, the sequential LBFGS dot: the JAX twin's
    arithmetic): once with the card's LBFGS dot (torch.dot), once with the
    sequential chain, so that the limbs' share of the card-host drift
    shows apart from the dot order's (chip_smoke.py phase 14 splits it on
    the card). Each within DEEP_REL (2e-2) in J and h, the limit phase 14
    holds the card to; the distances are printed (pytest -s)."""
    import shutil

    import yaml

    from examples_fixtures import DEEP_REL, EXAMPLES_TORCH, model_distance
    from evcouplings_torch.couplings.model import CouplingsModel
    from evcouplings_torch.utils import pipeline

    shutil.copytree(EXAMPLES_TORCH, str(tmp_path / "examples_torch"),
                    ignore=shutil.ignore_patterns("output", "__pycache__"))
    monkeypatch.chdir(tmp_path)
    with open(tmp_path / "examples_torch" / "complex_pipeline.yml") as f:
        base = yaml.safe_load(f)
    shipped = tp._lbfgs_dots
    routes = {
        "host": shipped,
        "card": lambda dtype, precision, device: shipped(
            dtype, precision, "cuda"),
        "card_chain": lambda dtype, precision, device: shipped(
            dtype, "highest", "cuda"),
    }
    models = {}
    for name, dots in routes.items():
        config = dict(base, **{"global": dict(
            base["global"], device="cpu",
            prefix="output/{}/demo".format(name))})
        with monkeypatch.context() as m:
            if name != "host":
                _emulate_card_route(m)
                m.setattr(tp, "_lbfgs_dots", dots)
            pipeline.execute_wrapped(**config)
        models[name] = CouplingsModel(str(
            tmp_path / "output" / name / "demo" / "couplings" /
            "demo.model"))
    for name in ("card", "card_chain"):
        dist = model_distance(models[name], models["host"])
        print("card route against the host,", name, dist)
        assert dist["f_i"] == 0.0 and dist["f_ij"] == 0.0, (name, dist)
        assert dist["J_ij"] <= DEEP_REL and dist["h_i"] <= DEEP_REL, (
            name, dist)
