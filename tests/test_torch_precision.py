"""The port's matmul precision names against the JAX package's definition
of them, in bf16 limbs of the float32 operand of the fits' products
(evcouplings_torch/_device.py, ops/plm.py, Precision): the limb split;
the limb product (ops/plm._mm, one float32 pass per limb) against a
float64 emulation of its passes, bit for bit against the passes summed
largest limb first, and against the JAX package's own products at those
names (jnp.dot with the precision pairs of evcouplings_tpu/ops/plm.
_precision; XLA-CPU forms them in exact float32), in every form the fits
take (the gradient added into dJh, the stored limbs of the two-phase
layouts, the logits from J_aug and from J^T), at ragged shapes; the
structured names against the unstructured ones; and the builders at
"high" and "default" against the JAX twin on the host, where both
packages form exact float32 products. The card's limb route is also run
here by letting the CPU take it (each pass's bf16 products are exact in
float32 and the passes accumulate in float32, as cuBLAS's passes do on
the card); the card's own cases are in tests/test_torch_gpu.py.
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


# relative error of the limb split: one bf16 limb (round to nearest
# even, 8-bit significand) and two
LIMB_REL = {1: 2.0 ** -8, 2: 2.0 ** -17}
Q = 21
# the fits' one-hot products (ops/plm.py, ops/plm_sites.py)
FORMS = ("grad", "stored", "sites_grad", "logits", "logits_t")
SHAPES = [(9, 40), (7, 13)]     # (L, block rows); L=7: Lq 147, ragged


def _one_hot_rows(rng, n, L, width, q):
    """(n, width) [one-hot | 1 | 0] of random codes with gaps (-1); the
    ones column where width > L q."""
    codes = rng.integers(-1, q, size=(n, L))
    oh = np.zeros((n, width), np.float32)
    rows, sites = np.nonzero(codes >= 0)
    oh[rows, sites * q + codes[rows, sites]] = 1.0
    if width > L * q:
        oh[:, L * q] = 1.0
    return torch.as_tensor(oh)


def _form_case(form, L, B, seed, q=Q):
    """One product of the fits: (the float32 operand as the port lays it
    out, the exact side as float32, `into` or None, the depth). The
    product is limbs @ exact, or exact @ limbs for the logits forms
    (`into` is None there)."""
    rng = np.random.default_rng(seed)
    lq = L * q
    lq_aug = tp._augmented_width(lq)

    def oh(n, width):
        return _one_hot_rows(rng, n, L, width, q)

    if form == "grad":          # dJh += limbs(r^T) @ [oh | 1 | 0]
        return (_f32(rng, (B, lq), 0.1).T, oh(B, lq_aug),
                _f32(rng, (lq, lq_aug)), B)
    if form == "stored":        # two-phase: the store's limbs of r^T @ oh
        return _f32(rng, (3 * B, lq), 0.1).T, oh(3 * B, lq_aug), None, 3 * B
    if form == "sites_grad":    # per-site fit: dJ += limbs(r^T) @ oh
        return _f32(rng, (B, lq), 0.1).T, oh(B, lq), _f32(rng, (lq, lq)), B
    if form == "logits":        # [oh | 1 | 0] @ limbs(J_aug)
        return _f32(rng, (lq_aug, lq), 0.05), oh(B, lq_aug), None, lq_aug
    assert form == "logits_t"   # oh @ limbs(J)^T
    return _f32(rng, (lq, lq), 0.05).T, oh(B, lq), None, lq


def _limb_side(form, x, n):
    """The limbs the port hands _mm for a form's float32 operand x: its
    split where the product takes it (_limb_operand, and _transpose of
    J's limbs in the per-site fit), the transposes of the residual
    store's limbs in the two-phase layout (_store_rows, _transpose)."""
    if form in ("stored", "logits_t"):
        return tp._transpose(tp._split_limbs(x.T.contiguous(), n))
    return tp._split_limbs(x, n)


def _product(form, side, exact, into=None):
    """The form's product by ops/plm._mm."""
    e = exact.to(torch.bfloat16)
    if form.startswith("logits"):
        return tp._mm(e, side, torch.float32)
    return tp._mm(side, e, torch.float32, into=into)


# (form, limbs, L, block rows, q): the fits' forms at limbs 1 and 2, and
# the logits and gradient products at limbs 1 to 3 (three limbs hold the
# operand exactly)
_EMULATION_CASES = [
    pytest.param(form, limbs, 9, 48, 5, id="{}-{}".format(name, limbs))
    for name, form in (("logits", "logits"), ("gradient", "grad"))
    for limbs in (1, 2, 3)
] + [
    pytest.param(form, limbs, L, B, Q,
                 id="{}-{}-{}-{}".format(form, limbs, L, B))
    for form in FORMS for limbs in (1, 2) for L, B in SHAPES
]


@pytest.mark.parametrize("form,limbs,L,B,q", _EMULATION_CASES)
def test_limb_product_matches_float64_emulation(form, limbs, L, B, q):
    """The limb product on CPU tensors against the float64 sum of the same
    limb products: within float32 accumulation, (depth + limbs) 2^-24 of
    sum |limb| |exact| (plus |into|), and `into` updated in place (the
    same tensor returned) where it is given; with three limbs, so within
    the float64 product of the float32 operand."""
    x, exact, into, depth = _form_case(form, L, B, seed=limbs + 10 * L, q=q)
    side = _limb_side(form, x, limbs)
    got = _product(form, side, exact,
                   None if into is None else into.clone())
    parts = _limbs_f64(side)
    ex = exact.double()
    if form.startswith("logits"):
        want = sum(ex @ p for p in parts)
        absolute = ex @ sum(p.abs() for p in parts)
        exact64 = ex @ x.double()
    else:
        want = sum(p @ ex for p in parts)
        absolute = sum(p.abs() for p in parts) @ ex
        exact64 = x.double() @ ex
    if into is not None:
        want = want + into.double()
        exact64 = exact64 + into.double()
        absolute = absolute + into.double().abs()
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    bound = (depth + limbs) * EPS32 * absolute
    assert bool(((got.double() - want).abs() <= bound).all())
    if limbs == 3:
        assert bool(((got.double() - exact64).abs() <= bound).all())


@pytest.mark.parametrize("L,B", SHAPES)
@pytest.mark.parametrize("limbs", [1, 2])
@pytest.mark.parametrize("form", FORMS)
def test_limb_product_is_the_passes_summed_largest_first(form, limbs, L, B):
    """ops/plm._mm's limb route bit for bit: one float32 product per limb
    against the exactly-bf16 side (the CPU upcasts, where the card takes
    torch.mm(..., out_dtype=float32)), each added to the sum of those
    before it, largest limb first, and that sum added into `into` after
    the last pass, in place."""
    x, exact, into, _ = _form_case(form, L, B, seed=limbs + 10 * L + 3)
    side = _limb_side(form, x, limbs)
    e = exact.to(torch.bfloat16).float()
    total = None
    for limb in side:
        p = e @ limb.float() if form.startswith("logits") else limb.float() @ e
        total = p if total is None else total + p
    target = None if into is None else into.clone()
    got = _product(form, side, exact, target)
    if into is None:
        assert torch.equal(got, total)
    else:
        assert got is target
        assert torch.equal(got, into + total)


@pytest.mark.parametrize("L,B", SHAPES)
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("form", FORMS)
def test_limb_product_matches_jax_at_precision(form, precision, L, B):
    """The limb product against the JAX package's product at the same
    precision name (jnp.dot with its _precision pair: the one-hot exact,
    the float32 operand at HIGH or DEFAULT), which XLA-CPU forms in exact
    float32: within the limbs' 2^-17 (2 limbs) or 2^-8 (1 limb) of sum
    |a| |b|, plus float32 accumulation on both sides."""
    limbs = {"high": 2, "default": 1}[precision]
    x, exact, into, depth = _form_case(form, L, B, seed=limbs + 10 * L + 1)
    side = _limb_side(form, x, limbs)
    got = _product(form, side, exact,
                   None if into is None else into.clone())
    got = got.numpy().astype(np.float64)
    prec = jp._precision(precision)
    a = x.contiguous().numpy()
    ex = exact.numpy()
    if form.startswith("logits"):
        want = jnp.dot(jnp.asarray(ex), jnp.asarray(a),
                       precision=prec.exact_lhs)
        absolute = ex.astype(np.float64) @ np.abs(a.astype(np.float64))
    else:
        want = jnp.dot(jnp.asarray(a), jnp.asarray(ex),
                       precision=prec.exact_rhs)
        absolute = np.abs(a.astype(np.float64)) @ ex.astype(np.float64)
    want = np.asarray(want, np.float64)
    if into is not None:
        want = want + into.numpy()
        absolute = absolute + np.abs(into.numpy())
    bound = (LIMB_REL[limbs] + 2 * (depth + limbs) * EPS32) * absolute
    assert np.all(np.abs(got - want) <= bound)


def test_limb_product_adds_into_in_place():
    """With `into` the sum of the passes is added into that tensor in
    place and it is returned; without, the product is a new tensor."""
    x, exact, into, _ = _form_case("grad", 9, 40, seed=3)
    side = _limb_side("grad", x, 2)
    before = into.clone()
    fresh = _product("grad", side, exact)
    got = _product("grad", side, exact, into)
    assert got is into and fresh.data_ptr() != into.data_ptr()
    assert torch.equal(got, before + fresh)


def test_empty_limb_products():
    oh = torch.zeros((0, 32), dtype=torch.bfloat16)
    r = torch.zeros((0, 27))
    side = tp._split_limbs(r.T, 2)
    assert torch.equal(tp._mm(side, oh, torch.float32,
                              into=torch.ones(27, 32)), torch.ones(27, 32))
    assert torch.equal(tp._mm(side, oh, torch.float32), torch.zeros(27, 32))


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


@pytest.mark.parametrize("layout", ["carried", "two_phase"])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_card_route_splits_couplings_once_per_evaluation(precision, layout,
                                                         monkeypatch):
    """On the limb route (let the CPU take it) an evaluation of the
    value+grad splits J_aug into its limbs once, before its block loop,
    whatever the number of row blocks, and the residual once per block."""
    _emulate_card_route(monkeypatch)
    L, q, codes, weights, params = _twin_problem()
    lq_aug = tp._augmented_width(L * q)
    splits = []
    real = tp._split_limbs

    def spy(x, n):
        splits.append((tuple(x.shape), n))
        return real(x, n)

    monkeypatch.setattr(tp, "_split_limbs", spy)
    args = ({k: torch.as_tensor(v) for k, v in params.items()},
            torch.as_tensor(codes), torch.as_tensor(weights))
    limbs = _device.precision_limbs(precision)
    for block in (8, 16, 64):
        cfg = tp.PlmConfig(block_size=block, dtype="float32",
                           precision=precision, grad_layout=layout)
        vg = tp.make_plm_value_and_grad(L, q, cfg, symmetric_params=True)
        del splits[:]
        vg(*args)
        couplings = [s for s in splits if s[0] == (lq_aug, L * q)]
        assert couplings == [((lq_aug, L * q), limbs)], (block, splits)
        assert len(splits) - 1 == len(codes) // block, (block, splits)


@pytest.mark.parametrize("two_phase", [False, True])
def test_per_site_card_route_splits_couplings_once_per_call(two_phase,
                                                            monkeypatch):
    """The per-site fit's value+grad on the limb route (let the CPU take
    it) at "high": J split into its limbs once per call, whatever the
    number of row blocks, and the residual once per block."""
    _emulate_card_route(monkeypatch)
    L, q, codes, weights, params = _twin_problem()
    lq = L * q
    splits = []
    real = tp._split_limbs

    def spy(x, n):
        splits.append((tuple(x.shape), n))
        return real(x, n)

    monkeypatch.setattr(tp, "_split_limbs", spy)
    J = torch.as_tensor(params["J"])
    h = torch.as_tensor(params["h"])
    c, w = torch.as_tensor(codes).long(), torch.as_tensor(weights)
    oh = torch.as_tensor(np.eye(q, dtype=np.float32)[codes].reshape(
        len(codes), lq)).bfloat16()
    for block in (8, 16, 64):
        cfg = tp.PlmConfig(dtype="float32", precision="high",
                           block_size=block)
        vg = ts._make_local_vg(L, q, cfg, two_phase=two_phase)
        del splits[:]
        vg(J, h, c, w, oh)
        assert [s for s in splits if s[0] == (lq, lq)] == [((lq, lq), 2)], (
            block, splits)
        assert len(splits) - 1 == len(codes) // block, (block, splits)


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
