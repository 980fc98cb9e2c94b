"""The bf16 row block's epilogue of the PLM value+grad on the host: which
route takes K6 (kernels/block_epilogue.py), the plain version against the
float64 formula and against the JAX package's bf16 value+grad, and the
fused route's plumbing in ops/plm.py (the residual written into the
caller's rows, the NLL summed from the rows' terms, the count on the
plm.value_grad span) with K6 stood in for by its float64 reference. K6
itself runs on the card only (tests/test_torch_gpu.py)."""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import epilogue_fixtures as efx
from evcouplings_torch.kernels import block_epilogue as k6
from evcouplings_torch.ops import plm as tp
from evcouplings_torch.utils import tracing

try:
    import jax.numpy as jnp

    from evcouplings_tpu.ops import plm as jp
except ImportError:
    jnp = jp = None

CPU = [torch.profiler.ProfilerActivity.CPU]
# the benchmark's readers (bench_port/) sit at the repository's root
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
def test_only_bf16_on_a_cuda_device_takes_k6(dtype, device):
    """The route follows what the input shows: bf16 compute on a CUDA
    device takes K6; float32 and float64 (every precision name) and
    everything on the CPU take the plain version."""
    want = dtype == torch.bfloat16 and device == "cuda"
    assert k6.fuses_epilogue(dtype, torch.device(device)) is want
    assert k6.fuses_epilogue(dtype, device) is want


def test_k6_refuses_cpu_tensors():
    logits, codes, w = efx.epilogue_problem(0, 8, 4, 5)
    r = torch.empty_like(logits)
    t = torch.empty(8)
    before = k6.block_epilogue.launches
    with pytest.raises(ValueError, match="CUDA"):
        k6.block_epilogue(logits, codes, w, 5, r, t)
    assert k6.block_epilogue.launches == before


@pytest.mark.parametrize("B,L,q", [(64, 6, 5), (40, 7, 21)])
def test_plain_version_is_the_formula_to_bf16(B, L, q):
    """block_epilogue_plain from bf16 logits against the float64 formula:
    the residual within a few bf16 ulps of its largest entry (5-6
    roundings to bf16, bf16 weights), the NLL within 1e-2 relative (the
    observed logits summed in bf16)."""
    logits, codes, w = efx.epilogue_problem(B + L, B, L, q)
    oh = tp.one_hot(codes, q, dtype=torch.bfloat16).reshape(B, L * q)
    nll_b, r = k6.block_epilogue_plain(logits, oh, codes,
                                       w.to(torch.bfloat16), L, q,
                                       torch.float32)
    r64, t64 = efx.epilogue_f64(logits, codes, w, q)
    assert r.dtype == torch.bfloat16 and nll_b.dtype == torch.float32
    assert np.abs(r.double().numpy() - r64).max() <= 2 ** -5
    np.testing.assert_allclose(float(nll_b), -t64.sum(), rtol=1e-2)
    # padding rows and gaps leave no residual
    assert not r[-3:].any() and not r[1].any()


@pytest.mark.parametrize("layout", ["carried", "two_phase"])
def test_plain_route_matches_jax_bf16(layout):
    """The bf16 value+grad on the host (the plain route) against the JAX
    package's bf16 value+grad: the value within 1e-6 (float32 sums over
    rows and blocks in another order); the gradient bit for bit in the
    two-phase layout, and within 2e-3 of its norm in the carried one,
    which sums dJh over the blocks in another order."""
    codes, w, P, h = _problem()
    L, q = codes.shape[1], 5
    cfg = dict(lambda_h=0.01, lambda_J=0.5, block_size=16,
               grad_layout=layout)
    vt, gt = tp.make_plm_value_and_grad(
        L, q, tp.PlmConfig(dtype="bfloat16", **cfg), symmetric_params=True)(
        {"J": torch.as_tensor(P), "h": torch.as_tensor(h)},
        torch.as_tensor(codes), torch.as_tensor(w))
    vj, gj = jp.make_plm_value_and_grad(
        L, q, jp.PlmConfig(dtype="bfloat16", **cfg), symmetric_params=True)(
        {"J": jnp.asarray(P), "h": jnp.asarray(h)}, jnp.asarray(codes),
        jnp.asarray(w))
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-6)
    for k in ("J", "h"):
        got, want = gt[k].numpy(), np.asarray(gj[k])
        if layout == "two_phase":
            np.testing.assert_array_equal(got, want)
        else:
            err = np.linalg.norm(got - want)
            assert err <= 2e-3 * np.linalg.norm(want), (k, err)


def _problem(seed=5, N=64, L=6, q=5):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, q, size=(N, L)).astype(np.int8)
    codes[::7, 1] = -1
    codes[-5:] = -1
    w = (rng.random(N) + 0.2).astype(np.float32)
    w[-5:] = 0.0
    lq = L * q
    A = rng.normal(size=(lq, lq)) * 0.3
    site = np.arange(lq) // q
    P = (0.5 * (A + A.T) * (site[:, None] != site[None, :])).astype(
        np.float32)
    h = (rng.normal(size=(L, q)) * 0.5).astype(np.float32)
    return codes, w, P, h


def _as_card_route(monkeypatch):
    """Let bf16 CPU tensors take the fused route, with K6 stood in for by
    its float64 reference (one rounding of the residual), counted."""
    calls = []

    def k6_stand_in(logits, codes, weights, q, r_out, terms_out):
        assert logits.dtype == torch.bfloat16 and codes.dtype == torch.int8
        assert weights.dtype == torch.float32
        calls.append(r_out.data_ptr())
        efx.as_k6(logits, codes, weights, q, r_out, terms_out)

    monkeypatch.setattr(tp, "fuses_epilogue",
                        lambda dtype, device: dtype == torch.bfloat16)
    monkeypatch.setattr(tp, "block_epilogue", k6_stand_in)
    return calls


@pytest.mark.parametrize("layout", ["carried", "two_phase"])
def test_fused_route_plumbing(monkeypatch, layout):
    """The fused route of make_plm_value_and_grad, K6 stood in for by its
    float64 reference: one launch per row block, each writing a residual
    the gradient product reads (the two-phase layout: straight into the
    rows of its residual store); the value and gradient as the plain
    route's to bf16 rounding, and nearer the float64 evaluation; the
    count `epilogue_fused` on the evaluation's plm.value_grad span."""
    codes, w, P, h = _problem()
    L, q = codes.shape[1], 5
    args = ({"J": torch.as_tensor(P), "h": torch.as_tensor(h)},
            torch.as_tensor(codes), torch.as_tensor(w))
    cfg = dict(lambda_h=0.01, lambda_J=0.5, block_size=16,
               grad_layout=layout)
    v_plain, g_plain = tp.make_plm_value_and_grad(
        L, q, tp.PlmConfig(dtype="bfloat16", **cfg),
        symmetric_params=True)(*args)
    v64, g64 = tp.make_plm_value_and_grad(
        L, q, tp.PlmConfig(dtype="float64", **cfg), symmetric_params=True)(
        {k: v.double() for k, v in args[0].items()}, args[1],
        args[2].double())

    calls = _as_card_route(monkeypatch)
    vg = tp.make_plm_value_and_grad(L, q, tp.PlmConfig(dtype="bfloat16",
                                                       **cfg),
                                    symmetric_params=True)
    tracing.clear_spans()
    with torch.profiler.profile(activities=CPU):
        v, g = vg(*args)
    (rec,) = [r for r in tracing.span_records()
              if r["name"] == "plm.value_grad"]
    assert rec["counts"] == {"epilogue_fused": 1}
    assert len(calls) == 64 // 16
    if layout == "two_phase":
        # consecutive rows of one store, 16 rows of L q bf16 apart
        steps = np.diff(calls)
        assert (steps == 16 * L * q * 2).all(), steps
    assert v.dtype == torch.float32 and g["J"].dtype == torch.float32

    assert abs(float(v) - float(v_plain)) <= 1e-2 * abs(float(v64))
    assert abs(float(v) - float(v64)) <= abs(float(v_plain) - float(v64))
    for k in ("J", "h"):
        ref = g64[k].numpy()
        err = np.linalg.norm(g[k].double().numpy() - ref)
        err_plain = np.linalg.norm(g_plain[k].double().numpy() - ref)
        assert err <= 3e-2 * np.linalg.norm(ref), (k, err)
        assert err <= err_plain, (k, err, err_plain)


def _traced_fit(codes, w, q, cfg):
    tracing.clear_spans()
    with torch.profiler.profile(activities=CPU):
        res = tp.fit_plm(codes, w, q, cfg, device="cpu")
    return res, tracing.span_records()


def test_fused_route_in_the_fused_adam_step(monkeypatch):
    """A production fit on the host with K6 stood in for: every step's
    plm.value_grad span in the loop carries `epilogue_fused`, so the
    benchmark's epilogue_fused_share reads 100 (0 for the plain route's
    fit), and the fit descends as the plain route's does."""
    from bench_port import epilogue_readers

    codes, w, P, h = _problem(N=96)
    q = 5
    cfg = tp.PlmConfig(max_iter=4, block_size=32, dtype="bfloat16",
                       solver="adam", fused_update="on", conv_tol=0.0,
                       lambda_J=0.5, grad_layout="two_phase")
    ctx = SimpleNamespace(cell=SimpleNamespace(control=False),
                          outcome=SimpleNamespace(counters={"fit_s": [1.0]}))
    plain, _ = _traced_fit(codes, w, q, cfg)
    assert epilogue_readers.epilogue_fused_share(ctx) == 0.0
    calls = _as_card_route(monkeypatch)
    res, records = _traced_fit(codes, w, q, cfg)
    assert epilogue_readers.epilogue_fused_share(ctx) == 100.0
    by_id = {r["id"]: r for r in records}
    evals = [r for r in records if r["name"] == "plm.value_grad"
             and by_id[r["parent"]]["name"] == "fit.loop"]
    assert len(evals) == 4
    assert all(r["counts"] == {"epilogue_fused": 1} for r in evals)
    # 3 blocks per evaluation: 4 steps and the final pricing
    assert len(calls) == 3 * 5
    fx = [r["fx"] for r in res.iteration_table]
    fx_plain = [r["fx"] for r in plain.iteration_table]
    assert fx[-1] < fx[0]
    np.testing.assert_allclose(fx, fx_plain, rtol=1e-2)
