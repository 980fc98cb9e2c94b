"""The production fit (ops/plm.fit_plm with bfloat16 products, float32
masters, Adam, the two-phase layout) against the benchmark's plain
reference (bench_port/reference_adam.py over bench_port/reference.Plm in
float64), on the host at a small size: a 20-step fit from zero, and one
step from seeded random parameters, each with the fused epilogue (K2's
plain version on the host) and without it. The same comparison fails
against the reference with its products' operands rounded to 3 mantissa
bits. And the benchmark's production cell fits with the PlmConfig that
the couplings protocol's production preset gives run_plm at its size."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from bench_port import generate, harness, judge_adam, reference  # noqa: E402
from bench_port import reference_adam  # noqa: E402
from evcouplings_torch.ops import plm as ops_plm  # noqa: E402

N, L, Q, BLOCK = 4096, 8, 21, 2048
LAMBDA_J = 0.01 * (Q - 1) * (L - 1)
SEEDS = (2 ** 31 + 11, 2 ** 31 + 12)

# Tolerances, from the bf16 operands: the logits product rounds each
# logit to bf16 (2^-9 relative) and the gradient product takes the
# residual in bf16 (2^-8 relative per term), where the reference is
# float64. Host readings over seeds 2^31 + 11..16, with and without the
# fused epilogue: fx_path up to 3.35e-4, J 1.76e-3, h 2.64e-3; the
# reference rounded to 3 mantissa bits (seeds 2^31 + 11..13) reads at
# least 4.39e-3, 1.45e-2 and 3.0e-3: it fails fx_path and J, not h.
FX_PATH_TOL = 1.5e-3   # f over 20 steps: each logit's rounding, summed
J_TOL = 5e-3           # |J - J_ref| / |J_ref| and the same of h: Adam
H_TOL = 6e-3           # divides g by its running scale, so bf16's
#                        relative error reaches the step of every
#                        parameter whose g is small


def _cfg(fused, max_iter=20):
    return ops_plm.PlmConfig(
        lambda_h=0.01, lambda_J=LAMBDA_J, max_iter=max_iter, conv_tol=0.0,
        solver="adam", block_size=BLOCK, dtype="bfloat16",
        precision="default", steps_per_call=10, fused_update=fused)


def _data(seed):
    g = generate.generator(seed, torch.device("cpu"))
    codes = generate.synthetic_codes(g, N, L, Q, 16, 0.15, 0.1)
    counts = reference.cluster_counts(codes, 0.8, Q)
    return codes, 1.0 / counts.double()


def _plm(codes, weights, **kw):
    return reference.Plm(codes, weights.to(kw.get("dtype", torch.float64)),
                         Q, 0.01, LAMBDA_J, **kw)


def _gaps(codes, weights, fit, plm):
    """(fx_path, J gap, h gap) of a 20-step program fit against the
    reference's Adam fit over `plm`."""
    rows_ref, x_ref = judge_adam.reference_fit(plm, 20, 5e-3)
    fx = np.array([r["fx"] for r in fit.iteration_table])
    fr = np.array([r[0] for r in rows_ref])
    x = torch.as_tensor(reference.flat_params(fit.J_ij, fit.h_i))
    x_ref = x_ref.double().cpu()
    d = (L * Q) ** 2
    norm = torch.linalg.vector_norm
    return (float(np.max(np.abs(fx - fr) / np.abs(fr))),
            float(norm(x[:d] - x_ref[:d]) / norm(x_ref[:d])),
            float(norm(x[d:] - x_ref[d:]) / norm(x_ref[d:])))


def _fit(codes, weights, fused):
    return ops_plm.fit_plm(codes.numpy(), weights.numpy(), Q, _cfg(fused),
                           device="cpu")


def test_small_fit_resolves_to_the_two_phase_layout():
    assert ops_plm._resolve_grad_layout(
        _cfg("on"), torch.bfloat16, N,
        ops_plm._augmented_width(L * Q)) == "two_phase"


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fused", ["on", "off"])
def test_fit_matches_reference_adam(seed, fused):
    codes, weights = _data(seed)
    fit = _fit(codes, weights, fused)
    assert len(fit.iteration_table) == 20
    fx_path, j_gap, h_gap = _gaps(codes, weights, fit, _plm(codes, weights))
    assert fx_path <= FX_PATH_TOL
    assert j_gap <= J_TOL
    assert h_gap <= H_TOL


@pytest.mark.parametrize("fused", ["on", "off"])
def test_fit_fails_against_a_3_bit_reference(fused):
    """The same comparison against the reference whose products take
    their operands at 3 mantissa bits (E4M3's), below bf16's 8."""
    codes, weights = _data(SEEDS[0])
    fit = _fit(codes, weights, fused)
    fx_path, j_gap, h_gap = _gaps(
        codes, weights, fit,
        _plm(codes, weights, dtype=torch.float32, mantissa_bits=3))
    assert (fx_path > FX_PATH_TOL or j_gap > J_TOL or h_gap > H_TOL)


# One step from random parameters, with Adam's moments under way (count
# 5), so that the step is smooth in g: the step's f and |g| are the
# value+grad's (bf16 logits, 2^-9 relative each), its update and first
# moment follow g's bf16 residual (2^-8 relative per term). Host readings
# over seeds 2^31 + 11..16: f up to 1.83e-4, |g| 1.78e-4, the update
# 2.07e-4, mu 2.37e-4; the 3-bit reference reads at least 1.68e-6 (f
# moves little: the operands' errors average out in it), 1.01e-2, 6.22e-3
# and 1.01e-2.
STEP_F_TOL = 6e-4
STEP_G_TOL = 1e-3
STEP_X_TOL = 1e-3


def _random_state(seed):
    g = torch.Generator().manual_seed(seed)
    lq = L * Q
    mask = ops_plm._diag_block_mask(L, Q, torch.float32, "cpu")

    def sym(scale):
        a = scale * torch.randn((lq, lq), generator=g)
        return (0.5 * (a + a.T) * mask).float()

    params = {"J": sym(0.05), "h": 0.1 * torch.randn((L, Q), generator=g)}
    mu = {"J": sym(1.0), "h": torch.randn((L, Q), generator=g)}
    nu = {"J": sym(1.0).abs() * mask + 0.5,
          "h": torch.rand((L, Q), generator=g) + 0.5}
    nu["J"] = nu["J"] * mask
    return params, {"count": 5, "mu": mu, "nu": nu}


def _flat(d):
    return torch.cat([d["J"].reshape(-1), d["h"].reshape(-1)]).double()


def _step_gaps(seed, fused, plm_kw):
    """(f, |g|, update, mu) relative gaps of one program Adam step from
    _random_state against the reference's over reference.Plm(**plm_kw)."""
    codes, weights = _data(seed)
    cfg = _cfg(fused, max_iter=1)
    params, state = _random_state(seed)
    codes_d = codes.to(torch.int8)
    oh = ops_plm.build_augmented_onehot(codes_d, Q, torch.bfloat16)
    if fused == "on":
        step = ops_plm._make_fused_adam_step(
            ops_plm.make_plm_nll_vg(L, Q, cfg), L, Q, cfg, torch.bfloat16)
        state["J_aug"] = ops_plm._build_j_aug(
            params, L, Q, torch.bfloat16, ops_plm._augmented_width(L * Q),
            symmetric=True)
    else:
        step = ops_plm._make_adam_step(ops_plm.make_plm_value_and_grad(
            L, Q, cfg, symmetric_params=True), cfg)
    new, new_state, row = step(params, state, codes_d, weights.float(), oh)

    x = _flat(params)
    plm = _plm(codes, weights, **plm_kw)
    value, grad = plm.value_grad(x.to(plm.dtype))
    value, grad = float(value), grad.double()
    x_ref, mu_ref, _ = reference_adam.adam_step(
        x, grad, _flat(state["mu"]), _flat(state["nu"]), state["count"])
    norm = torch.linalg.vector_norm
    gnorm = float(norm(grad))
    moved, moved_ref = _flat(new) - x, x_ref - x
    return (abs(float(row[0]) - value) / abs(value),
            abs(float(row[1]) - gnorm) / gnorm,
            float(norm(moved - moved_ref) / norm(moved_ref)),
            float(norm(_flat(new_state["mu"]) - mu_ref) / norm(mu_ref)))


STEP_TOLS = (STEP_F_TOL, STEP_G_TOL, STEP_X_TOL, STEP_X_TOL)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fused", ["on", "off"])
def test_one_step_from_random_parameters(seed, fused):
    gaps = _step_gaps(seed, fused, {})
    assert all(g <= tol for g, tol in zip(gaps, STEP_TOLS)), gaps


@pytest.mark.parametrize("fused", ["on", "off"])
def test_one_step_fails_against_a_3_bit_reference(fused):
    gaps = _step_gaps(SEEDS[0], fused,
                      {"dtype": torch.float32, "mantissa_bits": 3})
    assert any(g > tol for g, tol in zip(gaps, STEP_TOLS)), gaps


def test_cell_fits_with_the_production_preset(tmp_path, monkeypatch):
    """The couplings protocol with precision: production and solver: adam
    hands run_plm its settings, and run_plm at N = 262144, L = 160 builds
    the PlmConfig that the production cell's runner gives fit_plm, but for
    conv_tol (0 in the benchmark, so that every fit runs its 100 steps)."""
    from evcouplings_torch.couplings import fitter
    from evcouplings_torch.couplings import protocol

    n, l_cols = 262144, 160
    a2m = tmp_path / "in.a2m"
    a2m.write_text(">TARGET/1-{0}\n{1}\n>s1/1-{0}\n{1}\n".format(
        l_cols, "ACDEFGHIKLMNPQRSTVWY" * (l_cols // 20)))

    class Stop(Exception):
        pass

    handed = {}

    def take_kwargs(alignment, ec, model, **kwargs):
        handed.update(kwargs)
        raise Stop

    run_plm = fitter.run_plm
    monkeypatch.setattr(protocol.ct, "run_plm", take_kwargs)
    with pytest.raises(Stop):
        protocol.infer_plmc(
            prefix=str(tmp_path / "c" / "job"), alignment_file=str(a2m),
            focus_mode=True, focus_sequence="TARGET/1-{}".format(l_cols),
            theta=0.8, alphabet=None, segments=None, ignore_gaps=False,
            iterations=100, lambda_h=0.01, lambda_J=0.01,
            lambda_group=None, lambda_J_times_Lq=True, scale_clusters=None,
            cpu=None, reuse_ecs=False, solver="adam",
            precision="production", device="cpu")

    codes = np.zeros((n, l_cols), dtype=np.int8)
    monkeypatch.setattr(fitter, "prepare_alignment",
                        lambda *a, **k: {"codes": codes})
    monkeypatch.setattr(fitter, "num_cluster_members",
                        lambda c, theta: torch.ones(c.shape[0]))
    got = {}

    def take_cfg(fit_codes, fit_weights, q, cfg, **kwargs):
        got["cfg"], got["shape"] = cfg, fit_codes.shape
        raise Stop

    monkeypatch.setattr(fitter, "fit_plm", take_cfg)
    with pytest.raises(Stop):
        run_plm(str(a2m), str(tmp_path / "x.ec"), None, **handed)

    bench = harness.Registry(harness.load_json(
        os.path.join(REPO, "BENCHMARK.json")))
    cell = bench.workload("ras_l160_production.fit256k")
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    runner = bench.runner(traffic["runner"])
    mine = runner.plm_config(config, traffic["iterations_per_fit"], 0.0)
    preset = got["cfg"]
    assert got["shape"] == (traffic["rows"], config["L"]) == (n, l_cols)
    assert (preset.block_size, preset.steps_per_call, preset.solver,
            preset.dtype, preset.precision) == (
        8192, 10, "adam", "bfloat16", "default")
    assert dataclasses.replace(mine, conv_tol=preset.conv_tol) == preset
    assert json.dumps(config["reduced"]) == "[]"
