"""The comparison that decides `correct` fails what it must, on the host at
a tiny size, through the whole run: each configuration's control put in
the program's place, and each fault planted in the program underneath.
The sound program passes on the same seeds. The card's route for the
limbs of "high"/"default" is let onto the CPU, where the program's
products are otherwise exact float32."""

import pytest
import torch

from bench_port import generate, harness, judge, reference
from bench_port.tests import faults
from bench_port.tests.tiny import STAGE_LIMITS, tiny_registry

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)
PARITY = ("highest", None)
BALANCED = ("high", {"kind": "program", "matmul_precision": "default"})


def _run(tmp_path, monkeypatch, cell, seed, mode, control=False):
    precision, ctl = mode
    if precision != "highest":
        from evcouplings_torch.ops import plm

        monkeypatch.setattr(plm, "_takes_limbs", lambda dtype, limbs, device:
                            limbs is not None and dtype == torch.float32)
    reg = tiny_registry(tmp_path, precision, ctl)
    result, checks = harness.run_cell(reg, cell, seed, 0.5, False,
                                      torch.device("cpu"), control=control)
    return checks


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell,mode", [
    ("tiny.fit", PARITY), ("tiny.fit", BALANCED), ("tiny.stage", BALANCED)])
def test_sound_program_is_correct(tmp_path, monkeypatch, cell, mode, seed):
    checks = _run(tmp_path, monkeypatch, cell, seed, mode)
    assert checks.ok, checks.rows


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell,mode", [
    ("tiny.fit", PARITY), ("tiny.fit", BALANCED), ("tiny.stage", BALANCED)])
def test_control_is_not_correct(tmp_path, monkeypatch, cell, mode, seed):
    checks = _run(tmp_path, monkeypatch, cell, seed, mode, control=True)
    assert not checks.ok, checks.rows


@pytest.mark.parametrize("fault,cell", [
    ("frozen_step", "tiny.fit"), ("early_stop", "tiny.fit"),
    ("half_batch", "tiny.fit"), ("altered_couplings", "tiny.fit"),
    ("frozen_step", "tiny.stage"), ("early_stop", "tiny.stage"),
    ("half_batch", "tiny.stage"), ("altered_couplings", "tiny.stage"),
    ("altered_score", "tiny.stage")])
def test_planted_fault_is_not_correct(tmp_path, monkeypatch, fault, cell):
    faults.FAULTS[fault](monkeypatch)
    checks = _run(tmp_path, monkeypatch, cell, SEEDS[0], PARITY)
    assert not checks.ok, checks.rows


@pytest.mark.parametrize("seed", SEEDS)
def test_stage_gnorm_at_x_separates_sound_runs_from_a_frozen_step(
        tmp_path, monkeypatch, seed):
    """In the stage, whose fits are given a conv_tol, gnorm_at_x reads below
    its limit in every family of the sound program, and above it in a
    family of the frozen step."""
    limit = STAGE_LIMITS["gnorm_at_x"]

    def readings(checks):
        return [v for n, v, _, _ in checks.rows
                if n.endswith(".gnorm_at_x")]

    sound = readings(_run(tmp_path / "sound", monkeypatch, "tiny.stage",
                          seed, BALANCED))
    faults.frozen_step(monkeypatch)
    frozen = readings(_run(tmp_path / "frozen", monkeypatch, "tiny.stage",
                           seed, PARITY))
    assert sound and max(sound) < limit, sound
    assert max(frozen) > limit, frozen


@pytest.mark.parametrize("conv_tol", [0.0, 1e-5])
def test_gnorm_at_x_scale_follows_how_the_fit_stops(conv_tol):
    """A last |g| 10% off the reference's at the returned x reads 0.1 where
    the fit runs its iterations (conv_tol 0), and 0.1 |g(x)| / |g(0)|
    where it is given a conv_tol, with the relative gap in
    gnorm_rel_at_x."""
    codes = generate.synthetic_codes(
        generate.generator(2 ** 31 + 17, torch.device("cpu")), 120, 6, 21,
        families=6, mutate=0.2, gap_rows=0.1)
    w = 1.0 / reference.cluster_counts(codes, 0.8, 21).double()
    plm = reference.Plm(codes, w, 21, 0.01, 0.01 * 20 * 5, block=64)
    rows, x = judge.reference_fit(plm, 30, conv_tol)
    rows[-1] = (rows[-1][0], 1.1 * rows[-1][1], rows[-1][2])
    checks = harness.Checks({"gnorm_at_x": 1.0, "gnorm_rel_at_x": 1.0})
    judge.judge_fit(checks, {"reference": {"lbfgs_dot": "exact"}}, plm,
                    (rows, x), 30, conv_tol)
    got = {n: v for n, v, _, _ in checks.rows}
    g_x, g_0 = (float(torch.linalg.vector_norm(plm.value_grad(v)[1]))
                for v in (x, torch.zeros_like(x)))
    if conv_tol:
        assert got["gnorm_rel_at_x"] == pytest.approx(0.1, rel=1e-9)
        assert got["gnorm_at_x"] == pytest.approx(0.1 * g_x / g_0,
                                                  rel=1e-9)
        assert got["gnorm_at_x"] < 1e-3 * got["gnorm_rel_at_x"]
    else:
        assert set(got) == {"gnorm_at_x"}
        assert got["gnorm_at_x"] == pytest.approx(0.1, rel=1e-9)
