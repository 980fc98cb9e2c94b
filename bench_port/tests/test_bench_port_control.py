"""The comparison that decides `correct` fails what it must, on the host at
a tiny size, through the whole run: each configuration's control put in
the program's place, and each fault planted in the program underneath.
The sound program passes on the same seeds. The card's route for the
limbs of "high"/"default" is let onto the CPU, where the program's
products are otherwise exact float32."""

import pytest
import torch

from bench_port import harness
from bench_port.tests import faults
from bench_port.tests.tiny import tiny_registry

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
