"""The harness's look for JAX, and a run without a card."""

import json
import subprocess
import sys
import types

import pytest

from bench_port import harness
from bench_port.tests.tiny import BENCH


def test_forbidden_names_compare_whole_top_level_names():
    mods = ["jaxtyping", "evcouplings_torch.ops", "evcouplings_tpux",
            "numpy"]
    assert harness.forbidden_loaded(mods) == []
    assert harness.forbidden_loaded(mods + ["jax.numpy", "flax",
                                            "evcouplings_tpu.ops"]) == [
        "evcouplings_tpu", "flax", "jax"]


def test_check_raises_once_jaxlib_is_loaded(monkeypatch):
    harness.check_no_jax("now,")
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    with pytest.raises(harness.ForbiddenModule, match="jaxlib"):
        harness.check_no_jax("now,")


def test_harness_and_program_load_no_jax():
    code = ("import sys; sys.path.insert(0, {root!r});"
            "import bench_port.run, bench_port.reference, bench_port.judge;"
            "from bench_port.runners import fit, stage;"
            "import evcouplings_torch.couplings.fitter;"
            "from bench_port import harness;"
            "print(harness.forbidden_loaded())").format(root=str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "ras_l160_parity.fit64k", "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"], cwd=BENCH.parent, capture_output=True,
        text=True, timeout=300, env={"CUDA_VISIBLE_DEVICES": "",
                                     "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
