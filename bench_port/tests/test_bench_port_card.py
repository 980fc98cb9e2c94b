"""A cell run on the card through the command, as the benchmark is run:
one short run of each fit cell, correct, with the result line's keys.
Skips without a CUDA device (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from bench_port.tests.tiny import BENCH


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["ras_l160_parity.fit64k",
                                  "ras_l160_balanced.fit64k"])
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 77), "--seconds", "10", "--trace", "0"],
        cwd=BENCH.parent, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu"
