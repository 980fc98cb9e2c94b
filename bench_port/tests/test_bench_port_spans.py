"""The readers of the program's spans (program_spans.py) on the host, through
the whole harness at a tiny size: every one reads a finite value in a
traced run of its tiny cell, and none reads anything in a control run or
where the program recorded no spans."""

import math

import pytest
import torch

from bench_port import harness
from bench_port.tests.tiny import tiny_registry
from evcouplings_torch.utils import tracing

SEED = 2 ** 31 + 311


def _span_metrics(reg, cell):
    """The cell's metrics whose readers read the program's spans."""
    return [m["name"] for m in reg.per_layer(cell)
            if reg.reader(m["name"]).read.__module__
            == "bench_port.program_spans"]


@pytest.mark.parametrize("cell,n", [("tiny.fit", 9), ("tiny.stage", 7)])
def test_every_reader_reads_a_traced_run(tmp_path, cell, n):
    reg = tiny_registry(tmp_path)
    names = _span_metrics(reg, cell)
    assert len(names) == n
    tracing.clear_spans()
    result, checks = harness.run_cell(reg, cell, SEED, 3.0, True,
                                      torch.device("cpu"))
    assert checks.ok, result["checks"]
    for name in names:
        value = result["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    got = result["metrics"]
    if cell == "tiny.fit":
        # every iteration takes one evaluation at least
        for k in ("lbfgs_evals_per_iter.fit",
                  "lbfgs_evals_per_iter.fit_balanced"):
            assert got[k]["value"] >= 1
        assert got["fit_host_wait.fit"]["value"] < 100
    else:
        # the parts of a family lie inside the harness's span around it,
        # outside the fit loop's own time (two clocks: 5% of room)
        parts = sum(got[k]["value"] for k in (
            "stage_read_s", "stage_reweight_s", "stage_score_s",
            "stage_write_s", "fit_edges_s.stage"))
        assert parts < got["stage_outside_fit_s"]["value"] * 1.05


@pytest.mark.parametrize("cell", ["tiny.fit", "tiny.stage"])
def test_no_reading_without_the_program_s_spans(tmp_path, monkeypatch,
                                                 cell):
    """A traced control run reads nothing, nor does a traced run of a
    program whose registry stays empty (as a program without spans)."""
    reg = tiny_registry(tmp_path, control={"kind": "program",
                                           "matmul_precision": "default"})
    names = _span_metrics(reg, cell)
    tracing.clear_spans()
    result, _ = harness.run_cell(reg, cell, SEED, 3.0, True,
                                 torch.device("cpu"), control=True)
    assert not set(names) & set(result["metrics"])
    monkeypatch.setattr(tracing, "span_records", lambda: [])
    result, _ = harness.run_cell(reg, cell, SEED, 3.0, True,
                                 torch.device("cpu"))
    assert not set(names) & set(result["metrics"])
