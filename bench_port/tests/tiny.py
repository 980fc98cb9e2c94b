"""A tiny copy of the benchmark for CPU tests: the real runners and
readers, with configurations and traffic small enough for the host."""

import json
import shutil
from pathlib import Path

from bench_port import harness

BENCH = Path(__file__).resolve().parents[1]

# limits of the tiny cells, from readings on the host (six program seeds,
# three of each control and fault): the program's largest reading below,
# the controls' and faults' smallest above (test_bench_port_control.py).
FIT_LIMITS = {"counts_mismatch": 0, "iterations_mismatch": 0,
              "fx_path": 1e-4, "fx_at_x": 1e-6, "gnorm_at_x": 2e-4,
              "x_gap": 3e-5}
STAGE_LIMITS = {"weights_mismatch": 0, "neff_mismatch": 0, "freq_gap": 1e-6,
                "fx_final_gap": 4e-4, "fx_path": 4e-4, "fx_at_x": 1e-6,
                "gnorm_at_x": 2e-6, "x_gap": 1e-4, "ec_gap": 1e-6,
                "ec_rank_inversions": 0}


def tiny_registry(tmp, precision="highest", control=None, limits=None):
    """A Registry over `tmp` with the cells tiny.fit and tiny.stage."""
    tmp = Path(tmp)
    for d in ("runners", "metrics"):
        shutil.copytree(BENCH / d, tmp / d)
    for d in ("configs", "traffic", "limits"):
        (tmp / d).mkdir()
    config = json.loads((BENCH / "configs" / "ras_l160_parity.json")
                        .read_text())
    config.update(name="tiny", L=12, matmul_precision=precision,
                  control=control or config["control"])
    config["fit"]["block_size"] = 64
    (tmp / "configs" / "tiny.json").write_text(json.dumps(config))
    (tmp / "traffic" / "fit.json").write_text(json.dumps({
        "runner": "fit", "rows": 300, "families": 16, "mutate": 0.15,
        "gap_rows": 0.1, "iterations_per_fit": 5, "warmup_iterations": 1,
        "trace_seconds": 3}))
    (tmp / "traffic" / "stage.json").write_text(json.dumps({
        "runner": "stage", "depths": [60, 150], "inserts": 3,
        "families": 8, "mutate": 0.15, "gap_rows": 0.1, "iterations": 6,
        "conv_tol": 1e-5, "warmup_iterations": 1, "trace_seconds": 3}))
    for cell, lim in (("tiny.fit", limits or FIT_LIMITS),
                      ("tiny.stage", limits or STAGE_LIMITS)):
        (tmp / "limits" / (cell + ".json")).write_text(
            json.dumps({"limits": lim}))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    bench["workloads"] = [
        {"name": "tiny.fit", "config": "tiny", "traffic": "fit", "chips": 1},
        {"name": "tiny.stage", "config": "tiny", "traffic": "stage",
         "chips": 1}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.stage" if "stage" in w else "tiny.fit"
                              for w in m["workloads"][:1]]
    return harness.Registry(bench, tmp)
