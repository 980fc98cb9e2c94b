"""BENCHMARK.json against the benchmark's contract, and every entry found
by name: a configuration, a traffic mix, a metric and a cell added as
files alone, in a temporary directory, run through the real harness."""

import json
import re

import pytest
import torch

from bench_port import harness
from bench_port.tests.tiny import BENCH, tiny_registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def test_benchmark_json_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "bench_port/run.py"]
    assert bench["paths"] == ["bench_port"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert set(m["workloads"]) <= cells
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads"])
def test_every_entry_has_its_files(bench, kind):
    reg = harness.Registry(bench)
    for e in bench[kind]:
        if kind == "configs":
            assert (BENCH.parent / e["file"]).is_file()
            config = reg.config(e["name"])
            assert config["name"] == e["name"]
            assert config["reduced"] == e["reduced"]
            continue
        traffic = reg.traffic(e["traffic"])
        assert (BENCH / "runners" / (traffic["runner"] + ".py")).is_file()
        assert reg.limits(e["name"])
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric, and each of its readers is found by name
        e2e = {m["name"] for m in reg.end_to_end(e["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = reg.per_layer(e["name"])
        assert layers
        for m in layers:
            assert callable(reg.reader(m["name"]).read)


def test_added_files_alone_make_a_new_cell(tmp_path):
    """A new configuration, traffic mix, limits and per-layer metric,
    added as files in a copy of the benchmark, run through the harness."""
    reg = tiny_registry(tmp_path)
    (tmp_path / "metrics" / "rows_seen.py").write_text(
        "def read(ctx):\n"
        "    return float(ctx.outcome.counters['rows'])\n")
    reg.benchmark["per_layer"].append(
        {"name": "rows_seen", "unit": "rows", "better": "higher",
         "source": "program_counter", "layer": "test",
         "moves": "fit_seq_sites_per_s", "workloads": ["tiny.fit"]})
    result, checks = harness.run_cell(reg, "tiny.fit", 7, 3.0, True,
                                      torch.device("cpu"))
    assert checks.ok, result["checks"]
    assert result["metrics"]["rows_seen"] == {"value": 300.0,
                                              "unit": "rows"}
    assert result["attempted"] >= 1
    assert list(result)[-1] == "checks"


def test_per_layer_metrics_are_chosen_by_cells_or_by_what_they_move():
    """A per-layer metric that lists cells is read in those; one that lists
    none is read in every cell that reports the end-to-end metric it
    moves."""
    reg = harness.Registry({
        "end_to_end": [
            {"name": "rate", "workloads": ["a"]},
            {"name": "rate.b", "workloads": ["b"]},
            {"name": "setup_s"}],
        "per_layer": [
            {"name": "listed", "moves": "rate", "workloads": ["b"]},
            {"name": "by_moves", "moves": "rate"},
            {"name": "by_moves.b", "moves": "rate.b"}]})
    assert [m["name"] for m in reg.per_layer("a")] == ["by_moves"]
    assert [m["name"] for m in reg.per_layer("b")] == ["listed",
                                                       "by_moves.b"]
