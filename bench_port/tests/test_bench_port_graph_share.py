"""The reader of the fits' CUDA-graph replays (graph_spans.vg_graph_share):
on span records made by hand, as a fit on the card records them, and
through the whole harness at a tiny size on the host, where a fit takes no
graph and the reader reads nothing."""

import itertools
from types import SimpleNamespace

import pytest
import torch

from bench_port import graph_spans, harness
from bench_port.tests.tiny import tiny_registry
from evcouplings_torch.utils import tracing

SEED = 2 ** 31 + 311


def _graph_metrics(reg, cell):
    """The cell's metrics that graph_spans reads."""
    return [m["name"] for m in reg.per_layer(cell)
            if reg.reader(m["name"]).read.__module__
            == "bench_port.graph_spans"]


@pytest.mark.parametrize("cell", ["tiny.fit", "tiny.stage"])
def test_a_fit_on_the_host_reads_no_graph_share(tmp_path, cell):
    """Each tiny cell lists one vg_graph_share metric, and a traced run on
    the host leaves it out of the line: the fit captured no graph."""
    reg = tiny_registry(tmp_path)
    names = _graph_metrics(reg, cell)
    assert len(names) == (2 if cell == "tiny.fit" else 1)
    tracing.clear_spans()
    result, checks = harness.run_cell(reg, cell, SEED, 3.0, True,
                                      torch.device("cpu"))
    assert checks.ok, result["checks"]
    assert not set(names) & set(result["metrics"])


def _fit_records(ids, replayed, capture=True, root=None):
    """Span records of one fit as the program records them: fit.setup with
    its eager first evaluation (and, with `capture`, plm.graph_capture
    over the captured one), then fit.loop with one plm.value_grad per
    entry of `replayed` (its count where true). `root`: the id of an
    enclosing stage span."""
    recs = []

    def add(name, parent, counts=None):
        i = next(ids)
        top = root if root is not None else (parent and recs[0]["id"])
        recs.append({"name": name, "id": i, "parent": parent,
                     "root": top or i, "start_ns": 10 * i,
                     "end_ns": 10 * i + 5, "error": False,
                     "counts": counts or {}})
        return i

    fit = add("fit", root, {"iterations": len(replayed)})
    setup = add("fit.setup", fit)
    add("plm.value_grad", setup)
    if capture:
        add("plm.value_grad", add("plm.graph_capture", setup))
    loop = add("fit.loop", fit)
    for r in replayed:
        add("plm.value_grad", loop, {"replayed": 1} if r else None)
    add("fit.sync.trial", loop)
    add("fit.finish", fit)
    return recs


@pytest.mark.parametrize("fits,share", [
    ([(True, [1, 1, 1]), (True, [1, 1])], 100.0),
    ([(True, [1, 1, 0, 1]), (False, [0, 0])], 50.0),
    ([(False, [0, 0, 0]), (False, [0])], None),
])
@pytest.mark.parametrize("unit", ["fit", "stage"])
def test_vg_graph_share_on_synthetic_spans(monkeypatch, fits, share, unit):
    """The share of the loops' evaluations that replayed, over the counted
    fits or families: evaluations in fit.setup (the eager first one, the
    one under the capture) do not count; no capture in any counted unit
    reads nothing (a program without the graph, a fit on the host)."""
    ids = itertools.count(1)
    records = []
    for capture, replayed in fits:
        if unit == "stage":
            stage = next(ids)
            records += [{"name": "stage", "id": stage, "parent": None,
                         "root": stage, "start_ns": 0, "end_ns": 10 ** 9,
                         "error": False, "counts": {}}] + _fit_records(
                             ids, replayed, capture, root=stage)
        else:
            records += _fit_records(ids, replayed, capture)
    # a fit beyond those counted, which its share may not enter
    records += _fit_records(ids, [0, 0, 0, 0, 0, 0], True)
    monkeypatch.setattr(tracing, "span_records", lambda: records)
    counters = ({"fit_s": [1.0] * len(fits)} if unit == "fit"
                else {"families": len(fits)})
    ctx = SimpleNamespace(cell=SimpleNamespace(control=False),
                          outcome=SimpleNamespace(counters=counters))
    assert graph_spans.vg_graph_share(ctx) == share
    ctx.cell.control = True
    assert graph_spans.vg_graph_share(ctx) is None
    monkeypatch.setattr(tracing, "span_records", lambda: [])
    ctx.cell.control = False
    assert graph_spans.vg_graph_share(ctx) is None
