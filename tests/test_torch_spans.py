"""The port's spans (evcouplings_torch/utils/tracing.span), which the JAX
package does not have: off, a span builds and records nothing; under a
profiler, spans nest with their parent's and root's ids, record an
exception, and agree with the profiler's host events of the same name; and
a tiny run_plm on the host yields the span tree of the couplings stage,
with one plm.value_grad span per evaluation of the fit loop, and the same
files as an untraced run. The LBFGS fit's value+grad graph
(ops/plm._ValueGradGraph) is taken on a CUDA device without a mesh alone:
a fit on the host stays eager and records no replay; the graph's own
bookkeeping is checked here with CUDA's graph and stream stood in for."""

import numpy as np
import pytest
import torch

from evcouplings_torch.couplings.fitter import run_plm
from evcouplings_torch.ops import plm as ops_plm
from evcouplings_torch.utils import tracing

GOLDEN = "tests/data/golden/golden.a2m"
CPU = [torch.profiler.ProfilerActivity.CPU]


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


def _children(records, parent):
    return sorted((r for r in records if r["parent"] == parent["id"]),
                  key=lambda r: r["start_ns"])


def test_span_off_builds_and_records_nothing(monkeypatch):
    def no_range(*args, **kwargs):
        raise AssertionError("record_function built with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        no_range)
    tracing.clear_spans()
    assert not torch._C._autograd._profiler_enabled()
    with tracing.span("fit", rows=3) as rec:
        tracing.add_counts(iterations=1)
        with tracing.span("fit.loop"):
            pass
    assert rec is None
    assert tracing.span("a") is tracing.span("b")
    assert tracing.span_records() == []


def test_spans_nest_under_a_profiler():
    tracing.clear_spans()
    with torch.profiler.profile(activities=CPU) as prof:
        with tracing.span("warm"):    # the profiler's first range is slow
            pass
        with tracing.stage_timer("couplings"):
            with tracing.span("outer", rows=2):
                tracing.add_counts(rows=3, blocks=1)
                with tracing.span("inner"):
                    torch.ones(8).sum()
                with pytest.raises(RuntimeError):
                    with tracing.span("failing"):
                        raise RuntimeError("boom")
        with tracing.span("second"):
            torch.ones(8).sum()
    recs = {r["name"]: r for r in tracing.span_records()}
    stage, outer = recs["couplings"], recs["outer"]
    assert stage["parent"] is None and stage["root"] == stage["id"]
    assert outer["parent"] == stage["id"] and outer["root"] == stage["id"]
    for name in ("inner", "failing"):
        assert recs[name]["parent"] == outer["id"]
        assert recs[name]["root"] == stage["id"]
    assert recs["second"]["parent"] is None
    assert recs["second"]["root"] == recs["second"]["id"]
    assert recs["failing"]["error"]
    assert not any(recs[n]["error"] for n in ("inner", "outer", "second"))
    assert outer["counts"] == {"rows": 5, "blocks": 1}
    # the pipeline's table keeps stage_timer's rows alone
    assert list(tracing.get_spans().scope) == ["couplings"]
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e)
    for name, rec in recs.items():
        if name == "warm":
            continue
        (e,) = events[name]
        assert abs(e.start_ns() - rec["start_ns"]) < 1e6, name
        assert abs(e.start_ns() + e.duration_ns() - rec["end_ns"]) < 1e6


def _counting_value_and_grad(monkeypatch):
    """Count the calls of every value+grad function fit_plm builds."""
    calls = []
    make = ops_plm.make_plm_value_and_grad

    def counting(*args, **kwargs):
        vg = make(*args, **kwargs)

        def counted(*a, **k):
            calls.append(1)
            return vg(*a, **k)

        return counted

    monkeypatch.setattr(ops_plm, "make_plm_value_and_grad", counting)
    return calls


def _run(tmp_path, tag, **kw):
    ec, model = tmp_path / (tag + ".ec"), tmp_path / (tag + ".model")
    res = run_plm(GOLDEN, str(ec), str(model), focus_seq="TARGET_SEQ/11-28",
                  iterations=6, device="cpu", **kw)
    return res, ec.read_bytes(), model.read_bytes()


def test_run_plm_span_tree(tmp_path, monkeypatch):
    _, ec_plain, model_plain = _run(tmp_path, "plain")
    calls = _counting_value_and_grad(monkeypatch)
    tracing.clear_spans()
    with torch.profiler.profile(activities=CPU):
        res, ec, model = _run(tmp_path, "traced")
    # tracing changes no result
    assert ec == ec_plain and model == model_plain

    records = tracing.span_records()
    assert not any(r["error"] for r in records)
    (stage,) = [r for r in records if r["parent"] is None]
    assert stage["name"] == "stage"
    assert all(r["root"] == stage["id"] for r in records)
    assert [r["name"] for r in _children(records, stage)] == [
        "stage.read", "stage.reweight", "fit", "stage.score", "stage.write"]
    (fit,) = _by_name(records)["fit"]
    assert [r["name"] for r in _children(records, fit)] == [
        "fit.setup", "fit.loop", "fit.finish"]
    setup, loop, _ = _children(records, fit)
    assert fit["counts"] == {"iterations": len(res.iteration_table)}
    by_name = _by_name(records)
    evals = by_name["plm.value_grad"]
    assert [r["parent"] for r in evals].count(setup["id"]) == 1
    in_loop = [r for r in evals if r["parent"] == loop["id"]]
    assert len(in_loop) + 1 == len(evals) == len(calls)
    assert len(in_loop) >= len(res.iteration_table)
    assert all(r["counts"] == {} for r in evals)
    syncs = [r for r in records if r["name"].startswith("fit.sync.")]
    assert syncs and all(r["parent"] == loop["id"] for r in syncs)
    # every child lies inside its parent
    by_id = {r["id"]: r for r in records}
    for r in records:
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= p["end_ns"]


def test_fit_plm_is_a_root():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=(40, 6))
    tracing.clear_spans()
    with torch.profiler.profile(activities=CPU):
        res = ops_plm.fit_plm(codes, np.ones(40), 4,
                              ops_plm.PlmConfig(max_iter=3, block_size=16),
                              device="cpu")
    roots = [r for r in tracing.span_records() if r["parent"] is None]
    assert [r["name"] for r in roots] == ["fit"]
    assert roots[0]["counts"] == {"iterations": len(res.iteration_table)}


class _Mesh:
    """Stands in for a mesh: the rule asks only whether there is one."""


@pytest.mark.parametrize("device,mesh,replays", [
    ("cpu", None, False), ("cpu", _Mesh(), False),
    ("cuda", _Mesh(), False), ("cuda:0", _Mesh(), False),
    ("cuda", None, True), ("cuda:0", None, True)])
def test_value_grad_graph_rule(device, mesh, replays):
    assert ops_plm._replays_value_grad(torch.device(device), mesh) is replays


def _fit_problem(seed=5, n=60, L=6, q=4):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, q, size=(n, L))
    codes[::5, 2] = -1
    return codes, rng.random(n) + 0.5, q


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("layout", ["carried", "two_phase"])
def test_host_fit_takes_no_graph(monkeypatch, precision, layout):
    """A traced LBFGS fit on the host captures nothing: one plm.value_grad
    span per evaluation, none of them counted as a replay, and no capture
    span."""
    def no_graph(*args):
        raise AssertionError("a host fit built a value+grad graph")

    monkeypatch.setattr(ops_plm, "_ValueGradGraph", no_graph)
    calls = _counting_value_and_grad(monkeypatch)
    codes, w, q = _fit_problem()
    cfg = ops_plm.PlmConfig(max_iter=4, block_size=16, precision=precision,
                            grad_layout=layout, conv_tol=0.0)
    tracing.clear_spans()
    with torch.profiler.profile(activities=CPU):
        res = ops_plm.fit_plm(codes, w, q, cfg, device="cpu")
    records = tracing.span_records()
    by_name = _by_name(records)
    assert "plm.graph_capture" not in by_name
    evals = by_name["plm.value_grad"]
    assert len(evals) == len(calls) > len(res.iteration_table)
    assert all(r["counts"] == {} for r in evals)


class _FakeGraph:
    """torch.cuda.CUDAGraph stood in for on the host: capture records
    nothing, a replay counts itself."""

    def __init__(self):
        self.log = []

    def capture_begin(self, capture_error_mode="global"):
        self.log.append(("begin", capture_error_mode))

    def capture_end(self):
        self.log.append(("end",))

    def replay(self):
        self.log.append(("replay",))

    def reset(self):
        self.log.append(("reset",))


class _FakeStream:
    def wait_stream(self, other):
        pass


def test_value_grad_graph_bookkeeping(monkeypatch):
    """The graph's wrapper, with CUDA's graph and streams stood in for on
    the host: the capture's K5 launches are taken back and added again per
    replay, each call copies its x into the static buffer, replays once
    inside one plm.value_grad span counted as a replay, and returns copies
    of the static outputs; a call with other rows raises; release() resets
    the graph and drops the buffers."""
    import contextlib

    from evcouplings_torch.kernels.limb_mm import limb_mm

    graphs = []

    def new_graph():
        graphs.append(_FakeGraph())
        return graphs[-1]

    monkeypatch.setattr(torch.cuda, "CUDAGraph", new_graph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(ops_plm, "_CAPTURE_STREAMS", {})

    def vg_flat(x, codes, weights):
        limb_mm.launches += 3
        return (x * weights).sum(), x * codes

    rows = (torch.full((4,), 2.0), torch.full((4,), 0.5))
    x0 = torch.zeros(4)
    before = limb_mm.launches
    g = ops_plm._ValueGradGraph(vg_flat, x0, rows)
    (fake,) = graphs
    assert fake.log == [("begin", "thread_local"), ("end",)]
    assert limb_mm.launches == before and g.k5_launches == 3
    assert g.x is not x0
    x1 = torch.arange(4.0)
    tracing.clear_spans()
    with torch.profiler.profile(activities=CPU):
        value, grad = g(x1, *rows)
    (rec,) = tracing.span_records()
    assert rec["name"] == "plm.value_grad"
    assert rec["counts"] == {"replayed": 1}
    assert fake.log[-1] == ("replay",)
    assert limb_mm.launches == before + 3
    assert torch.equal(g.x, x1)
    # copies of the static outputs, which the next replay overwrites
    assert value is not g.value and grad is not g.grad
    assert torch.equal(value, g.value) and torch.equal(grad, g.grad)
    with pytest.raises(ValueError):
        g(x1, rows[0], rows[1].clone())
    g.release()
    assert fake.log[-1] == ("reset",)
    assert g.x is None and g.value is None and g.grad is None
