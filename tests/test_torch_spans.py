"""The port's spans (evcouplings_torch/utils/tracing.span), which the JAX
package does not have: off, a span builds and records nothing; under a
profiler, spans nest with their parent's and root's ids, record an
exception, and agree with the profiler's host events of the same name; and
a tiny run_plm on the host yields the span tree of the couplings stage,
with one plm.value_grad span per evaluation of the fit loop, and the same
files as an untraced run. The LBFGS fit's value+grad graph
(ops/plm._ValueGradGraph) is taken on a CUDA device without a mesh alone:
a fit on the host stays eager and records no replay; the graph's own
bookkeeping is checked here with CUDA's graph and stream stood in for. A
production (Adam) fit records its steps' epilogues and its one-hot's
build, and the benchmark's readers of them read made-up records."""

import os
import sys

import numpy as np
import pytest
import torch

from evcouplings_torch.couplings.fitter import run_plm
from evcouplings_torch.ops import plm as ops_plm
from evcouplings_torch.utils import tracing

GOLDEN = "tests/data/golden/golden.a2m"
# the benchmark's readers (bench_port/) sit at the repository's root
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
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
    the host: the capture's K6 launches are taken back and added again per
    replay, each call copies its x into the static buffer, replays once
    inside one plm.value_grad span counted as a replay (and as fused,
    since the capture took K6), and returns copies
    of the static outputs; a call with other rows raises; release() resets
    the graph and drops the buffers."""
    import contextlib

    from evcouplings_torch.kernels.block_epilogue import block_epilogue

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
        block_epilogue.launches += 3
        return (x * weights).sum(), x * codes

    rows = (torch.full((4,), 2.0), torch.full((4,), 0.5))
    x0 = torch.zeros(4)
    before = block_epilogue.launches
    g = ops_plm._ValueGradGraph(vg_flat, x0, rows)
    (fake,) = graphs
    assert fake.log == [("begin", "thread_local"), ("end",)]
    assert block_epilogue.launches == before and g.k6_launches == 3
    assert g.x is not x0
    x1 = torch.arange(4.0)
    tracing.clear_spans()
    with torch.profiler.profile(activities=CPU):
        value, grad = g(x1, *rows)
    (rec,) = tracing.span_records()
    assert rec["name"] == "plm.value_grad"
    assert rec["counts"] == {"replayed": 1, "epilogue_fused": 1}
    assert fake.log[-1] == ("replay",)
    assert block_epilogue.launches == before + 3
    assert torch.equal(g.x, x1)
    # copies of the static outputs, which the next replay overwrites
    assert value is not g.value and grad is not g.grad
    assert torch.equal(value, g.value) and torch.equal(grad, g.grad)
    with pytest.raises(ValueError):
        g(x1, rows[0], rows[1].clone())
    g.release()
    assert fake.log[-1] == ("reset",)
    assert g.x is None and g.value is None and g.grad is None


def _adam_cfg(fused, max_iter=6):
    return ops_plm.PlmConfig(
        max_iter=max_iter, block_size=2048, dtype="bfloat16",
        precision="default", solver="adam", steps_per_call=3,
        conv_tol=0.0, fused_update=fused)


def _adam_problem():
    codes, w, q = _fit_problem(n=2048)
    return codes, w, q


@pytest.mark.parametrize("fused", ["on", "off"])
def test_adam_fit_spans(fused):
    """A traced production fit on the host (bf16, the two-phase layout):
    one adam.update span per step inside fit.loop, with the count `fused`
    on the fused route (K2's plain version here) and none on the unfused
    one, one plm.value_grad span per step beside it, and the one-hot's
    build as fit.onehot inside fit.setup."""
    codes, w, q = _adam_problem()
    cfg = _adam_cfg(fused)
    tracing.clear_spans()
    with torch.profiler.profile(activities=CPU):
        res = ops_plm.fit_plm(codes, w, q, cfg, device="cpu")
    records = tracing.span_records()
    by_id = {r["id"]: r for r in records}
    by_name = _by_name(records)
    (setup,), (loop,) = by_name["fit.setup"], by_name["fit.loop"]
    (onehot,) = by_name["fit.onehot"]
    assert onehot["parent"] == setup["id"]
    updates = by_name["adam.update"]
    assert len(updates) == len(res.iteration_table) == cfg.max_iter
    assert all(by_id[r["parent"]]["id"] == loop["id"] for r in updates)
    want = {"fused": 1} if fused == "on" else {}
    assert all(r["counts"] == want for r in updates)
    in_loop = [r for r in by_name["plm.value_grad"]
               if r["parent"] == loop["id"]]
    assert len(in_loop) == cfg.max_iter


@pytest.mark.parametrize("fused", ["on", "off"])
def test_adam_fit_traced_is_bitwise_untraced(fused):
    codes, w, q = _adam_problem()
    cfg = _adam_cfg(fused)
    plain = ops_plm.fit_plm(codes, w, q, cfg, device="cpu")
    with torch.profiler.profile(activities=CPU):
        traced = ops_plm.fit_plm(codes, w, q, cfg, device="cpu")
    assert np.array_equal(plain.J_ij, traced.J_ij)
    assert np.array_equal(plain.h_i, traced.h_i)
    assert plain.final_loss == traced.final_loss
    for a, b in zip(plain.iteration_table, traced.iteration_table):
        assert [a[k] for k in ("fx", "gnorm", "xnorm")] == [
            b[k] for k in ("fx", "gnorm", "xnorm")]


def test_annotate_is_a_span():
    tracing.clear_spans()
    with torch.profiler.profile(activities=CPU):
        with tracing.annotate("region"):
            pass
    (rec,) = tracing.span_records()
    assert rec["name"] == "region" and rec["parent"] is None


class _Event:
    """A profiler event of a made-up trace."""

    def __init__(self, name, start, duration, device=True):
        self._name, self._start, self._duration = name, start, duration
        self._device = (torch.autograd.DeviceType.CUDA if device
                        else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._duration

    def device_type(self):
        return self._device


class _Trace:
    def __init__(self, events):
        self.events = events

    def stop(self):
        pass

    def summary(self, lo_ns, hi_ns):
        return {"busy_s": 1.0, "window_s": 2.0}


def test_production_readers_arithmetic(monkeypatch):
    """The production cell's K2 roofline and fused share, read from a
    made-up trace and made-up span records: K2's launches and device time
    are summed inside the window alone (clipped at its ends; host events,
    other kernels and K3 left out), and the share counts the fused
    adam.update spans of the counted fits' loops."""
    import types

    from bench_port import adam_readers, harness
    from bench_port.runners import fit_adam

    win = fit_adam.K2Window.__new__(fit_adam.K2Window)
    win.device, win.cuda, win.seconds = torch.device("cpu"), False, 1.0
    win.t0_ns, win.t_end_ns, win.t_end, win.t0 = 1000, 5000, 3.0, 1.0
    k2 = adam_readers.K2_KERNEL
    win.tracer = _Trace([
        _Event(k2, 500, 1000),              # clipped to 500 ns
        _Event(k2, 2000, 1000),
        _Event(k2 + "_0d1d2d", 4500, 1000),  # clipped to 500 ns
        _Event(k2, 6000, 1000),             # after the window
        _Event("_adam_update_presym_kernel", 2000, 1000),
        _Event("sm90_xmma_gemm", 2000, 1000),
        _Event(k2, 2000, 1000, device=False)])
    window, trace, _ = win.close(1, "fit")
    assert (window, trace["busy_s"]) == (2.0, 1.0)
    assert win.k2_launches == 3 and win.k2_device_s == 2000 / 1e9

    cfg = {"L": 160, "q": 21}
    assert adam_readers.k2_least_bytes(160, 21) == 3360 ** 2 * 30
    peaks = {"hbm_bytes_per_s": 3.35e12}
    ctx = types.SimpleNamespace(
        cell=types.SimpleNamespace(config=cfg, control=False),
        outcome=harness.Outcome(e2e={}, counters={
            "k2_device_s": 0.2, "k2_launches": 1000, "fit_s": [1.0, 1.0]},
            attempted=2, failed=0, memory_peak_bytes=0),
        peaks=peaks)
    want = 100.0 * 1000 * 3360 ** 2 * 30 / 3.35e12 / 0.2
    assert adam_readers.k2_roofline(ctx) == pytest.approx(want)
    assert adam_readers.k2_roofline(types.SimpleNamespace(
        cell=ctx.cell, outcome=harness.Outcome({}, {}, 0, 0, 0),
        peaks=peaks)) is None

    def rec(id_, name, parent, root, counts=None, start=0):
        return {"id": id_, "name": name, "parent": parent, "root": root,
                "start_ns": start, "end_ns": start + 1, "error": False,
                "counts": counts or {}}

    records = [rec(1, "fit", None, 1, start=0), rec(2, "fit.loop", 1, 1),
               rec(3, "adam.update", 2, 1, {"fused": 1}),
               rec(4, "adam.update", 2, 1, {"fused": 1}),
               rec(5, "fit", None, 5, start=10), rec(6, "fit.loop", 5, 5),
               rec(7, "adam.update", 6, 5, {"fused": 1}),
               rec(8, "adam.update", 6, 5),
               rec(9, "fit.finish", 5, 5),
               rec(10, "adam.update", 9, 5),     # outside the loop
               rec(11, "fit", None, 11, start=20),  # not counted
               rec(12, "fit.loop", 11, 11),
               rec(13, "adam.update", 12, 11)]
    monkeypatch.setattr(tracing, "span_records", lambda: records)
    assert adam_readers.adam_fused_share(ctx) == pytest.approx(75.0)
    monkeypatch.setattr(tracing, "span_records",
                        lambda: [r for r in records
                                 if r["name"] != "adam.update"])
    assert adam_readers.adam_fused_share(ctx) is None
