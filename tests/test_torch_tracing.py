"""The port's tracing hooks (evcouplings_torch/utils/tracing.py) against
the JAX package's, through the cases of tests/test_tracing.py: the same
scopes through both packages' stage_timer give span tables of the same
scopes, columns and dtypes (a span is recorded on exception too), both
write the same CSV layout and None for an empty table, device_trace is a
no-op without a trace directory and writes a trace into one, and the
JAX package's annotate and the port's span name a region (in the port, one
that the trace shows by name).

Scopes, columns, dtypes, file names and return values are compared
exactly; the seconds are each package's own clock, so they are held only
to be finite and non-negative. tests/test_tracing.py's
test_persistent_cache_knob has no counterpart: it checks XLA's on-disk
compile cache (evcouplings_tpu/_jax_cache.py), and the port builds its
kernels once per checkout (kernels/_build.py) with no compile cache to
switch.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from evcouplings_tpu.utils import tracing as jax_tracing
from evcouplings_torch.utils import tracing


@pytest.fixture(params=["torch", "jax"])
def both(request):
    """Run a case through each package's module."""
    return tracing if request.param == "torch" else jax_tracing


def _spans(module, scopes, fail=()):
    module.clear_spans()
    for scope in scopes:
        try:
            with module.stage_timer(scope):
                if scope in fail:
                    raise RuntimeError("boom")
        except RuntimeError:
            pass
    return module.get_spans()


def test_stage_timer_records():
    got = _spans(tracing, ["align", "couplings"])
    want = _spans(jax_tracing, ["align", "couplings"])
    assert list(got.scope) == list(want.scope) == ["align", "couplings"]
    assert list(got.columns) == list(want.columns)
    assert list(got.dtypes) == list(want.dtypes)
    assert np.isfinite(got.seconds).all() and (got.seconds >= 0).all()


def test_span_recorded_on_exception():
    scopes = ["ok", "failing", "after"]
    got = _spans(tracing, scopes, fail={"failing"})
    want = _spans(jax_tracing, scopes, fail={"failing"})
    assert list(got.scope) == list(want.scope) == scopes


def test_stage_timer_yields_the_running_span():
    for module in (tracing, jax_tracing):
        module.clear_spans()
        with module.stage_timer("x") as span:
            running = dict(span)
        assert set(running) == {"scope", "start"}
        assert span["seconds"] == module.get_spans().seconds.iloc[0]


def test_write_span_table(tmp_path):
    files = {}
    for tag, module in (("torch", tracing), ("jax", jax_tracing)):
        _spans(module, ["x", "y"])
        out = str(tmp_path / (tag + "_runtime.csv"))
        assert module.write_span_table(out) == out
        files[tag] = pd.read_csv(out)
    got, want = files["torch"], files["jax"]
    assert list(got.columns) == list(want.columns) == [
        "scope", "start", "seconds"]
    assert list(got.scope) == list(want.scope)
    assert list(got.dtypes) == list(want.dtypes)


def test_write_span_table_empty_is_none(tmp_path, both):
    both.clear_spans()
    path = str(tmp_path / "r.csv")
    assert both.write_span_table(path) is None
    assert not os.path.exists(path)


def test_noop_without_dir(monkeypatch, tmp_path, both):
    monkeypatch.delenv("EVCOUPLINGS_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with both.device_trace():
        x = (torch.ones(3) + 1 if both is tracing else jnp.ones(3) + 1)
    assert float(x.sum()) == 6.0
    assert os.listdir(tmp_path) == []


def test_trace_writes_to_dir(tmp_path):
    """Both packages create the directory and write into it; the port's
    trace is one Chrome trace JSON whose events hold a span's region by
    name."""
    for tag, module in (("torch", tracing), ("jax", jax_tracing)):
        trace_dir = str(tmp_path / tag)
        with module.device_trace(trace_dir):
            if module is tracing:
                with tracing.span("reweighting"):
                    torch.ones(3).sum()
            else:
                jnp.ones(3).sum().block_until_ready()
        assert os.path.isdir(trace_dir) and any(os.scandir(trace_dir))
    (trace,) = os.listdir(tmp_path / "torch")
    assert trace.startswith("trace_{}_".format(os.getpid()))
    with open(tmp_path / "torch" / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "reweighting" in names


def test_trace_dir_from_the_environment(monkeypatch, tmp_path):
    """Both read the directory from the same variable."""
    assert tracing.TRACE_DIR_ENV == jax_tracing.TRACE_DIR_ENV
    monkeypatch.setenv(tracing.TRACE_DIR_ENV, str(tmp_path / "env"))
    with tracing.device_trace(name="align"):
        torch.ones(2).sum()
    (trace,) = os.listdir(tmp_path / "env")
    assert trace.startswith("align_")


def test_annotation_context():
    """The port's span, like the JAX package's annotate, names a region
    and leaves what runs in it alone."""
    with tracing.span("reweighting"):
        x = torch.arange(4).sum()
    with jax_tracing.annotate("reweighting"):
        y = jnp.arange(4).sum()
    assert int(x) == int(y) == 6
