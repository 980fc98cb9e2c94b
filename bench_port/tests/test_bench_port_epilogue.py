"""The reader of the bf16 block epilogue's route
(epilogue_readers.epilogue_fused_share), on span records made by hand as
a production fit records them: each step's plm.value_grad span inside
fit.loop, with the count `epilogue_fused` where its row blocks took K6,
and the final pricing evaluation in fit.finish, which the share leaves
out."""

import itertools
from types import SimpleNamespace

import pytest

from bench_port import epilogue_readers
from evcouplings_torch.utils import tracing


def _fit_records(ids, fused):
    """Span records of one Adam fit: per entry of `fused` a step's
    plm.value_grad in fit.loop (its count where true) and its
    adam.update, then the pricing evaluation in fit.finish."""
    recs = []

    def add(name, parent, counts=None):
        i = next(ids)
        recs.append({"name": name, "id": i, "parent": parent,
                     "root": recs[0]["id"] if recs else i,
                     "start_ns": 10 * i, "end_ns": 10 * i + 5,
                     "error": False, "counts": counts or {}})
        return i

    fit = add("fit", None, {"iterations": len(fused)})
    add("fit.onehot", add("fit.setup", fit))
    loop = add("fit.loop", fit)
    for f in fused:
        add("plm.value_grad", loop, {"epilogue_fused": 1} if f else None)
        add("adam.update", loop, {"fused": 1})
    add("plm.value_grad", add("fit.finish", fit), {"epilogue_fused": 1})
    return recs


def _ctx(n_fits, control=False):
    return SimpleNamespace(
        cell=SimpleNamespace(control=control),
        outcome=SimpleNamespace(counters={"fit_s": [1.0] * n_fits}))


@pytest.mark.parametrize("fits,share", [
    ([[1, 1, 1], [1, 1]], 100.0),
    ([[0, 0, 0], [0]], 0.0),
    ([[1, 0, 1, 1], [0, 1, 1, 1]], 75.0),
])
def test_epilogue_fused_share_on_made_up_spans(monkeypatch, fits, share):
    """100 where every step's evaluation took K6 (the card's bf16 route),
    0 where none did (a program without K6, a fit on the host), the share
    between; a fit beyond those counted and the pricing evaluations do
    not enter it."""
    ids = itertools.count(1)
    records = [r for fused in fits for r in _fit_records(ids, fused)]
    records += _fit_records(ids, [0] * 8)
    monkeypatch.setattr(tracing, "span_records", lambda: records)
    assert epilogue_readers.epilogue_fused_share(_ctx(len(fits))) == share


def test_epilogue_fused_share_reads_nothing_without_spans(monkeypatch):
    """None for an untraced run (no records), a control run, fits without
    a value+grad span in their loops, and fewer fits than counted."""
    ids = itertools.count(1)
    records = _fit_records(ids, [1, 1])
    monkeypatch.setattr(tracing, "span_records", lambda: [])
    assert epilogue_readers.epilogue_fused_share(_ctx(1)) is None
    monkeypatch.setattr(tracing, "span_records", lambda: records)
    assert epilogue_readers.epilogue_fused_share(_ctx(1)) == 100.0
    assert epilogue_readers.epilogue_fused_share(_ctx(1, True)) is None
    assert epilogue_readers.epilogue_fused_share(_ctx(2)) is None
    monkeypatch.setattr(tracing, "span_records", lambda: [
        r for r in records if r["name"] != "plm.value_grad"])
    assert epilogue_readers.epilogue_fused_share(_ctx(1)) is None
