"""The reader of how often the fits' value+grad evaluations replay a CUDA
graph, over the counted units that program_spans.counted gives (the first
`fit` roots of a fit cell, the first `stage` roots of a stage cell).

A fit on the card captures its evaluation once, in fit.setup, under a
plm.graph_capture span, and each later evaluation's plm.value_grad span
carries the count `replayed`. The reader returns None where there is
nothing to read: an untraced run, a control run, a program that records no
spans, or fits that capture no graph (a program without it, a fit on the
host).
"""

from bench_port.program_spans import counted


def vg_graph_share(ctx):
    """The share of the value+grad evaluations inside the fit loops that
    replayed the fit's CUDA graph (plm.value_grad spans with the count
    `replayed`), over the counted fits or families (%). None where no
    counted fit captured one (no plm.graph_capture span)."""
    trees = counted(ctx)
    if trees is None or not any(t.named("plm.graph_capture")
                                for t in trees):
        return None
    evals = [r for t in trees
             for r in t.named("plm.value_grad", within="fit.loop")]
    if not evals:
        return None
    replayed = sum(1 for r in evals if r["counts"].get("replayed"))
    return 100.0 * replayed / len(evals)
