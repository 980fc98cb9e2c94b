"""What the per-layer readers of the program's own spans compute, shared by
the readers of one quantity over different cells.

The program records its spans (evcouplings_torch.utils.tracing.span) while
a profiler is active, so a traced run's registry holds the spans of its
window alone: the window's profiler starts after set-up and warm-up. The
counted units are the first `fit` roots, as many as the fits the run
counted (`fit_s`), in a fit cell, and the first `stage` roots that closed
without an exception, as many as the families it counted, in a stage cell.
Each reader returns None where there is nothing to read: an untraced run,
a control run (the control, not the program, ran), or a program that
records no spans.
"""


def _records():
    try:
        from evcouplings_torch.utils.tracing import span_records
    except ImportError:
        return None
    return span_records()


def _duration(rec):
    return (rec["end_ns"] - rec["start_ns"]) / 1e9


class _Tree:
    """The spans under one root, by name and by parent."""

    def __init__(self, root, records):
        self.root = root
        self.records = records
        self.by_id = {r["id"]: r for r in records}

    def named(self, name, within=None):
        """The records called `name` (or `name.<site>`), below a record
        called `within` where given."""
        out = []
        for r in self.records:
            if r["name"] != name and not r["name"].startswith(name + "."):
                continue
            if within is None or self._below(r, within):
                out.append(r)
        return out

    def _below(self, rec, name):
        parent = self.by_id.get(rec["parent"])
        while parent is not None:
            if parent["name"] == name:
                return True
            parent = self.by_id.get(parent["parent"])
        return False

    def seconds(self, name, within=None):
        return sum(_duration(r) for r in self.named(name, within))


def counted(ctx):
    """The counted units' span trees, in the order they started; None
    where the run recorded fewer roots than it counted units."""
    records = _records()
    if not records or ctx.cell.control:
        return None
    counters = ctx.outcome.counters
    if "fit_s" in counters:
        name, n = "fit", len(counters["fit_s"])
    else:
        name, n = "stage", counters.get("families", 0)
    roots = sorted((r for r in records if r["parent"] is None
                    and r["name"] == name and not r["error"]),
                   key=lambda r: r["start_ns"])[:n]
    if not n or len(roots) < n:
        return None
    by_root = {r["id"]: [] for r in roots}
    for r in records:
        if r["root"] in by_root:
            by_root[r["root"]].append(r)
    return [_Tree(r, by_root[r["id"]]) for r in roots]


def fit_host_wait(ctx):
    """The share of the fit loops' host time spent in blocking reads of
    the device (fit.sync.* over fit.loop), over the counted fits (%)."""
    trees = counted(ctx)
    if trees is None:
        return None
    loop = sum(t.seconds("fit.loop") for t in trees)
    wait = sum(t.seconds("fit.sync", within="fit.loop") for t in trees)
    return 100.0 * wait / loop if loop > 0 else None


def vg_enqueue_ms(ctx):
    """The mean host time of one value+grad evaluation inside the fit
    loops (plm.value_grad spans): the time to issue it, and to wait where
    it reads the device (ms per evaluation)."""
    trees = counted(ctx)
    if trees is None:
        return None
    evals = [_duration(r) for t in trees
             for r in t.named("plm.value_grad", within="fit.loop")]
    return 1e3 * sum(evals) / len(evals) if evals else None


def lbfgs_evals_per_iter(ctx):
    """Value+grad evaluations inside the fit loops over the iterations the
    fits recorded (the `fit` spans' `iterations` count): line-search trials
    per accepted step, a failed final search included (evaluations per
    iteration)."""
    trees = counted(ctx)
    if trees is None:
        return None
    evals = sum(len(t.named("plm.value_grad", within="fit.loop"))
                for t in trees)
    iterations = sum(r["counts"].get("iterations", 0) for t in trees
                     for r in t.records if r["name"] == "fit")
    return evals / iterations if iterations else None


def fit_edges_s(ctx):
    """Per counted fit, the time outside its loop: fit.setup (padding,
    upload, masters, the first value+grad) and fit.finish (the
    parameters' readback and symmetrisation), in s per fit."""
    trees = counted(ctx)
    if trees is None:
        return None
    return sum(t.seconds("fit.setup") + t.seconds("fit.finish")
               for t in trees) / len(trees)


def _stage_part(name):
    def read(ctx):
        trees = counted(ctx)
        if trees is None or trees[0].root["name"] != "stage":
            return None
        return sum(t.seconds(name) for t in trees) / len(trees)

    read.__doc__ = ("Per counted family, the mean time of its {} span "
                    "(s per family).".format(name))
    return read


stage_read_s = _stage_part("stage.read")
stage_reweight_s = _stage_part("stage.reweight")
stage_score_s = _stage_part("stage.score")
stage_write_s = _stage_part("stage.write")
