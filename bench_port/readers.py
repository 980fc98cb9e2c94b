"""What the per-layer readers in metrics/ compute, shared by the readers
of one quantity over different cells (metrics/fit_mfu.py and
metrics/fit_mfu.balanced.py read the same thing in their own cells). Each
returns None where its run holds nothing to read."""

from bench_port import accounting


def _fit_flops(ctx):
    c = ctx.cell.config
    return (accounting.plm_flops_per_seq_site(c["L"], c["q"])
            * ctx.outcome.counters["fit_seq_sites"])


def fit_mfu(ctx):
    """The completed fits' model FLOPs (one value+gradient per iteration)
    over the window, as a share of the peak of the units the
    configuration's precision runs on (%)."""
    counters, c = ctx.outcome.counters, ctx.cell.config
    if ctx.peaks is None or not counters.get("fit_seq_sites"):
        return None
    return (100.0 * _fit_flops(ctx) / counters["window_s"]
            / ctx.peaks[c["peak_basis"]])


def fit_kernel_roofline(ctx):
    """The least time the card could take for the completed fits' model
    work (FLOPs over the configuration's peak, or bytes over the memory
    bandwidth, whichever is longer), as a share of the device's busy time
    in the traced window (%). It matches no kernel names, so it reads the
    same whatever implements the products."""
    counters, c, trace = (ctx.outcome.counters, ctx.cell.config,
                          ctx.outcome.trace)
    if (ctx.peaks is None or not trace or trace["busy_s"] <= 0
            or not counters.get("fit_seq_sites")):
        return None
    nbytes = (accounting.plm_bytes_per_evaluation(counters["rows"], c["L"],
                                                  c["q"])
              * counters["fit_evaluations"])
    least = accounting.least_seconds(_fit_flops(ctx), nbytes,
                                     ctx.peaks[c["peak_basis"]], ctx.peaks)
    return 100.0 * least / trace["busy_s"]


def device_idle(ctx):
    """The share of the traced window in which no kernel, copy or fill ran
    on the device (%)."""
    trace = ctx.outcome.trace
    if not trace or trace["busy_s"] <= 0 or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def peak_alloc_gib(ctx):
    """The caching allocator's peak of allocated device memory over the
    window (max_memory_allocated after reset_peak_memory_stats at its
    start), in GiB."""
    peak = ctx.outcome.counters.get("peak_alloc_bytes")
    return peak / 2 ** 30 if peak else None


def stage_outside_fit_s(ctx):
    """Per family of the counted cycles, the harness's span around run_plm
    less the fit loop's own time (the last `time` of its iteration table),
    averaged: reading, reweighting, frequencies, scoring and the file
    writes, in s per family."""
    spans = ctx.outcome.counters.get("family_s")
    if not spans:
        return None
    return sum(span - fit for _, span, fit in spans) / len(spans)
