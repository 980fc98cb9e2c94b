"""The readers of the production fit's Adam epilogue, and K2's least bytes.

K2 (the program's kernels/adam_update.py, the Triton kernel
`_adam_update_kernel`) does one Adam step's elementwise epilogue over the
(Lq, Lq) couplings: it reads the gradient product dJh's (Lq, Lq) part, the
float32 masters P and the moments mu and nu, and writes P, mu and nu back
with the next step's couplings in bfloat16. Each Adam step of a fused fit
records an `adam.update` span with the count `fused`; an unfused step
records the span without it. Each reader returns None where its run holds
nothing to read.
"""

from bench_port import program_spans

# the kernel's name in the device trace (its presym sibling is
# _adam_update_presym_kernel, which the fit does not launch)
K2_KERNEL = "_adam_update_kernel"


def is_k2(name):
    return name.startswith(K2_KERNEL)


def k2_least_bytes(l, q):
    """Least bytes of one K2 launch at L sites and q states: each (Lq, Lq)
    input read once (dJh's part, P, mu, nu: float32), each output written
    once (P, mu, nu: float32; the couplings: bfloat16)."""
    lq = l * q
    return lq * lq * (4 * 4 + 3 * 4 + 2)


def k2_roofline(ctx):
    """K2's least time in the traced window (its launches times its least
    bytes over the memory bandwidth) over its device time there (%)."""
    counters, c = ctx.outcome.counters, ctx.cell.config
    seconds = counters.get("k2_device_s")
    if ctx.peaks is None or not seconds:
        return None
    least = (counters["k2_launches"] * k2_least_bytes(c["L"], c["q"])
             / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * least / seconds


def adam_fused_share(ctx):
    """The share of the Adam steps inside the counted fits' loops whose
    epilogue ran fused (adam.update spans with the count `fused`) (%)."""
    trees = program_spans.counted(ctx)
    if trees is None:
        return None
    steps = [r for t in trees for r in t.named("adam.update",
                                               within="fit.loop")]
    if not steps:
        return None
    fused = sum(1 for r in steps if r["counts"].get("fused"))
    return 100.0 * fused / len(steps)
