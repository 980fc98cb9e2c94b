"""Runner of whole couplings stages: families written as a2m files from the
seed in set-up, then evcouplings_torch.couplings.fitter.run_plm over them
in turn, each from its a2m file to its raw EC file and plmc_v2 `.model`
file, in focus mode.

The families are cycled in their order, and only whole cycles count: the
window runs from the start of the first family to the end of the last cycle
that completes within the run's seconds, so every window holds the same
mix of depths. A family still running at the deadline is abandoned by
raising from its iteration callback.

Traffic keys: depths (rows per family, besides the focus row), inserts
(lowercase insert columns), families, mutate, gap_rows (the generator's
parameters), iterations, conv_tol, warmup_iterations, trace_seconds.
"""

import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from bench_port import generate, harness, judge, reference
from bench_port.runners.fit import lambda_J
from bench_port.harness import Outcome
from bench_port.window import Deadline, Window


def write_families(cell, out):
    """[(a2m path, codes with the focus row first, match columns)]."""
    t, c = cell.traffic, cell.config
    g = generate.generator(cell.seed, cell.device)
    families = []
    for k, depth in enumerate(t["depths"]):
        codes = generate.synthetic_codes(g, depth, c["L"], c["q"],
                                         t["families"], t["mutate"],
                                         t["gap_rows"])
        path = out / "family{}.a2m".format(k)
        pos = generate.write_a2m(path, g, codes, t["inserts"])
        focus = torch.as_tensor(generate.focus_codes(c["L"]),
                                dtype=codes.dtype, device=codes.device)
        match = np.setdiff1d(np.arange(c["L"] + t["inserts"]), pos)
        families.append((path, torch.cat([focus[None], codes]), match))
    return families


def program_stage(cell, a2m, prefix, iterations, conv_tol, callback=None,
                  precision=None):
    """run_plm as the couplings stage calls it; returns (result, EC path,
    model path)."""
    from evcouplings_torch.couplings.fitter import run_plm

    c = cell.config
    ec, model = Path(str(prefix) + ".ec"), Path(str(prefix) + ".model")
    res = run_plm(
        str(a2m), str(ec), str(model), focus_seq="TARGET",
        theta=c["theta"], iterations=iterations, conv_tol=conv_tol,
        lambda_h=c["fit"]["lambda_h"], lambda_J=lambda_J(c),
        solver=c["fit"]["solver"], block_size=c["fit"]["block_size"],
        compute_dtype=c["dtype"],
        matmul_precision=precision or c["matmul_precision"],
        callback=callback, device=cell.device)
    return res, ec, model


def judge_family(cell, checks, codes, match, res, ec, model, iterations,
                 conv_tol):
    """Every number of one family's stage against the reference made from
    the same codes: the `.model` file's weights, N_eff, frequencies and
    parameters, the fit, and the EC file's scores and order."""
    c = cell.config
    q = c["q"]
    got = reference.read_model(model)
    ref_counts = reference.cluster_counts(codes, c["theta"], q)
    w_ref = 1.0 / ref_counts.double()
    checks.add("weights_mismatch", int(np.sum(
        got["weights"] != w_ref.cpu().numpy().astype(np.float32))))
    checks.add("neff_mismatch",
               int(got["n_eff"] != np.float32(float(w_ref.sum()))))
    f_i, f_ij = reference.frequencies(codes, w_ref, q)
    if cell.control:
        # the frequencies' control: the reference's, its float32 weights
        # rounded to TF32 (the program pins these products to IEEE float32)
        w_tf32 = reference.round_mantissa(w_ref.float(), 10).double()
        got["f_i"], fij_c = reference.frequencies(codes, w_tf32, q)
        got["f_ij_upper"] = fij_c
    upper = np.triu(np.ones((c["L"], c["L"]), bool), k=1)
    checks.add("freq_gap", max(np.max(np.abs(got["f_i"] - f_i)),
                               np.max(np.abs(got["f_ij_upper"][upper]
                                             - f_ij[upper]))))
    plm = reference.Plm(codes, w_ref, q, c["fit"]["lambda_h"], lambda_J(c))
    answer = judge.fit_answer(res.iteration_table.to_dict("records"),
                              got["J_ij"], got["h_i"])
    judge.judge_fit(checks, c, plm, answer, iterations, conv_tol)
    i, j, fn, cn = reference.read_ec(ec)
    ii, jj = np.triu_indices(c["L"], k=1)
    fn_ref, cn_ref = reference.fn_apc(got["J_ij"])
    same_pairs = (np.array_equal(i, match[ii] + 1)
                  and np.array_equal(j, match[jj] + 1))
    checks.add("ec_gap", max(np.max(np.abs(fn - fn_ref[ii, jj])),
                             np.max(np.abs(cn - cn_ref[ii, jj])))
               if same_pairs else float("inf"))
    checks.add("ec_rank_inversions", reference.rank_inversions(
        cn, cn_ref[ii, jj], tie=2e-6))


def run(cell):
    # the run's files in a directory of its own under TMPDIR: runs in other
    # processes (test workers, readings beside a run) write families of the
    # same names
    with tempfile.TemporaryDirectory(prefix="bench_port_stage_") as out:
        return _run(cell, Path(out))


def _run(cell, out):
    t = cell.traffic
    families = write_families(cell, out)
    iters, tol = t["iterations"], t["conv_tol"]
    # the control: the program at the configuration's lower precision name
    precision = (cell.config["control"]["matmul_precision"] if cell.control
                 else None)
    program_stage(cell, families[0][0], out / "warmup",
                  t["warmup_iterations"], tol)

    win = Window(cell)
    last = {}           # family -> its last completed (result, ec, model)
    # (family, span around run_plm, its fit loop's time) of counted cycles
    cycles, spans, cycle_spans = 0, [], []
    k = 0
    while win.open():
        start = time.perf_counter()
        try:
            got = program_stage(cell, families[k][0],
                                out / "family{}".format(k), iters, tol,
                                win.callback, precision)
        except Deadline:
            break
        span = time.perf_counter() - start
        if not win.open():
            break
        last[k] = got
        fit_s = float(got[0].iteration_table["time"].iloc[-1])
        cycle_spans.append((k, span, fit_s))
        k = (k + 1) % len(families)
        if k == 0:
            if not win.mark():
                break
            cycles += 1
            spans += cycle_spans
            cycle_spans = []
    window, trace, window_peak = win.close(cycles, "cycle of families")

    for k, (_, codes, match) in enumerate(families):
        family_checks = harness.Checks(cell.checks.limits)
        judge_family(cell, family_checks, codes, match, *last[k], iters, tol)
        for row in family_checks.rows:
            cell.checks.rows.append(("family{}.{}".format(k, row[0]),
                                     *row[1:]))
    n_fam = cycles * len(families)
    return Outcome(
        e2e={"couplings_stage_s": window / n_fam, "setup_s": win.setup_s},
        counters={"families": n_fam, "family_s": spans,
                  "window_s": window, "peak_alloc_bytes": window_peak},
        attempted=n_fam,
        failed=sum(1 for k in range(len(families))
                   if not all(r[3] for r in cell.checks.rows
                              if r[0].startswith("family{}.".format(k)))),
        memory_peak_bytes=max(win.setup_peak, window_peak),
        trace=trace)
