"""Runner of whole-fit traffic: one resident alignment made from the seed,
reweighted once in set-up, and whole pseudolikelihood fits
(evcouplings_torch.ops.plm.fit_plm, from zero, conv_tol 0) back to back.

Only fits that complete count: the window runs from the start of the
first fit to the end of the last fit that completes within the run's
seconds, and a fit still running at the deadline is abandoned by raising
from its iteration callback.

Traffic keys: rows, families, mutate, gap_rows (the generator's
parameters), iterations_per_fit, warmup_iterations, trace_seconds (the
window of a traced run).
"""

import dataclasses

import numpy as np
import torch

from bench_port import generate, judge, reference
from bench_port.harness import Outcome
from bench_port.window import Deadline, Window


def lambda_J(config):
    """The per-pair strength: plmc's lambda_J, times (q - 1)(L - 1) where
    the configuration says lambda_J_times_Lq."""
    fit = config["fit"]
    scale = ((config["q"] - 1) * (config["L"] - 1)
             if fit["lambda_J_times_Lq"] else 1)
    return fit["lambda_J"] * scale


def plm_config(config, iterations, conv_tol, precision=None):
    from evcouplings_torch.ops.plm import PlmConfig

    fit = config["fit"]
    return PlmConfig(
        lambda_h=fit["lambda_h"], lambda_J=lambda_J(config),
        max_iter=iterations, conv_tol=conv_tol, solver=fit["solver"],
        block_size=fit["block_size"], dtype=config["dtype"],
        precision=precision or config["matmul_precision"])


def make_codes(cell):
    t, c = cell.traffic, cell.config
    g = generate.generator(cell.seed, cell.device)
    return generate.synthetic_codes(g, t["rows"], c["L"], c["q"],
                                    t["families"], t["mutate"],
                                    t["gap_rows"])


def program_weights(codes, theta):
    """K1's cluster counts and the weights run_plm takes from them."""
    from evcouplings_torch.ops.weights import num_cluster_members

    counts = num_cluster_members(codes, theta).cpu().numpy()
    return counts, 1.0 / counts


def program_fit(cell, codes_np, weights, cfg, callback=None):
    from evcouplings_torch.ops.plm import fit_plm

    fit = fit_plm(codes_np, weights, cell.config["q"], cfg,
                  callback=callback, device=cell.device)
    return judge.fit_answer(fit.iteration_table, fit.J_ij, fit.h_i)


def control_fit(cell, codes, codes_np, weights, iterations, conv_tol):
    """The configuration's control: the program at a lower precision name,
    or the reference in a lower precision (float32, its products' operands
    rounded to the stated mantissa bits)."""
    ctl = cell.config["control"]
    if ctl["kind"] == "program":
        cfg = plm_config(cell.config, iterations, conv_tol,
                         precision=ctl["matmul_precision"])
        return program_fit(cell, codes_np, weights, cfg)
    c = cell.config
    plm = reference.Plm(codes, torch.as_tensor(weights, device=codes.device),
                        c["q"], c["fit"]["lambda_h"], lambda_J(c),
                        dtype=getattr(torch, ctl["dtype"]),
                        mantissa_bits=ctl["mantissa_bits"])
    rows, x = judge.reference_fit(
        plm, iterations, conv_tol,
        reference.DOTS[c["reference"]["lbfgs_dot"]])
    return rows, x.double().cpu().numpy()


def judge_cell(cell, codes, counts, answer, iterations, conv_tol):
    """Every number of a fit cell, against the reference made from the
    same codes: K1's counts, then the fit."""
    c = cell.config
    ref_counts = reference.cluster_counts(codes, c["theta"], c["q"])
    cell.checks.add("counts_mismatch", int(np.sum(
        ref_counts.cpu().numpy() != counts)))
    plm = reference.Plm(codes, 1.0 / ref_counts.double(), c["q"],
                        c["fit"]["lambda_h"], lambda_J(c))
    judge.judge_fit(cell.checks, c, plm, answer, iterations, conv_tol)


def run(cell):
    t, c = cell.traffic, cell.config
    iters = t["iterations_per_fit"]
    codes = make_codes(cell)
    codes_np = codes.cpu().numpy()
    counts, weights = program_weights(codes, c["theta"])
    cfg = plm_config(c, iters, 0.0)
    program_fit(cell, codes_np, weights,
                dataclasses.replace(cfg, max_iter=t["warmup_iterations"]))

    win = Window(cell)
    done, iterations, answer, fit_s = 0, 0, None, []
    while True:
        start = win.t_end
        try:
            if cell.control:
                got = control_fit(cell, codes, codes_np, weights, iters, 0.0)
            else:
                got = program_fit(cell, codes_np, weights, cfg, win.callback)
        except Deadline:
            break
        if not win.mark():
            break
        done, answer = done + 1, got
        iterations += len(got[0])
        fit_s.append(win.t_end - start)
    window, trace, window_peak = win.close(done, "fit")

    judge_cell(cell, codes, counts, answer, iters, 0.0)
    n, L = codes.shape
    # the work the counted fits did: the iterations they ran, not those
    # they were asked for
    seq_sites = n * L * iterations
    return Outcome(
        e2e={"fit_seq_sites_per_s": seq_sites / window,
             "setup_s": win.setup_s},
        counters={"fit_seq_sites": seq_sites, "fit_evaluations": iterations,
                  "rows": n, "window_s": window, "fit_s": fit_s,
                  "peak_alloc_bytes": window_peak},
        attempted=done, failed=0 if cell.checks.ok else 1,
        memory_peak_bytes=max(win.setup_peak, window_peak),
        trace=trace)
