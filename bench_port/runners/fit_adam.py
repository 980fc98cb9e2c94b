"""Runner of whole Adam fits: the fit runner's traffic (one resident
alignment made from the seed, reweighted once in set-up, whole
evcouplings_torch.ops.plm.fit_plm fits from zero with conv_tol 0 back to
back, the fit running at the deadline abandoned), with the configuration's
Adam settings and the reference's own Adam fit as the judge.

The configuration's `fit` gives the solver's learning rate (`adam_lr`),
its steps per host read (`steps_per_call`) and its epilogue and gradient
layout (`fused_update`, `grad_layout`), each as PlmConfig takes it. A
traced run also sums K2's device time and launches in the window. The
control (the reference in a lower precision) runs one fit.

Traffic keys: those of runners/fit.py.
"""

import dataclasses
import time

import numpy as np
import torch

from bench_port import adam_readers, judge, judge_adam, reference
from bench_port.harness import Outcome
from bench_port.runners.fit import lambda_J, make_codes, program_weights
from bench_port.window import Deadline, Window


def plm_config(config, iterations, conv_tol):
    from evcouplings_torch.ops.plm import PlmConfig

    fit = config["fit"]
    return PlmConfig(
        lambda_h=fit["lambda_h"], lambda_J=lambda_J(config),
        max_iter=iterations, conv_tol=conv_tol, solver=fit["solver"],
        adam_lr=fit["adam_lr"], block_size=fit["block_size"],
        dtype=config["dtype"], precision=config["matmul_precision"],
        steps_per_call=fit["steps_per_call"],
        fused_update=fit["fused_update"], grad_layout=fit["grad_layout"])


class K2Window(Window):
    """The window, which in a traced run also sums K2's device time and
    launches between its start and its end, before the profiler's events
    are let go."""

    k2_device_s = k2_launches = None

    def close(self, counted, what):
        tracer = self.tracer
        out = super().close(counted, what)
        if tracer is not None:
            seconds, launches = 0, 0
            for e in tracer.events:
                if (e.device_type() == torch.autograd.DeviceType.CUDA
                        and adam_readers.is_k2(e.name())):
                    s = max(e.start_ns(), self.t0_ns)
                    t = min(e.start_ns() + e.duration_ns(), self.t_end_ns)
                    if t > s:
                        seconds += t - s
                        launches += 1
            self.k2_device_s, self.k2_launches = seconds / 1e9, launches
        return out


def program_fit(cell, codes_np, weights, cfg, callback=None):
    """(rows, x) of a fit, with f at the parameters it returned as the fit
    itself prices them (its final_loss)."""
    from evcouplings_torch.ops.plm import fit_plm

    fit = fit_plm(codes_np, weights, cell.config["q"], cfg,
                  callback=callback, device=cell.device)
    return (judge.fit_answer(fit.iteration_table, fit.J_ij, fit.h_i),
            fit.final_loss)


def program_gnorm(cell, codes_np, weights, cfg, x):
    """The program's own |g| at the flat parameters x = [P, h]: its
    value+grad there, on the rows padded as fit_plm pads them."""
    from evcouplings_torch.ops.encode import pad_rows
    from evcouplings_torch.ops.plm import make_plm_value_and_grad

    c = cell.config
    L, q = c["L"], c["q"]
    lq = L * q
    codes_p, _ = pad_rows(codes_np.astype(np.int8), cfg.block_size)
    codes_p[codes_np.shape[0]:] = -1
    w_p, _ = pad_rows(np.asarray(weights, dtype=np.float64), cfg.block_size)
    xt = torch.as_tensor(x, dtype=torch.float32, device=cell.device)
    params = {"J": xt[:lq * lq].reshape(lq, lq), "h": xt[lq * lq:]
              .reshape(L, q)}
    vg = make_plm_value_and_grad(L, q, cfg, symmetric_params=True)
    _, grads = vg(params, torch.as_tensor(codes_p, device=cell.device),
                  torch.as_tensor(w_p, device=cell.device).to(torch.float32))
    return sum(float(torch.sum(g.double() ** 2))
               for g in grads.values()) ** 0.5


def control_fit(cell, codes, weights, iterations):
    """The configuration's control: the reference's Adam fit in float32,
    its products' operands rounded to the stated mantissa bits, with its
    own (f, |g|) at the parameters it reached."""
    c, ctl = cell.config, cell.config["control"]
    plm = reference.Plm(codes, torch.as_tensor(weights, device=codes.device),
                        c["q"], c["fit"]["lambda_h"], lambda_J(c),
                        dtype=getattr(torch, ctl["dtype"]),
                        mantissa_bits=ctl["mantissa_bits"])
    rows, x = judge_adam.reference_fit(plm, iterations, c["fit"]["adam_lr"])
    value, grad = plm.value_grad(x)
    return ((rows, x.double().cpu().numpy()),
            (float(value), float(torch.linalg.vector_norm(grad))))


def judge_cell(cell, codes, counts, answer, at_x, iterations):
    """Every number of the cell, against the reference made from the same
    codes: K1's counts, then the fit."""
    c = cell.config
    ref_counts = reference.cluster_counts(codes, c["theta"], c["q"])
    cell.checks.add("counts_mismatch", int(np.sum(
        ref_counts.cpu().numpy() != counts)))
    plm = reference.Plm(codes, 1.0 / ref_counts.double(), c["q"],
                        c["fit"]["lambda_h"], lambda_J(c))
    judge_adam.judge_fit(cell.checks, plm, answer, at_x, iterations,
                         c["fit"]["adam_lr"])


def run(cell):
    t, c = cell.traffic, cell.config
    iters = t["iterations_per_fit"]
    codes = make_codes(cell)
    codes_np = codes.cpu().numpy()
    counts, weights = program_weights(codes, c["theta"])
    cfg = plm_config(c, iters, 0.0)
    program_fit(cell, codes_np, weights,
                dataclasses.replace(cfg, max_iter=t["warmup_iterations"]))

    win = K2Window(cell)
    done, iterations, answer, at_x, fit_s = 0, 0, None, None, []
    while True:
        start = win.t_end
        try:
            if cell.control:
                got, at = control_fit(cell, codes, weights, iters)
            else:
                got, at = program_fit(cell, codes_np, weights, cfg,
                                      win.callback)
        except Deadline:
            break
        if not win.mark():
            break
        done, answer, at_x = done + 1, got, at
        iterations += len(got[0])
        fit_s.append(win.t_end - start)
        if cell.control:
            break
    window, trace, window_peak = win.close(done, "fit")

    if not cell.control:
        at_x = (at_x, program_gnorm(cell, codes_np, weights, cfg, answer[1]))
    t_judge = time.perf_counter()
    judge_cell(cell, codes, counts, answer, at_x, iters)
    n, L = codes.shape
    seq_sites = n * L * iterations
    counters = {"fit_seq_sites": seq_sites, "fit_evaluations": iterations,
                "rows": n, "window_s": window, "fit_s": fit_s,
                "peak_alloc_bytes": window_peak,
                "judge_s": time.perf_counter() - t_judge}
    if win.k2_launches:
        counters.update(k2_device_s=win.k2_device_s,
                        k2_launches=win.k2_launches)
    return Outcome(
        e2e={"fit_seq_sites_per_s": seq_sites / window,
             "setup_s": win.setup_s},
        counters=counters,
        attempted=done, failed=0 if cell.checks.ok else 1,
        memory_peak_bytes=max(win.setup_peak, window_peak),
        trace=trace)
