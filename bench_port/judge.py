"""The comparisons that decide `correct`: each number is a gap between what
the timed path produced and the plain reference, held to its limit.
"""

import numpy as np
import torch

from bench_port import reference


def fit_answer(table, J_ij, h_i):
    """(rows, x) of a fit: its per-iteration (f, |g|, |x|) and the flat
    parameter vector [P, h] of the couplings and fields it returned."""
    rows = [(float(r["fx"]), float(r["gnorm"]), float(r["xnorm"]))
            for r in table]
    return rows, reference.flat_params(J_ij, h_i)


def reference_fit(plm, iterations, conv_tol, dot=torch.dot, keep=None):
    """The reference's own fit from zero, stopping as the program's does
    (after `iterations`, at conv_tol, or when its line search fails):
    (rows, x), x the iterate after `keep` iterations where given and
    reached, else where it stopped."""
    lq = plm.lq
    x0 = torch.zeros(lq * lq + lq, dtype=plm.dtype,
                     device=plm.codes.device)
    kept = {}

    def at(k, x):
        if k == keep:
            kept["x"] = x

    x, rows = reference.lbfgs(plm.value_grad, x0, iterations,
                              conv_tol=conv_tol, dot=dot, callback=at)
    return rows, kept.get("x", x)


def judge_fit(checks, config, plm, answer, iterations, conv_tol):
    """Hold a fit's answer (rows, x) against the reference objective `plm`
    and the reference's own fit, whose dots are those the configuration
    states for its solver:
    - iterations_mismatch: |the program's iterations - `iterations`|, the
      measure where conv_tol is 0 and every fit must run them all;
    - fx_path: the largest relative gap of f over the iterations both ran;
    - fx_final_gap: how far the program's last f lies above the
      reference's where the reference stopped, relative (a fit that stops
      early reads its shortfall here);
    - fx_at_x: the relative gap between the last recorded f and the
      reference's at the returned parameters;
    - gnorm_at_x: the gap between the last recorded |g| and the
      reference's at the returned parameters, |g| taken with the solver's
      dot, over the reference's |g| there where conv_tol is 0 (the fit
      runs all its iterations). A fit given a conv_tol runs until its
      float32 line search can lower f no further, where the |g| left is so
      small that float32's rounding of the gradient is a large share of
      it: there the gap is taken over the reference's |g| at the fit's
      start (x = 0), and the relative gap is offered as gnorm_rel_at_x;
    - x_gap and xnorm_gap: by the worst leaf (couplings P, fields h),
      |leaf - leaf_ref| / |leaf_ref| and | |leaf| - |leaf_ref| | / |leaf_ref|,
      against the reference's iterate after as many iterations as the
      program ran (like for like).
    """
    dot = reference.DOTS[config["reference"]["lbfgs_dot"]]
    rows, x = answer
    checks.add("iterations_mismatch", abs(len(rows) - iterations))
    rows_ref, x_ref = reference_fit(plm, iterations, conv_tol, dot,
                                    keep=len(rows))
    k = min(len(rows), len(rows_ref))
    path = final = float("inf")
    if k:
        fx = np.array([r[0] for r in rows[:k]])
        fr = np.array([r[0] for r in rows_ref[:k]])
        path = float(np.max(np.abs(fx - fr) / np.abs(fr)))
        final = (rows[-1][0] - rows_ref[-1][0]) / abs(rows_ref[-1][0])
    checks.add("fx_path", path)
    checks.add("fx_final_gap", final)
    xt = torch.as_tensor(x, dtype=plm.dtype, device=plm.codes.device)
    value, grad = plm.value_grad(xt)
    value = float(value)
    gnorm = float(torch.sqrt(dot(grad, grad)))
    scale = gnorm
    if conv_tol:
        _, grad0 = plm.value_grad(torch.zeros_like(xt))
        scale = float(torch.sqrt(dot(grad0, grad0)))
    if rows:
        checks.add("fx_at_x", abs(rows[-1][0] - value) / abs(value))
        checks.add("gnorm_at_x", abs(rows[-1][1] - gnorm) / scale)
        if conv_tol:
            checks.add("gnorm_rel_at_x", abs(rows[-1][1] - gnorm) / gnorm)
    else:
        checks.add("fx_at_x", float("inf"))
        checks.add("gnorm_at_x", float("inf"))
    d = plm.lq * plm.lq
    leaves = [(xt[s], x_ref[s]) for s in (slice(0, d), slice(d, None))]
    norm = torch.linalg.vector_norm
    checks.add("x_gap", max(float(norm(a - b) / norm(b)) for a, b in leaves))
    checks.add("xnorm_gap", max(float(abs(norm(a) - norm(b)) / norm(b))
                                for a, b in leaves))
