"""The comparisons that decide `correct` in a cell of Adam fits: judge.py's
numbers, held against the reference's own Adam fit (reference_adam.py).

An Adam row records f and |g| at the iterate before its update, so the last
row does not price the parameters the fit returns: fx_at_x takes the f the
fit reports for them (its final_loss, its own evaluation of its masters),
gnorm_at_x the program's |g| at the parameters returned (`at_x`).
"""

import numpy as np
import torch

from bench_port import reference_adam


def reference_fit(plm, iterations, lr, keep=None):
    """The reference's Adam fit from zero: (rows, x), x the iterate after
    `keep` steps where given and reached, else after `iterations`."""
    x0 = torch.zeros(plm.lq * plm.lq + plm.lq, dtype=plm.dtype,
                     device=plm.codes.device)
    kept = {}

    def at(k, x):
        if k == keep:
            kept["x"] = x

    x, rows = reference_adam.adam(plm.value_grad, x0, iterations, lr,
                                  callback=at)
    return rows, kept.get("x", x)


def judge_fit(checks, plm, answer, at_x, iterations, lr):
    """Hold an Adam fit's answer (rows, x), with the program's (f, |g|) at
    x (at_x), against the objective `plm` and the reference's own fit:
    - iterations_mismatch: |the program's steps - `iterations`|;
    - fx_path: the largest relative gap of f over the steps both took;
    - fx_at_x, gnorm_at_x: the relative gap between the program's f and
      |g| at its returned parameters and the reference's there;
    - x_gap and xnorm_gap: by the worst leaf (couplings P, fields h), as
      judge.judge_fit, against the reference's iterate after as many
      steps as the program took (like for like);
    - pair_gap: the same relative gap over each pair's q x q coupling
      block (i, j), i != j, alone, the largest over the pairs: one wrong
      block of the L(L - 1)/2 moves x_gap by about 1/sqrt(L(L - 1)/2) of
      its own gap only, where Adam's sign-sensitive first steps already
      spread bf16's rounding over every block.
    """
    rows, x = answer
    checks.add("iterations_mismatch", abs(len(rows) - iterations))
    rows_ref, x_ref = reference_fit(plm, iterations, lr, keep=len(rows))
    k = min(len(rows), len(rows_ref))
    path = float("inf")
    if k:
        fx = np.array([r[0] for r in rows[:k]])
        fr = np.array([r[0] for r in rows_ref[:k]])
        path = float(np.max(np.abs(fx - fr) / np.abs(fr)))
    checks.add("fx_path", path)
    xt = torch.as_tensor(x, dtype=plm.dtype, device=plm.codes.device)
    value, grad = plm.value_grad(xt)
    value = float(value)
    gnorm = float(torch.linalg.vector_norm(grad))
    checks.add("fx_at_x", abs(at_x[0] - value) / abs(value))
    checks.add("gnorm_at_x", abs(at_x[1] - gnorm) / gnorm)
    d = plm.lq * plm.lq
    leaves = [(xt[s], x_ref[s]) for s in (slice(0, d), slice(d, None))]
    norm = torch.linalg.vector_norm
    checks.add("x_gap", max(float(norm(a - b) / norm(b)) for a, b in leaves))
    checks.add("xnorm_gap", max(float(abs(norm(a) - norm(b)) / norm(b))
                                for a, b in leaves))
    L, q = plm.L, plm.q
    gap, ref = (norm(v.reshape(L, q, L, q), dim=(1, 3))
                for v in (xt[:d] - x_ref[:d], x_ref[:d]))
    off = ~torch.eye(L, dtype=torch.bool, device=ref.device)
    checks.add("pair_gap", float(torch.max(gap[off] / ref[off])))
