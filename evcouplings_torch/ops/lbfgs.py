"""Limited-memory BFGS on flat parameter vectors (port of
evcouplings_tpu/ops/lbfgs.py).

The engine behind ``fit_plm(solver="lbfgs")``, the plmc-parity default.
The parameters live in ONE flat vector; the history is m (s, y) pairs in
chronological order (oldest first) with rho == 0 marking an empty slot;
the two-loop recursion is 4m dot/axpy passes; the linesearch is
libLBFGS's backtracking with the strong-Wolfe rule (halve on
Armijo/overshoot failure, grow 2.1x while the directional derivative is
still steeply negative).

The JAX engine chains iterations in lax.scan/while_loop; here they are
plain Python loops over tensors. Scalars stay 0-d tensors of the
vector's dtype, so every comparison is made in the same arithmetic as
the JAX engine; the host reads one small vector of flags per linesearch
trial. Empty history slots are skipped rather than multiplied by
rho == 0, which is bitwise the same.
"""

import torch

# libLBFGS-compatible linesearch constants (strong Wolfe), pinned to the
# values of the JAX engine and the f64 oracle of the tests
_C1 = 1e-4          # Armijo (sufficient decrease)
_C2 = 0.9           # curvature, libLBFGS wolfe default for LBFGS
_GROW = 2.1         # trial-step growth while curvature says "too short"
_SHRINK = 0.5       # trial-step backtracking factor
# skip the history update if dot(s, y) falls below this ABSOLUTE
# threshold (keeps rho finite after an inexact linesearch)
_MIN_CURVATURE = 1e-10
# libLBFGS's max_linesearch default
_MAX_LS = 40


def init_lbfgs_state(x, value, grad, m=5):
    """History + carried evaluation for a chunked LBFGS run.

    ``value``/``grad`` must be the objective evaluated at ``x``: the
    accepted linesearch point of each iteration is reused as the next
    iteration's evaluation.
    """
    f = x.dtype
    zero = torch.zeros((), dtype=f, device=x.device)
    return {
        "s_hist": [None] * m,         # None marks an empty slot
        "y_hist": [None] * m,
        "rho": [zero] * m,            # 0 marks an empty slot
        "gamma": torch.ones((), dtype=f, device=x.device),
        "count": 0,                   # accepted iterations
        "nevals": 0,                  # total linesearch evaluations
        "value": torch.as_tensor(value).to(device=x.device, dtype=f),
        "grad": grad.to(f),
        "converged": False,
        # linesearch failure (rounding error / max_ls exhaustion) is
        # not convergence: libLBFGS reports LBFGSERR_ROUNDING_ERROR /
        # _MAXIMUMLINESEARCH there
        "ls_failed": False,
    }


def _two_loop_direction(state, dot):
    """d = -H g via the standard two-loop recursion over the
    chronological history (oldest first)."""
    s_hist, y_hist, rho = state["s_hist"], state["y_hist"], state["rho"]
    m = len(s_hist)
    qv = state["grad"]
    alpha = [None] * m
    for i in range(m - 1, -1, -1):             # newest -> oldest
        if s_hist[i] is None:
            continue
        alpha[i] = rho[i] * dot(s_hist[i], qv)
        qv = qv - alpha[i] * y_hist[i]
    qv = qv * state["gamma"]
    for i in range(m):                         # oldest -> newest
        if s_hist[i] is None:
            continue
        b = rho[i] * dot(y_hist[i], qv)
        qv = qv + (alpha[i] - b) * s_hist[i]
    return -qv


def make_lbfgs_chunk(vg, *, m=5, steps_per_call=1, max_ls=_MAX_LS,
                     conv_tol=1e-5, norm_split=None, dot=torch.dot,
                     dots=None):
    """Build chunk(x, state, *extra) -> (x, state, metrics).

    vg : (x (D,), *extra) -> (value 0-d tensor, grad (D,)).
    metrics : (steps_per_call, 4) float32 tensor of rows
        [value, ||grad||, ||x||, ls_failed] at the ACCEPTED iterate of
        each step. With norm_split=d, two extra columns
        [||x[d:]||, ||x[:d]||] report the field / coupling norms.

    dot : the vector dot product of every scalar the engine takes
        (torch.dot, or kernels.seqdot.sequential_dot to reproduce the
        JAX engine's CPU rounding in parity mode).
    dots : (xs, ys) -> [dot(x, y) for each pair], the same products taken
        as one batch of independent dots (kernels.seqdot.sequential_dots:
        one launch); None takes them one at a time with `dot`. The engine
        batches the dots that do not depend on each other: s.y with y.y,
        and ||g|| with ||x|| (and the two split norms). Each dot of a
        batch gives the bits `dot` gives, so batching changes no result.

    Convergence uses the libLBFGS rule ||g|| <= tol * max(1, ||x||);
    once it trips, remaining steps of the chunk pass through unchanged.
    A chunk leaves ||g|| and ||x|| of the x it returns in
    state["norms"], and the next chunk starts from them: call it with
    that x.
    """
    del m  # the history length is carried by the state

    def step(x, state, extra):
        d = _two_loop_direction(state, dot)
        value0, grad0 = state["value"], state["grad"]
        f = x.dtype

        dphi0 = dot(grad0, d)
        # steepest descent if the two-loop direction is not a descent
        # direction (possible with stale curvature after skipped updates)
        if bool(dphi0 >= 0):
            d = -grad0
            dphi0 = -dot(grad0, grad0)

        # libLBFGS seeds the first iteration with t = 1/||d||; later
        # iterations start from the unit step
        if state["count"] == 0:
            dnorm = torch.sqrt(dot(d, d))
            t = (1.0 / torch.clamp(dnorm, min=1e-30)).to(f)
        else:
            t = torch.ones((), dtype=f, device=x.device)

        # when the predicted change |t dphi0| is below one ulp of the
        # objective the step is unresolvable: accept it on plain Armijo,
        # or fail the search if even Armijo cannot be met
        eps_f = torch.finfo(f).eps
        t_eval, value_t, grad_t = t, value0, grad0
        ok = done = False
        n_ls = 0
        while not done and n_ls < max_ls:
            value_t, grad_t = vg(x + t * d, *extra)
            t_eval = t
            dphi = dot(grad_t, d)
            armijo = value_t <= value0 + _C1 * t * dphi0
            too_short = dphi < _C2 * dphi0         # still descending hard
            overshoot = dphi > -_C2 * dphi0        # strong-Wolfe far side
            tiny = t * torch.abs(dphi0) <= eps_f * torch.abs(value0)
            armijo, too_short, overshoot, tiny = (
                bool(v) for v in torch.stack(
                    [armijo, too_short, overshoot, tiny]).tolist())
            ok = armijo and ((not too_short and not overshoot) or tiny)
            done = ok or (tiny and not armijo)
            if not armijo or overshoot:
                t = t * _SHRINK
            elif too_short:
                t = t * _GROW
            n_ls += 1

        if ok:
            t = t_eval
        else:
            # rounding failure or max_ls exhaustion: do not move and
            # freeze the fit
            t = torch.zeros((), dtype=f, device=x.device)
            value_t, grad_t = value0, grad0

        x_new = x + t * d
        s = t * d
        y = grad_t - grad0
        # y.y is taken beside s.y (one batch) and unused when the history
        # update is skipped
        sy, yy = dots([s, y], [y, y])
        new_state = dict(state)
        if ok and bool(sy > _MIN_CURVATURE):
            # chronological roll: drop the oldest pair, append the new
            new_state["s_hist"] = state["s_hist"][1:] + [s]
            new_state["y_hist"] = state["y_hist"][1:] + [y]
            new_state["rho"] = state["rho"][1:] + [
                (1.0 / torch.clamp(sy, min=_MIN_CURVATURE)).to(f)]
            new_state["gamma"] = (
                sy / torch.clamp(yy, min=1e-30)).to(f)
        new_state["count"] = state["count"] + int(ok)
        new_state["nevals"] = state["nevals"] + n_ls
        new_state["value"] = value_t.to(f)
        new_state["grad"] = grad_t.to(f)
        new_state["ls_failed"] = state["ls_failed"] or not ok
        return x_new, new_state

    if dots is None:
        def dots(xs, ys):
            return [dot(a, b) for a, b in zip(xs, ys)]

    def _norms(x, state, split=False):
        """[||g||, ||x||] (+ [||x[d:]||, ||x[:d]||] with split), one batch."""
        vs = [state["grad"], x]
        if split:
            vs += [x[norm_split:], x[:norm_split]]
        return [torch.sqrt(v) for v in dots(vs, vs)]

    def _converged(gnorm, xnorm):
        return bool(gnorm <= conv_tol * torch.clamp(xnorm, min=1.0))

    def chunk(x, state, *extra):
        # the previous chunk left the norms of this (x, grad) in the
        # state: the same inputs, so the same bits
        if "norms" in state:
            gnorm, xnorm = state["norms"]
        else:
            gnorm, xnorm = _norms(x, state)
        recs = []
        for _ in range(steps_per_call):
            if _converged(gnorm, xnorm):
                state = dict(state, converged=True)
            if not (state["converged"] or state["ls_failed"]):
                x, state = step(x, state, extra)
            # the record reports the accepted new iterate; on a frozen
            # pass-through it repeats the current point. Convergence is
            # folded at the post-step iterate too, so a chunk whose last
            # step converges reports it.
            norms = _norms(x, state, split=norm_split is not None)
            gnorm, xnorm = norms[:2]
            if _converged(gnorm, xnorm):
                state = dict(state, converged=True)
            cols = [state["value"], gnorm, xnorm,
                    torch.tensor(float(state["ls_failed"]),
                                 device=x.device)] + norms[2:]
            recs.append(torch.stack([c.float() for c in cols]))
        state = dict(state, norms=(gnorm, xnorm))
        return x, state, torch.stack(recs)

    return chunk
