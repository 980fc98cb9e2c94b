"""The port's LBFGS engine against the JAX engine, iterate by iterate, in
float64 on small smooth problems: x, the objective, the step length and
the newest curvature pair's rho must agree at every iteration, and the
linesearch must take the same number of trials.

Tolerance 1e-10 relative: the same arithmetic in another reduction order
(~1e-16). The fits stop at conv_tol 1e-6, before the gradient reaches
the rounding floor where the linesearch decisions become noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evcouplings_tpu.ops import lbfgs as jl
from evcouplings_torch.ops import lbfgs as tl


def _quartic(n, seed):
    """sum_i a_i (x_i - c_i)^2 + b (sum x^2)^2 + x^T M x / 2: smooth,
    strictly convex, with coupled coordinates."""
    rng = np.random.default_rng(seed)
    a = rng.random(n) + 0.5
    c = rng.normal(size=n)
    M = rng.normal(size=(n, n)) / n
    M = M @ M.T
    b = 0.05

    def arrays(xp):
        if xp is torch:
            return [torch.as_tensor(v) for v in (a, c, M)]
        return [jnp.asarray(v) for v in (a, c, M)]

    def f(xp, x):
        a_, c_, M_ = arrays(xp)
        return (xp.sum(a_ * (x - c_) ** 2) + b * xp.sum(x * x) ** 2
                + 0.5 * x @ (M_ @ x))

    def g(xp, x):
        a_, c_, M_ = arrays(xp)
        return 2 * a_ * (x - c_) + 4 * b * xp.sum(x * x) * x + M_ @ x

    return f, g, n


def _rosenbrock(n, seed):
    del seed

    def f(xp, x):
        return xp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                      + (1.0 - x[:-1]) ** 2)

    def g(xp, x):
        d1 = -400.0 * x[:-1] * (x[1:] - x[:-1] ** 2) - 2.0 * (1.0 - x[:-1])
        d2 = 200.0 * (x[1:] - x[:-1] ** 2)
        if xp is jnp:
            gr = jnp.zeros_like(x).at[:-1].add(d1).at[1:].add(d2)
        else:
            gr = torch.zeros_like(x)
            gr[:-1] += d1
            gr[1:] += d2
        return gr

    return f, g, n


@pytest.mark.parametrize("problem", [
    ("quartic", _quartic, 40, 0), ("quartic_m3", _quartic, 17, 3),
    ("rosenbrock", _rosenbrock, 6, 0),
], ids=lambda p: p[0])
def test_iterates_match_jax(problem):
    name, make, n, seed = problem
    f, g, n = make(n, seed)
    m = 3 if name.endswith("m3") else 5

    def vg_j(x):
        return f(jnp, x), g(jnp, x)

    def vg_t(x):
        return f(torch, x), g(torch, x)

    x0 = np.random.default_rng(seed + 11).normal(size=n)
    xj = jnp.asarray(x0)
    xt = torch.as_tensor(x0)
    sj = jl.init_lbfgs_state(xj, *vg_j(xj), m=m)
    st = tl.init_lbfgs_state(xt, *vg_t(xt), m=m)
    chunk_j = jax.jit(jl.make_lbfgs_chunk(vg_j, m=m, conv_tol=1e-6))
    chunk_t = tl.make_lbfgs_chunk(vg_t, m=m, conv_tol=1e-6)

    for it in range(20):
        xj2, sj, mj = chunk_j(xj, sj)
        xt2, st, mt = chunk_t(xt, st)
        x_j, x_t = np.asarray(xj2), xt2.numpy()
        np.testing.assert_allclose(x_t, x_j, rtol=1e-10, atol=1e-12,
                                   err_msg="x, iteration {}".format(it))
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(float(st["value"]), float(sj["value"]),
                                   rtol=1e-10, atol=1e-12)
        step_j = np.linalg.norm(x_j - np.asarray(xj))
        step_t = np.linalg.norm(x_t - xt.numpy())
        np.testing.assert_allclose(step_t, step_j, rtol=1e-9, atol=1e-14)
        np.testing.assert_allclose(float(st["rho"][-1]),
                                   float(sj["rho"][-1]), rtol=1e-9)
        assert st["count"] == int(sj["count"])
        assert st["nevals"] == int(sj["nevals"])
        assert st["ls_failed"] == bool(sj["ls_failed"])
        assert st["converged"] == bool(sj["converged"])
        xj, xt = xj2, xt2
        if st["converged"] or st["ls_failed"]:
            break


def test_constants_are_pinned():
    for k in ("_C1", "_C2", "_GROW", "_SHRINK", "_MIN_CURVATURE", "_MAX_LS"):
        assert getattr(tl, k) == getattr(jl, k), k


def test_chunk_of_several_steps_matches_single_steps():
    f, g, n = _quartic(12, 5)

    def vg_t(x):
        return f(torch, x), g(torch, x)

    x0 = torch.as_tensor(np.random.default_rng(0).normal(size=n))
    s1 = tl.init_lbfgs_state(x0, *vg_t(x0))
    s4 = dict(s1)
    one = tl.make_lbfgs_chunk(vg_t, conv_tol=1e-12)
    four = tl.make_lbfgs_chunk(vg_t, steps_per_call=4, conv_tol=1e-12)
    x1 = x0
    rows = []
    for _ in range(4):
        x1, s1, m1 = one(x1, s1)
        rows.append(m1[0])
    x4, s4, m4 = four(x0, s4)
    assert torch.equal(x1, x4)
    assert torch.equal(torch.stack(rows), m4)


@pytest.mark.parametrize("n", [143262, 11292960], ids=["golden", "L160"])
def test_sequential_dot_is_xla_cpu_dot(n):
    """XLA's CPU dot of two float32 vectors (the JAX engine's jnp.dot) is
    one FMA chain in index order: the port's sequential_dot (K4's host
    version), which parity mode uses, gives the same bits. Prints both
    errors against float64 (pytest -s)."""
    from evcouplings_torch.kernels.seqdot import sequential_dot

    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) ** 2).astype(np.float32)
    y = rng.random(n).astype(np.float32)
    xla = float(jnp.dot(jnp.asarray(x), jnp.asarray(y)))
    seq = float(sequential_dot(torch.from_numpy(x), torch.from_numpy(y)))
    assert seq == xla
    exact = float(np.dot(x.astype(np.float64), y.astype(np.float64)))
    print("n={}: sequential f32 dot rel err {:.2e}, torch.dot {:.2e}".format(
        n, (seq - exact) / exact,
        (float(torch.dot(torch.from_numpy(x), torch.from_numpy(y)))
         - exact) / exact))
