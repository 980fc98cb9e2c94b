"""K4's batch API and the parity LBFGS engine that uses it, on the CPU.

sequential_dots (a batch of independent FMA chains, one launch on the
card) must give, pair by pair, the bits of sequential_dot; the engine that
batches its independent dots and reuses the norms a chunk leaves in its
state must give bitwise the iterates and metric rows of the engine that
takes every dot one at a time and recomputes them (kept below as the
reference), and take fewer serial dots. Small shapes, float32 (the parity
mode's dtype), inputs made from a seed with numpy."""

import numpy as np
import pytest
import torch

from evcouplings_torch.kernels import seqdot
from evcouplings_torch.kernels.seqdot import (
    _sequential_dot_plain, sequential_dot, sequential_dots,
)
from evcouplings_torch.ops import lbfgs as tl


def _pairs(rng, sizes):
    return [(torch.from_numpy(rng.normal(size=n).astype(np.float32)),
             torch.from_numpy(rng.normal(size=n).astype(np.float32)))
            for n in sizes]


@pytest.mark.parametrize("sizes", [
    [0], [1], [4097], [5, 0, 33, 2048 * 3 + 7], [100] * 20,
], ids=["n0", "n1", "n4097", "mixed", "more_than_one_launch"])
def test_sequential_dots_equal_single_chains(sizes):
    pairs = _pairs(np.random.default_rng(len(sizes)), sizes)
    got = sequential_dots([p[0] for p in pairs], [p[1] for p in pairs])
    assert len(got) == len(sizes)
    for g, (x, y) in zip(got, pairs):
        assert g.dtype == torch.float32 and g.dim() == 0
        assert float(g) == float(_sequential_dot_plain(x, y))
        assert float(g) == float(sequential_dot(x, y))
    if sizes == [0]:
        assert float(got[0]) == 0.0


def test_sequential_dots_odd_offset_slices():
    # x[d:] of a flat parameter vector starts at byte offset 4 d: with d
    # odd it is not 16-byte aligned (the card stages it by 4-byte copies)
    rng = np.random.default_rng(7)
    v = torch.from_numpy(rng.normal(size=9001).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=9001).astype(np.float32))
    xs = [v[3:], v[:3], v[1:4097], v]
    ys = [w[:-3], w[5:8], v[2:4098], w]
    got = sequential_dots(xs, ys)
    for g, x, y in zip(got, xs, ys):
        assert float(g) == float(_sequential_dot_plain(x, y))


def test_sequential_dots_propagate_nan_and_inf():
    x = torch.tensor([1.0, float("nan"), 2.0])
    y = torch.ones(3)
    inf = torch.tensor([float("inf"), 1.0])
    got = sequential_dots([x, inf, inf], [y, torch.ones(2),
                                          torch.tensor([0.0, 1.0])])
    assert np.isnan(float(got[0]))
    assert float(got[1]) == float("inf")
    assert np.isnan(float(got[2]))   # inf * 0


def test_sequential_dots_refuse_bad_batches():
    with pytest.raises(ValueError):
        sequential_dots([], [])
    with pytest.raises(ValueError):
        sequential_dots([torch.ones(3)], [torch.ones(3), torch.ones(3)])
    with pytest.raises(ValueError):
        sequential_dots([torch.ones(3)], [torch.ones(4)])
    with pytest.raises(ValueError):
        sequential_dots([torch.ones(3, dtype=torch.float64)],
                        [torch.ones(3, dtype=torch.float64)])
    before = (seqdot.sequential_dots.launches, seqdot.sequential_dots.chains)
    sequential_dots([torch.ones(3)] * 3, [torch.ones(3)] * 3)
    assert (seqdot.sequential_dots.launches,
            seqdot.sequential_dots.chains) == before


def _unbatched_chunk(vg, *, steps_per_call=1, max_ls=tl._MAX_LS,
                     conv_tol=1e-5, norm_split=None, dot=torch.dot):
    """The engine as it was before batching: every dot one at a time, the
    chunk-start norms recomputed. Reference for the bitwise test."""

    def step(x, state, extra):
        d = tl._two_loop_direction(state, dot)
        value0, grad0 = state["value"], state["grad"]
        f = x.dtype
        dphi0 = dot(grad0, d)
        if bool(dphi0 >= 0):
            d = -grad0
            dphi0 = -dot(grad0, grad0)
        if state["count"] == 0:
            dnorm = torch.sqrt(dot(d, d))
            t = (1.0 / torch.clamp(dnorm, min=1e-30)).to(f)
        else:
            t = torch.ones((), dtype=f, device=x.device)
        eps_f = torch.finfo(f).eps
        t_eval, value_t, grad_t = t, value0, grad0
        ok = done = False
        n_ls = 0
        while not done and n_ls < max_ls:
            value_t, grad_t = vg(x + t * d, *extra)
            t_eval = t
            dphi = dot(grad_t, d)
            armijo = value_t <= value0 + tl._C1 * t * dphi0
            too_short = dphi < tl._C2 * dphi0
            overshoot = dphi > -tl._C2 * dphi0
            tiny = t * torch.abs(dphi0) <= eps_f * torch.abs(value0)
            armijo, too_short, overshoot, tiny = (
                bool(v) for v in torch.stack(
                    [armijo, too_short, overshoot, tiny]).tolist())
            ok = armijo and ((not too_short and not overshoot) or tiny)
            done = ok or (tiny and not armijo)
            if not armijo or overshoot:
                t = t * tl._SHRINK
            elif too_short:
                t = t * tl._GROW
            n_ls += 1
        if ok:
            t = t_eval
        else:
            t = torch.zeros((), dtype=f, device=x.device)
            value_t, grad_t = value0, grad0
        x_new = x + t * d
        s = t * d
        y = grad_t - grad0
        sy = dot(s, y)
        new_state = dict(state)
        if ok and bool(sy > tl._MIN_CURVATURE):
            new_state["s_hist"] = state["s_hist"][1:] + [s]
            new_state["y_hist"] = state["y_hist"][1:] + [y]
            new_state["rho"] = state["rho"][1:] + [
                (1.0 / torch.clamp(sy, min=tl._MIN_CURVATURE)).to(f)]
            new_state["gamma"] = (
                sy / torch.clamp(dot(y, y), min=1e-30)).to(f)
        new_state["count"] = state["count"] + int(ok)
        new_state["nevals"] = state["nevals"] + n_ls
        new_state["value"] = value_t.to(f)
        new_state["grad"] = grad_t.to(f)
        new_state["ls_failed"] = state["ls_failed"] or not ok
        return x_new, new_state

    def norms(x, state):
        return (torch.sqrt(dot(state["grad"], state["grad"])),
                torch.sqrt(dot(x, x)))

    def converged(gnorm, xnorm):
        return bool(gnorm <= conv_tol * torch.clamp(xnorm, min=1.0))

    def chunk(x, state, *extra):
        gnorm, xnorm = norms(x, state)
        recs = []
        for _ in range(steps_per_call):
            if converged(gnorm, xnorm):
                state = dict(state, converged=True)
            if not (state["converged"] or state["ls_failed"]):
                x, state = step(x, state, extra)
            gnorm, xnorm = norms(x, state)
            if converged(gnorm, xnorm):
                state = dict(state, converged=True)
            cols = [state["value"], gnorm, xnorm,
                    torch.tensor(float(state["ls_failed"]),
                                 device=x.device)]
            if norm_split is not None:
                h, J = x[norm_split:], x[:norm_split]
                cols.append(torch.sqrt(dot(h, h)))
                cols.append(torch.sqrt(dot(J, J)))
            recs.append(torch.stack([c.float() for c in cols]))
        return x, state, torch.stack(recs)

    return chunk


def _float32_quartic(n, seed):
    """sum a (x - c)^2 + b (x.x)^2 + x^T M x / 2 in float32 (the parity
    mode's arithmetic; the products are IEEE float32 on the CPU)."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy((rng.random(n) + 0.5).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    M = rng.normal(size=(n, n)) / n
    M = torch.from_numpy((M @ M.T).astype(np.float32))
    b = np.float32(0.05)

    def vg(x, scale):
        xx = torch.sum(x * x)
        value = scale * (torch.sum(a * (x - c) ** 2) + b * xx ** 2
                         + 0.5 * x @ (M @ x))
        grad = scale * (2 * a * (x - c) + 4 * b * xx * x + M @ x)
        return value, grad

    return vg


class _Counted:
    """A dot and its batch that count serial chains (calls) and dots."""

    def __init__(self):
        self.calls = self.dots = 0

    def dot(self, x, y):
        self.calls += 1
        self.dots += 1
        return sequential_dot(x, y)

    def batch(self, xs, ys):
        self.calls += 1
        self.dots += len(xs)
        return sequential_dots(xs, ys)


@pytest.mark.parametrize("norm_split", [None, 37], ids=["plain", "split"])
@pytest.mark.parametrize("steps_per_call", [1, 3])
def test_batched_engine_is_bitwise_the_unbatched_one(norm_split,
                                                     steps_per_call):
    n = 61
    vg = _float32_quartic(n, 4)
    scale = torch.tensor(np.float32(1.5))
    x0 = torch.from_numpy(
        np.random.default_rng(9).normal(size=n).astype(np.float32))
    ref, new = _Counted(), _Counted()
    chunk_ref = _unbatched_chunk(vg, steps_per_call=steps_per_call,
                                 conv_tol=1e-7, norm_split=norm_split,
                                 dot=ref.dot)
    chunk_new = tl.make_lbfgs_chunk(vg, steps_per_call=steps_per_call,
                                    conv_tol=1e-7, norm_split=norm_split,
                                    dot=new.dot, dots=new.batch)
    xr = xn = x0
    sr = tl.init_lbfgs_state(x0, *vg(x0, scale), m=4)
    sn = tl.init_lbfgs_state(x0, *vg(x0, scale), m=4)
    for _ in range(12 // steps_per_call):
        xr, sr, mr = chunk_ref(xr, sr, scale)
        xn, sn, mn = chunk_new(xn, sn, scale)
        assert torch.equal(xr, xn)
        assert torch.equal(mr, mn)
        for k in ("value", "grad", "gamma"):
            assert torch.equal(sr[k], sn[k]), k
        for k in ("count", "nevals", "converged", "ls_failed"):
            assert sr[k] == sn[k], k
        assert all(torch.equal(a, b) for a, b in zip(sr["rho"], sn["rho"]))
    assert sr["count"] >= 8   # the history was filled and rolled
    # fewer serial chains
    assert new.calls < ref.calls


def test_parity_fit_takes_batched_dots():
    from evcouplings_torch.ops.plm import _lbfgs_dots

    assert _lbfgs_dots(torch.float32, "highest") == (sequential_dot,
                                                     sequential_dots)
    assert _lbfgs_dots(torch.bfloat16, "default") == (torch.dot, None)
