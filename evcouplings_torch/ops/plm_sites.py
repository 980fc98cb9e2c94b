"""
Asymmetric pseudolikelihood fit: L independent per-site regressions,
symmetrized once after the fit (port of evcouplings_tpu/ops/plm_sites.py).

Pseudolikelihood decomposes into one multinomial regression per site,
coupled only through the shared pair parameters of the symmetric fit
(ops/plm.py). Dropping that tie, each directed coupling J[r -> j] is
fitted on its own and the result is symmetrized as 0.5 (J + J^T): the
standard asymmetric pseudolikelihood (Ekeberg et al., J Comput Phys
2014). Its memory is the (Lq, Lq) directed matrix and its solver state,
so `parametrization="auto"` routes fits here when the symmetric fit's
estimate exceeds the device (couplings/fitter.py).

A step is one logits product one-hot @ J^T, the per-site softmax
residuals and one gradient product residual^T @ one-hot per row block
(torch.mm on cuBLAS: the JAX package computes these outside any Pallas
kernel too). Solvers: Adam (plain elementwise torch; the JAX asymmetric
path has no fused epilogue) and a batched per-site LBFGS in which every
site has its own history, linesearch step and convergence flag, every dot
reducing over that site's parameters only.

On a ("data", "model") mesh (evcouplings_torch.parallel.make_mesh_2d)
sites shard along "model": each rank owns the (L_loc q, L_pad q) row
block of J for its sites and their solver state (sites padded to a
multiple of the model-axis size), and rows shard along "data". A value
+gradient evaluation sums (per-site NLL, dJ, dh) over the "data" ranks by
one all-reduce; the aggregates of a step (value, ||g||^2, ||x||^2, ||h||^2,
||J||^2, the per-site LBFGS's active and failed site counts and its
linesearch passes) are summed over the "model" ranks by one all-reduce,
and no other collective crosses "model" during the fit. Without a mesh the
site shard is all sites.
"""

import os
import time

import numpy as np
import torch

from evcouplings_torch import parallel
from evcouplings_torch._device import matmul_precision, resolve_device
from evcouplings_torch.ops.encode import one_hot, unflatten_J
from evcouplings_torch.ops.lbfgs import (
    _C1, _C2, _GROW, _MAX_LS, _MIN_CURVATURE, _SHRINK,
)
from evcouplings_torch.ops.plm import (
    PlmConfig, PlmFitResult, _agree_on_resume, _bias_corrections,
    _check_ckpt_fingerprint, _checkpoint, _compute_dtype, _mm_acc,
    fit_fingerprint, write_snapshot,
)
from evcouplings_torch.ops.plm_update import ADAM_B1, ADAM_B2, ADAM_EPS

F32 = torch.float32

# per-site LBFGS state keys (each stored as "lbfgs_<key>" in snapshots)
_LBFGS_KEYS = ("s_hist", "y_hist", "rho", "gamma", "value", "grad",
               "converged", "ls_failed", "count", "nevals")
# Adam state order: (mu_J, nu_J, mu_h, nu_h, count)
_ADAM_KEYS = ("mu_J", "nu_J", "mu_h", "nu_h", "count")


def _pad_to(n, multiple):
    return -(-n // multiple) * multiple


def _site_mask(L, q, dtype, device, l_loc=None, m_idx=0):
    """(l_loc q, Lq) mask zeroing each local site's own q-block (no
    self-couplings); the local sites are [m_idx l_loc, (m_idx + 1) l_loc)
    of L (default: all)."""
    l_loc = L if l_loc is None else l_loc
    row = m_idx * l_loc + torch.arange(l_loc * q, device=device) // q
    col = torch.arange(L * q, device=device) // q
    return (row[:, None] != col[None, :]).to(dtype)


def _make_block_residual(L, q, l_loc=None, m_idx=0):
    """Per-block math of the asymmetric fit: logits product, per-site
    softmax, per-site block NLL, weighted residual, for the local sites
    [m_idx l_loc, (m_idx + 1) l_loc) of L (default: all).

    Returns block_residual(J_eff, h_c, rows, wb, oh) -> (nll_b (l_loc,)
    f32, this block's NLL per local site; residual (block, l_loc, q)
    f32)."""
    l_loc = L if l_loc is None else l_loc
    local = slice(m_idx * l_loc, (m_idx + 1) * l_loc)

    def block_residual(J_eff, h_c, rows, wb, oh):
        logits = (oh @ J_eff.T + h_c.reshape(l_loc * q)).reshape(
            -1, l_loc, q)
        logits = logits.to(F32)
        logp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
        tgt = rows[:, local]
        valid = (tgt >= 0).to(F32)
        oh_t = one_hot(tgt, q, dtype=F32)
        wv = wb[:, None] * valid
        nll_b = -torch.sum(wv * torch.sum(oh_t * logp, dim=-1), dim=0)
        r = (torch.exp(logp) - oh_t) * wv[..., None]
        return nll_b, r

    return block_residual


def _make_local_vg(L, q, cfg, two_phase=False, l_loc=None, m_idx=0,
                   mesh=None):
    """local_vg(J, h, codes, w, oh_all) -> (nll (l_loc,) f32 per local
    site, dJ (l_loc q, Lq) f32 with the self blocks masked, dh (l_loc, q)
    f32): the data term and its closed-form gradient for the local sites
    (default: all L), summed over the mesh's "data" ranks (one all-reduce)
    when a mesh is given.

    two_phase: the residuals of all blocks in the compute dtype, then ONE
    gradient product against the one-hot oh_all built once per fit;
    otherwise (carried) a one-hot per block and an f32 accumulator."""
    l_loc = L if l_loc is None else l_loc
    dtype = _compute_dtype(cfg.dtype)
    lq = L * q
    lq_loc = l_loc * q
    block = cfg.block_size
    block_residual = _make_block_residual(L, q, l_loc, m_idx)

    def local_vg(J, h, codes, w, oh_all=None):
        mask = _site_mask(L, q, dtype, J.device, l_loc, m_idx)
        J_eff = J.to(dtype) * mask
        h_c = h.to(dtype)
        n = codes.shape[0]
        nll = torch.zeros((l_loc,), dtype=F32, device=J.device)
        if two_phase:
            r_all = torch.empty((n, lq_loc), dtype=dtype, device=J.device)
            for start in range(0, n, block):
                sl = slice(start, start + block)
                nll_b, r = block_residual(J_eff, h_c, codes[sl], w[sl],
                                          oh_all[sl])
                nll = nll + nll_b
                r_all[sl] = r.reshape(-1, lq_loc).to(dtype)
            dJ = _mm_acc(r_all.T, oh_all, F32)
            dh = torch.sum(r_all.to(F32), dim=0).reshape(l_loc, q)
        else:
            dJ = torch.zeros((lq_loc, lq), dtype=F32, device=J.device)
            dh = torch.zeros((l_loc, q), dtype=F32, device=J.device)
            for start in range(0, n, block):
                rows = codes[start:start + block]
                oh = one_hot(rows, q, dtype=dtype).reshape(-1, lq)
                nll_b, r = block_residual(J_eff, h_c, rows,
                                          w[start:start + block], oh)
                nll = nll + nll_b
                dJ += _mm_acc(r.reshape(-1, lq_loc).to(dtype).T, oh, F32)
                dh += torch.sum(r, dim=0)
        dJ = dJ * _site_mask(L, q, F32, J.device, l_loc, m_idx)
        return parallel.all_reduce_many([nll, dJ, dh], mesh)

    return local_vg


def _group_terms(J, q, cfg):
    """Smoothed group-L1 over the directed (r, j) q x q blocks of the
    (l_loc q, Lq) rows J: (per-site value (l_loc,), gradient like J); the
    0.5 factor and epsilon of the symmetric path."""
    l_loc, L = J.shape[0] // q, J.shape[1] // q
    blocks = J.reshape(l_loc, q, L, q)
    norms = torch.sqrt(torch.sum(blocks ** 2, dim=(1, 3)) + cfg.group_eps)
    value = cfg.lambda_group * 0.5 * torch.sum(norms, dim=1)
    grad = (cfg.lambda_group * 0.5
            * blocks / norms[:, None, :, None]).reshape(J.shape)
    return value, grad


def _make_adam_chunk(L, q, cfg, two_phase=False, l_loc=None, m_idx=0,
                     mesh=None):
    """chunk(J, h, state, codes, w, oh_all) -> (J, h, state, metrics
    (steps, 5)): steps_per_call Adam steps on the local sites; rows
    [value, ||g||, ||x||, ||h||, ||J||] over all sites (summed over the
    mesh's "model" ranks, one all-reduce per step), value and gradient at
    the pre-step iterate."""
    steps = max(1, int(cfg.steps_per_call))
    local_vg = _make_local_vg(L, q, cfg, two_phase, l_loc, m_idx, mesh)

    def adam(p, g, mu, nu, bc1i, bc2i):
        mu = ADAM_B1 * mu + (1.0 - ADAM_B1) * g
        nu = ADAM_B2 * nu + (1.0 - ADAM_B2) * g * g
        p = p - cfg.adam_lr * (mu * bc1i) / (torch.sqrt(nu * bc2i)
                                              + ADAM_EPS)
        return p, mu, nu

    def chunk(J, h, state, codes, w, oh_all=None):
        mu_J, nu_J, mu_h, nu_h, cnt = state
        rows = []
        for _ in range(steps):
            nll, dJ, dh = local_vg(J, h, codes, w, oh_all)
            # l2 per DIRECTED coupling: each direction carries the full
            # lambda_J, so the post-fit average matches the symmetric
            # regularizer's scale
            dJ = dJ + 2.0 * cfg.lambda_J * J
            dh = dh + 2.0 * cfg.lambda_h * h
            reg = (cfg.lambda_J * torch.sum(J ** 2)
                   + cfg.lambda_h * torch.sum(h ** 2))
            if cfg.lambda_group > 0:
                g_value, g_grad = _group_terms(J, q, cfg)
                reg = reg + torch.sum(g_value)
                dJ = dJ + g_grad
            value = torch.sum(nll) + reg
            gsq = torch.sum(dJ ** 2) + torch.sum(dh ** 2)
            xsq = torch.sum(J ** 2) + torch.sum(h ** 2)
            cnt = cnt + 1
            bc1i, bc2i = _bias_corrections(cnt)
            J, mu_J, nu_J = adam(J, dJ, mu_J, nu_J, bc1i, bc2i)
            h, mu_h, nu_h = adam(h, dh, mu_h, nu_h, bc1i, bc2i)
            agg = parallel.all_reduce(torch.stack([
                value, gsq, xsq, torch.sum(h ** 2), torch.sum(J ** 2)]),
                mesh, parallel.MODEL_AXIS)
            rows.append(torch.stack([agg[0], *torch.sqrt(agg[1:])]))
        return J, h, (mu_J, nu_J, mu_h, nu_h, cnt), torch.stack(rows)

    return chunk


def _make_local_vg_site(L, q, cfg, l_loc=None, m_idx=0, mesh=None):
    """Per-site objective and gradient with the separable per-site
    regularizers included (added once, after the data term's sum over
    the "data" ranks):

        f_r = nll_r + lambda_J ||J_r||^2 + lambda_h ||h_r||^2
              [+ lambda_group * 0.5 * sum_j sqrt(||J_rj||^2 + eps)]

    Returns local_vg(J, h, codes, w) -> (f (l_loc,), dJ (l_loc q, Lq), dh
    (l_loc, q)), all f32, for the local sites (default: all L)."""
    local_vg = _make_local_vg(L, q, cfg, l_loc=l_loc, m_idx=m_idx,
                              mesh=mesh)

    def vg_site(J, h, codes, w):
        nll, dJ, dh = local_vg(J, h, codes, w)
        f = (nll + cfg.lambda_J * torch.sum(J.reshape(h.shape[0], -1) ** 2,
                                            dim=1)
             + cfg.lambda_h * torch.sum(h ** 2, dim=1))
        dJ = dJ + 2.0 * cfg.lambda_J * J
        dh = dh + 2.0 * cfg.lambda_h * h
        if cfg.lambda_group > 0:
            g_value, g_grad = _group_terms(J, q, cfg)
            f = f + g_value
            dJ = dJ + g_grad
        return f, dJ, dh

    return vg_site


def init_lbfgs_site_state(L, d_site, m, device=None):
    """Zero-initialized per-site LBFGS state (value and grad are filled by
    the first evaluation)."""
    return {
        "s_hist": torch.zeros((m, L, d_site), dtype=F32, device=device),
        "y_hist": torch.zeros((m, L, d_site), dtype=F32, device=device),
        "rho": torch.zeros((m, L), dtype=F32, device=device),
        "gamma": torch.ones((L,), dtype=F32, device=device),
        "value": torch.zeros((L,), dtype=F32, device=device),
        "grad": torch.zeros((L, d_site), dtype=F32, device=device),
        "converged": torch.zeros((L,), dtype=torch.bool, device=device),
        "ls_failed": torch.zeros((L,), dtype=torch.bool, device=device),
        "count": 0,
        "nevals": 0,
    }


def _make_lbfgs_site_chunk(L, q, cfg, l_loc=None, m_idx=0, mesh=None):
    """Batched per-site LBFGS: each site runs its own history, step size,
    libLBFGS strong-Wolfe linesearch (the rules and constants of
    ops/lbfgs.py) and convergence flag; a site whose search fails at
    float resolution freezes with its own ls_failed flag while the others
    go on. Each linesearch pass is one batched evaluation; resolved sites
    re-evaluate at their accepted point (same inputs, same bits) until all
    are resolved; the host reads one flag per pass.

    On a mesh the state holds the local sites; each evaluation sums the
    data term over the "data" ranks (the ranks of a "data" group hold the
    same sites, so their linesearches take the same passes), and the
    step's aggregates, its linesearch passes included, are summed over
    the "model" ranks by one all-reduce.

    Returns (chunk, init_vg): chunk(J, h, state, codes, w) -> (J, h,
    state, metrics (steps, 7)) with rows [value, ||g||, ||x||,
    n_unfrozen_sites, n_failed_sites, ||h||, ||J||] over all sites;
    init_vg(J, h, codes, w) -> (f, g), the carried evaluation of a fresh
    state.
    """
    l_loc = L if l_loc is None else l_loc
    m = cfg.memory_size
    lq = L * q
    d_j = q * lq
    steps = max(1, int(cfg.steps_per_call))
    vg_site = _make_local_vg_site(L, q, cfg, l_loc, m_idx, mesh)
    eps_f = torch.finfo(F32).eps

    def to_x(J, h):
        return torch.cat([J.to(F32).reshape(l_loc, d_j),
                          h.to(F32).reshape(l_loc, q)], dim=1)

    def from_x(x):
        return (x[:, :d_j].reshape(l_loc * q, lq),
                x[:, d_j:].reshape(l_loc, q))

    def vg_x(x, codes, w):
        J, h = from_x(x)
        f, dJ, dh = vg_site(J, h, codes, w)
        return f, torch.cat([dJ.reshape(l_loc, d_j),
                             dh.reshape(l_loc, q)], dim=1)

    def rowdot(a, b):
        return torch.sum(a * b, dim=1)

    def step(x, st, codes, w):
        frozen = st["converged"] | st["ls_failed"]
        g, f0 = st["grad"], st["value"]

        # batched two-loop over the per-site histories (chronological,
        # oldest first; empty slots have rho == 0)
        qv = g
        alphas = [None] * m
        for i in range(m - 1, -1, -1):
            alphas[i] = st["rho"][i] * rowdot(st["s_hist"][i], qv)
            qv = qv - alphas[i][:, None] * st["y_hist"][i]
        qv = qv * st["gamma"][:, None]
        for i in range(m):
            b = st["rho"][i] * rowdot(st["y_hist"][i], qv)
            qv = qv + (alphas[i] - b)[:, None] * st["s_hist"][i]
        d = -qv

        dphi0 = rowdot(g, d)
        bad = dphi0 >= 0
        d = torch.where(bad[:, None], -g, d)
        dphi0 = torch.where(bad, -rowdot(g, g), dphi0)
        d = torch.where(frozen[:, None], torch.zeros_like(d), d)

        if st["count"] == 0:
            dnorm = torch.sqrt(rowdot(d, d))
            t0 = 1.0 / torch.clamp(dnorm, min=1e-30)
        else:
            t0 = torch.ones((l_loc,), dtype=F32, device=x.device)
        t0 = torch.where(frozen, torch.zeros_like(t0), t0)

        # per-site linesearch, one batched evaluation per pass
        t_next, t, f_t, g_t = t0, t0, f0, g
        ok = torch.zeros((l_loc,), dtype=torch.bool, device=x.device)
        done = frozen
        n_ls = 0
        while n_ls < _MAX_LS and not bool(done.all()):
            t_eval = torch.where(done, t, t_next)
            f_e, g_e = vg_x(x + t_eval[:, None] * d, codes, w)
            dphi = rowdot(g_e, d)
            armijo = f_e <= f0 + _C1 * t_eval * dphi0
            too_short = dphi < _C2 * dphi0
            overshoot = dphi > -_C2 * dphi0
            tiny = t_eval * torch.abs(dphi0) <= eps_f * torch.abs(f0)
            ok_e = armijo & ((~too_short & ~overshoot) | tiny)
            fail_e = tiny & ~armijo

            upd = ~done
            t = torch.where(upd, t_eval, t)
            f_t = torch.where(upd, f_e, f_t)
            g_t = torch.where(upd[:, None], g_e, g_t)
            ok = ok | (upd & ok_e)
            done = done | (upd & (ok_e | fail_e))
            t_prop = torch.where(
                ~armijo | overshoot, t_eval * _SHRINK,
                torch.where(too_short, t_eval * _GROW, t_eval))
            t_next = torch.where(done, t, t_prop)
            n_ls += 1

        # per-site rounding failure / max_ls exhaustion: freeze
        ok = ok & ~frozen
        t = torch.where(ok, t, torch.zeros_like(t))
        f_t = torch.where(ok, f_t, f0)
        g_t = torch.where(ok[:, None], g_t, g)
        new_fail = ~ok & ~frozen

        s = t[:, None] * d
        x_new = x + s
        y = g_t - g
        sy = rowdot(s, y)
        accept = ok & (sy > _MIN_CURVATURE)
        s_roll = torch.cat([st["s_hist"][1:], s[None]], dim=0)
        y_roll = torch.cat([st["y_hist"][1:], y[None]], dim=0)
        rho_new = torch.where(
            accept, 1.0 / torch.clamp(sy, min=_MIN_CURVATURE),
            torch.zeros_like(sy))
        st_new = {
            "s_hist": torch.where(accept[None, :, None], s_roll,
                                  st["s_hist"]),
            "y_hist": torch.where(accept[None, :, None], y_roll,
                                  st["y_hist"]),
            "rho": torch.where(
                accept[None, :],
                torch.cat([st["rho"][1:], rho_new[None]], dim=0),
                st["rho"]),
            "gamma": torch.where(
                accept, sy / torch.clamp(rowdot(y, y), min=1e-30),
                st["gamma"]),
            "value": f_t,
            "grad": g_t,
            "converged": st["converged"],
            "ls_failed": st["ls_failed"] | new_fail,
            "count": st["count"] + 1,
            "nevals": st["nevals"],
        }
        return x_new, st_new, n_ls

    def fold_convergence(x, st):
        """Mark the sites that meet the gradient criterion at (x, st)."""
        gnorm = torch.sqrt(torch.sum(st["grad"] ** 2, dim=1))
        xnorm = torch.sqrt(torch.sum(x ** 2, dim=1))
        conv = gnorm <= cfg.conv_tol * torch.clamp(xnorm, min=1.0)
        return dict(st, converged=st["converged"] | conv)

    def chunk(J, h, st, codes, w):
        x = to_x(J, h)
        # convergence at the incoming iterate (a resumed converged
        # state) freezes those sites before the first step
        st = fold_convergence(x, st)
        rows = []
        for _ in range(steps):
            x, st, n_ls = step(x, st, codes, w)
            # folded at the post-step iterate, so the row of the step that
            # converges already reports n_unfrozen == 0
            st = fold_convergence(x, st)
            agg = parallel.all_reduce(torch.stack([
                torch.sum(st["value"]),
                torch.sum(st["grad"] ** 2),
                torch.sum(x ** 2),
                torch.sum((~(st["converged"] | st["ls_failed"])).to(F32)),
                torch.sum(st["ls_failed"].to(F32)),
                torch.sum(x[:, d_j:] ** 2),
                torch.sum(x[:, :d_j] ** 2),
                torch.tensor(float(n_ls), dtype=F32, device=x.device),
            ]), mesh, parallel.MODEL_AXIS)
            # each model shard's linesearch takes its own number of passes:
            # nevals counts them all, equal on every rank
            st = dict(st, nevals=st["nevals"] + int(agg[7]))
            rows.append(torch.stack([
                agg[0], torch.sqrt(agg[1]), torch.sqrt(agg[2]), agg[3],
                agg[4], torch.sqrt(agg[5]), torch.sqrt(agg[6])]))
        J2, h2 = from_x(x)
        return J2, h2, st, torch.stack(rows)

    def init_vg(J, h, codes, w):
        return vg_x(to_x(J, h), codes, w)

    return chunk, init_vg


def fit_plm_asym(codes, weights, num_symbols,
                 cfg=PlmConfig(solver="adam"), mesh=None, callback=None,
                 checkpoint_file=None, checkpoint_every=50, device=None):
    """Fit a Potts model by ASYMMETRIC pseudolikelihood maximization and
    symmetrize once at the end. Same inputs and outputs as
    ops.plm.fit_plm.

    Solvers: "adam" (elementwise, cheapest per step) or "lbfgs" (batched
    per-site LBFGS, _make_lbfgs_site_chunk). dtype "float32" or
    "bfloat16"; masters, optimizer state and accumulators are float32.

    mesh: a ("data", "model") mesh (evcouplings_torch.parallel
    .make_mesh_2d); every rank of it calls fit_plm_asym with the same
    arguments. Sites are padded to a multiple of the model-axis size and
    shard along "model", rows are padded to a multiple of block_size x
    the data-axis size (weight 0) and shard along "data"; every rank
    returns the same result.

    checkpoint_file: every checkpoint_every iterations the directed
    couplings, fields, the full solver state and the iteration count are
    written atomically (the JAX package's keys and fingerprint; the
    site-padded arrays, gathered over "model" and written by the mesh's
    first rank); an existing file resumes the fit bit for bit (with the
    same model-axis size and solver). device None is the mesh's device,
    else the CUDA device.
    """
    if cfg.solver not in ("adam", "lbfgs"):
        raise ValueError(
            "fit_plm_asym supports solver='adam' or 'lbfgs' "
            "(got {!r})".format(cfg.solver))
    if cfg.lambda_group > 0 and cfg.group_mode != "smoothed":
        raise ValueError(
            "fit_plm_asym only implements the SMOOTHED group-L1 "
            "approximation; lambda_group > 0 requires an explicit "
            "group_mode='smoothed' here, or the symmetric fit with "
            "solver='fista' for the exact penalty.")
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(
            "fit_plm_asym supports dtype 'float32' or 'bfloat16' (got "
            "{!r}); use the symmetric fit for float64 parity "
            "runs".format(cfg.dtype))
    if cfg.grad_layout not in ("auto", "carried", "two_phase"):
        raise ValueError("Unknown grad_layout: {}".format(cfg.grad_layout))
    # "auto" is the carried layout here (the JAX package measured the
    # two-phase layout as no win for this path)
    two_phase = cfg.grad_layout == "two_phase"
    if two_phase and cfg.solver == "lbfgs":
        raise ValueError(
            "grad_layout='two_phase' is not supported with solver='lbfgs' "
            "(the per-site engine uses the carried layout)")
    if mesh is not None and parallel.MODEL_AXIS not in mesh.shape:
        raise ValueError(
            "fit_plm_asym needs a ('data', 'model') mesh "
            "(parallel.make_mesh_2d), got the axes {}".format(
                mesh.axis_names))
    device = resolve_device(
        mesh.device if device is None and mesh is not None else device)

    codes = np.asarray(codes)
    weights = np.asarray(weights, dtype=np.float64)
    N, L = codes.shape
    q = int(num_symbols)
    if mesh is None:
        n_data = n_model = 1
        d_idx = m_idx = 0
    else:
        axes = (parallel.DATA_AXIS, parallel.MODEL_AXIS)
        n_data, n_model = (mesh.shape[a] for a in axes)
        d_idx, m_idx = (mesh.index(a) for a in axes)
    L_pad = _pad_to(L, n_model)
    l_loc = L_pad // n_model
    lq_pad = L_pad * q
    block = min(cfg.block_size, max(8, N))
    cfg = PlmConfig(**{**cfg.__dict__, "block_size": block})
    n_pad = _pad_to(max(N, block * n_data), block * n_data)
    n_loc = n_pad // n_data

    codes_p = np.full((n_pad, L_pad), -1, dtype=np.int8)
    codes_p[:N, :L] = codes
    w_p = np.zeros(n_pad, dtype=np.float32)
    w_p[:N] = weights
    rows = slice(d_idx * n_loc, (d_idx + 1) * n_loc)
    codes_d = torch.as_tensor(codes_p[rows], device=device)
    w_d = torch.as_tensor(w_p[rows], device=device)
    compute_dtype = _compute_dtype(cfg.dtype)
    sites = dict(l_loc=l_loc, m_idx=m_idx, mesh=mesh)

    J = torch.zeros((l_loc * q, lq_pad), dtype=F32, device=device)
    h = torch.zeros((l_loc, q), dtype=F32, device=device)
    d_site = q * lq_pad + q
    oh_d = None
    if cfg.solver == "adam":
        state = (torch.zeros_like(J), torch.zeros_like(J),
                 torch.zeros_like(h), torch.zeros_like(h), 0)
        adam_chunk = _make_adam_chunk(L_pad, q, cfg, two_phase, **sites)
        if two_phase:
            oh_d = one_hot(codes_d, q, dtype=compute_dtype).reshape(
                n_loc, lq_pad)

        def chunk(J, h, state):
            return adam_chunk(J, h, state, codes_d, w_d, oh_d)
    else:
        state = init_lbfgs_site_state(l_loc, d_site, cfg.memory_size,
                                      device)
        lb_chunk, init_vg = _make_lbfgs_site_chunk(L_pad, q, cfg, **sites)

        def chunk(J, h, state):
            return lb_chunk(J, h, state, codes_d, w_d)

    def model_sum(t):
        """A number summed over the "model" ranks (the local sites' share
        of an all-site total)."""
        return parallel.all_reduce(t.reshape(1), mesh,
                                   parallel.MODEL_AXIS)[0]

    start_iter = 0
    fingerprint = (fit_fingerprint(codes, weights, q, cfg, device, mesh)
                   if checkpoint_file is not None else None)
    needs_init_eval = cfg.solver == "lbfgs"
    have_ckpt = checkpoint_file is not None and os.path.exists(
        checkpoint_file)
    _agree_on_resume(mesh, checkpoint_file, have_ckpt)
    if have_ckpt:
        ckpt = np.load(checkpoint_file)
        _check_ckpt_fingerprint(ckpt, fingerprint, checkpoint_file)
        J, h, state, start_iter = _restore_asym_snapshot(
            ckpt, cfg, L_pad, q, device, checkpoint_file, l_loc, m_idx)
        needs_init_eval = False
        _agree_on_resume(mesh, checkpoint_file, start_iter=start_iter)

    save = None
    if checkpoint_file is not None:
        def save(J, h, state, iteration):
            # every rank takes part in the gathers, the first one writes
            arrays = _asym_snapshot_arrays(
                cfg.solver, *_gather_sites(J, h, state, l_loc, q, mesh),
                iteration, fingerprint)
            if mesh is None or mesh.is_writer:
                write_snapshot(checkpoint_file, arrays)

    t0 = time.time()
    table = []
    converged = ls_failed = stopped = False
    value = float("nan")
    it = last_ckpt = start_iter
    steps = max(1, int(cfg.steps_per_call))
    last_metrics = None
    with matmul_precision(cfg.precision):
        if needs_init_eval:
            f0, g0 = init_vg(J, h, codes_d, w_d)
            state = dict(state, value=f0, grad=g0)
        # a resumed per-site LBFGS state with every site frozen must not
        # run a chunk of pass-throughs (duplicate rows, a drifting
        # iteration count)
        if cfg.solver == "lbfgs" and start_iter > 0:
            frozen = state["converged"] | state["ls_failed"]
            if float(model_sum((~frozen).sum().to(F32))) == 0:
                stopped = True
                ls_failed = float(model_sum(
                    state["ls_failed"].sum().to(F32))) > 0
                converged = not ls_failed

        while it < cfg.max_iter and not stopped:
            n_steps = min(steps, cfg.max_iter - it)
            J, h, state, metrics = chunk(J, h, state)
            metrics = metrics.cpu().double().numpy()
            last_metrics = metrics
            now = time.time() - t0
            for k in range(n_steps):
                it += 1
                value, gnorm, xnorm = metrics[k][:3]
                rec = {"iter": it, "fx": value, "gnorm": gnorm,
                       "xnorm": xnorm, "hnorm": metrics[k][-2],
                       "Jnorm": metrics[k][-1], "time": now}
                table.append(rec)
                if callback is not None:
                    callback(rec)
                if cfg.solver == "lbfgs":
                    # columns 3 and 4: sites still active, sites frozen by
                    # a linesearch failure; converged iff every site met
                    # the gradient criterion
                    if metrics[k][3] == 0:
                        stopped = True
                        ls_failed = metrics[k][4] > 0
                        converged = not ls_failed
                        break
                elif gnorm <= cfg.conv_tol * max(1.0, xnorm):
                    converged = stopped = True
                    break
            last_ckpt = _checkpoint(save, it, last_ckpt, checkpoint_every,
                                    J, h, state)
        _checkpoint(save, it, last_ckpt, checkpoint_every, J, h, state,
                    final=True)

        if cfg.solver == "adam":
            # Adam rows record fx at the pre-update iterate: price the
            # parameters actually returned
            nll, _, _ = _make_local_vg(L_pad, q, cfg, **sites)(
                J, h, codes_d, w_d)
            reg = (cfg.lambda_J * torch.sum(J ** 2)
                   + cfg.lambda_h * torch.sum(h ** 2))
            if cfg.lambda_group > 0:
                reg = reg + torch.sum(_group_terms(J, q, cfg)[0])
            value = float(model_sum(torch.sum(nll) + reg))
        elif last_metrics is not None:
            # the final row prices the returned parameters
            value = float(last_metrics[-1][0])
        elif np.isnan(value):
            # the loop never ran: the state carries the current objective
            value = float(model_sum(torch.sum(state["value"].double())))

    J_pad, h_pad = _gather_sites(J, h, None, l_loc, q, mesh)[:2]
    lq = L * q
    J_dir = J_pad.detach().to("cpu", torch.float64).numpy().reshape(
        L_pad, q, L_pad, q)[:L, :, :L, :].reshape(lq, lq)
    return PlmFitResult(
        J_ij=unflatten_J(0.5 * (J_dir + J_dir.T), L, q),
        h_i=h_pad.detach().to("cpu", torch.float64).numpy()[:L],
        iteration_table=table, num_iter=it, converged=converged,
        final_loss=value, ls_failed=bool(ls_failed))


def _gather_sites(J, h, state, l_loc, q, mesh):
    """(J, h, state) of all (padded) sites from each rank's local sites:
    each rank places its rows in zeroed full arrays and one all-reduce per
    array over "model" sums them (exact: every entry has one nonzero
    term). Without a mesh, the arguments as they are."""
    if mesh is None:
        return J, h, state
    k = mesh.index(parallel.MODEL_AXIS)
    n_model = mesh.shape[parallel.MODEL_AXIS]

    def gather(t, dim, per_site):
        if not isinstance(t, torch.Tensor):
            return t
        shape = list(t.shape)
        shape[dim] *= n_model
        full = torch.zeros(shape, dtype=torch.int32 if t.dtype == torch.bool
                           else t.dtype, device=t.device)
        at = k * l_loc * per_site
        full.narrow(dim, at, t.shape[dim]).copy_(t)
        parallel.all_reduce(full, mesh, parallel.MODEL_AXIS)
        return full.bool() if t.dtype == torch.bool else full

    if isinstance(state, tuple):    # Adam: mu_J, nu_J, mu_h, nu_h, count
        state = tuple(gather(t, 0, q if i < 2 else 1)
                      for i, t in enumerate(state))
    elif state is not None:                 # per-site LBFGS
        dims = {"s_hist": 1, "y_hist": 1, "rho": 1}
        state = {key: gather(v, dims.get(key, 0), 1)
                 for key, v in state.items()}
    return gather(J, 0, q), gather(h, 0, 1), state


def _asym_snapshot_arrays(solver, J, h, state, iteration, fingerprint=None):
    """An asymmetric fit's snapshot arrays under the JAX package's keys:
    J (directed), h, iteration, fingerprint, and mu_J/nu_J/mu_h/nu_h/count
    (adam) or lbfgs_<key> (the per-site LBFGS state)."""
    arrays = {"J": J.detach().cpu().numpy(), "h": h.detach().cpu().numpy(),
              "iteration": np.asarray(iteration)}
    if fingerprint is not None:
        arrays["fingerprint"] = np.asarray(fingerprint)
    if solver == "adam":
        for k, v in zip(_ADAM_KEYS, state):
            arrays[k] = (np.asarray(v, dtype=np.int32) if k == "count"
                         else v.detach().cpu().numpy())
    else:
        for k in _LBFGS_KEYS:
            v = state[k]
            arrays["lbfgs_" + k] = (np.asarray(v, dtype=np.int32)
                                    if k in ("count", "nevals")
                                    else v.detach().cpu().numpy())
    return arrays


def _restore_asym_snapshot(ckpt, cfg, L, q, device, name="snapshot",
                           l_loc=None, m_idx=0):
    """(J, h, solver state, iteration) from an asymmetric fit's snapshot
    arrays, for the local sites [m_idx l_loc, (m_idx + 1) l_loc) of the L
    (padded) sites (default: all); ValueError where they cannot resume
    this fit."""
    lq = L * q
    l_loc = L if l_loc is None else l_loc
    files = set(ckpt.files if hasattr(ckpt, "files") else ckpt)
    if ckpt["J"].shape != (lq, lq):
        raise ValueError(
            "Checkpoint {} does not match the problem shape (L={}, "
            "q={})".format(name, L, q))
    local = slice(m_idx * l_loc, (m_idx + 1) * l_loc)
    local_q = slice(m_idx * l_loc * q, (m_idx + 1) * l_loc * q)

    def put(a, dtype=F32):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    if cfg.solver == "adam":
        if "mu_J" not in files:
            raise ValueError(
                "Checkpoint {} carries no Adam state: it cannot resume an "
                "asymmetric adam fit (was it written by the lbfgs solver or "
                "the symmetric fitter?)".format(name))
        state = tuple(put(ckpt[k][local_q if k.endswith("J") else local])
                      for k in _ADAM_KEYS[:4]) + (int(ckpt["count"]),)
    else:
        missing = {"lbfgs_" + k for k in _LBFGS_KEYS} - files
        if missing:
            raise ValueError(
                "Checkpoint {} carries no per-site LBFGS state ({} "
                "missing): it cannot resume an asymmetric lbfgs "
                "fit".format(name, sorted(missing)))
        d_site = q * lq + q
        if ckpt["lbfgs_s_hist"].shape != (cfg.memory_size, L, d_site):
            raise ValueError(
                "Checkpoint {} LBFGS history shape {} does not match (m={}, "
                "L={}, D={})".format(name, ckpt["lbfgs_s_hist"].shape,
                                     cfg.memory_size, L, d_site))
        state = {}
        for k in _LBFGS_KEYS:
            v = ckpt["lbfgs_" + k]
            if k in ("count", "nevals"):
                state[k] = int(v)
                continue
            v = v[:, local] if k in ("s_hist", "y_hist", "rho") else v[local]
            state[k] = put(v, torch.bool if k in ("converged", "ls_failed")
                           else F32)
    return (put(ckpt["J"][local_q]), put(ckpt["h"][local]), state,
            int(ckpt["iteration"]))
