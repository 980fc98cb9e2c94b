"""
Pseudolikelihood-maximization (PLM) Potts-model fit, the in-process
replacement for the external `plmc` binary (port of the symmetric fit in
evcouplings_tpu/ops/plm.py).

Model
-----
P(x_r = a | x_{-r}) = softmax_a( h_r(a) + sum_{j != r} J_rj(a, x_j) )

loss(h, J) = - sum_s w_s sum_r log P(x_sr | x_s,-r)
             + lambda_h ||h||^2 + lambda_J sum_{i<j} ||J_ij||^2
             [+ lambda_group * sum_{i<j} sqrt(||J_ij||^2 + group_eps)]

Layout
------
- The couplings are one flat (Lq, Lq) matrix with
  J_flat[(r,a),(j,b)] = J[r,j,a,b]; pair symmetry is matrix symmetry.
  Fits start from zero and every update is symmetric, so J_eff = P * mask
  with the L diagonal q x q blocks masked to zero.
- The fields ride as row Lq of an augmented matrix J_aug (Lq_aug, Lq),
  and each one-hot row gets a ones column: the conditional logits of a
  block of sequences are ONE product [onehot | 1 | 0] @ J_aug, and the
  whole NLL gradient is ONE product r^T @ [onehot | 1 | 0] with the
  softmax residual r = w * (softmax * m - onehot), in closed form.
- Gradient accumulation: "carried" adds each block's product into an
  (Lq, Lq_aug) accumulator; "two_phase" keeps the residuals of all
  blocks and takes one product over all rows against a one-hot built
  once per fit.

Precision
---------
dtype "float32" with precision "highest" is the parity mode: IEEE
float32 products (TF32 off, set for the fit's duration and restored).
"high"/"default" allow TF32. dtype "bfloat16" is the production mode:
bf16 operands, with float32 outputs on the gradient products
(torch.mm(..., out_dtype=float32) on the card; the CPU upcasts the
operands instead), while the logits product keeps the compute dtype.
Master parameters, optimizer moments and weights stay float32.

Solvers: "lbfgs" (ops/lbfgs.py) and "adam" (the optax.adam formula;
with fused_update="on" the epilogue of each step is K2, the Triton
kernel behind ops/plm_update.fused_adam_update).
"""

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from evcouplings_torch._device import matmul_precision, resolve_device
from evcouplings_torch.kernels.seqdot import sequential_dot
from evcouplings_torch.ops.encode import one_hot, pad_rows, unflatten_J
from evcouplings_torch.ops.lbfgs import init_lbfgs_state, make_lbfgs_chunk
from evcouplings_torch.ops.plm_update import (
    ADAM_B1, ADAM_B2, ADAM_EPS, fused_adam_update,
)


@dataclass(frozen=True)
class PlmConfig:
    """Fit hyperparameters (mirrors the plmc CLI surface; the same
    fields and defaults as the JAX package's PlmConfig).

    lambda_J is the per-pair l2 strength AFTER any (q-1)(L-1) scaling
    done by the calling protocol.
    """
    lambda_h: float = 0.01
    lambda_J: float = 16.0
    lambda_group: float = 0.0
    # group-L1 semantics when lambda_group > 0: "prox" is the exact
    # nonsmooth penalty (solver "fista", not ported yet); "smoothed" is
    # sqrt(||J_ij||^2 + group_eps) with lbfgs/adam
    group_mode: str = "prox"
    group_eps: float = 1e-12
    max_iter: int = 100
    conv_tol: float = 1e-5          # ||g|| <= tol * max(1, ||x||)
    memory_size: int = 5
    solver: str = "lbfgs"           # "lbfgs" | "adam" | "fista"
    adam_lr: float = 5e-3
    block_size: int = 512
    # "float32" (+ precision "highest") is the parity mode; "bfloat16"
    # the production mode (f32 masters); "float64" for oracle tests
    dtype: str = "float32"
    precision: str = "highest"      # highest | high | default
    # optimizer steps per chunk; convergence is checked per step
    # inside a chunk and the table is truncated at the first converged
    # iteration
    steps_per_call: int = 1
    # "carried" | "two_phase" | "auto" (two_phase iff bf16, blocks >=
    # 2048 and the one-hot fits _ONEHOT_HBM_BUDGET)
    grad_layout: str = "auto"
    # Adam epilogue through K2: "on" | "off" | "auto" (off; see
    # _resolve_fused_update)
    fused_update: str = "auto"


_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
}

# lower clamp on (logits - rowmax) before exp. The shift is the whole
# row's max, so a site whose logits all sit far below it could underflow
# its whole q-segment to zero (Z = 0 -> inf residuals). exp(-80) is a
# normal number in f32 and bf16, so Z >= q exp(-80) > 0; for any site
# within ~80 nats of the row max the clamp only touches lanes below f32
# resolution.
_SOFTMAX_SHIFT_FLOOR = -80.0

# memory budget for the static augmented one-hot of the two-phase
# layout (the residual buffer is the same size again)
_ONEHOT_HBM_BUDGET = 2 * 1024 ** 3


def _compute_dtype(name):
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError("Unknown dtype: {!r} (valid: {})".format(
            name, ", ".join(_DTYPES))) from None


def _acc_dtype(dtype):
    """Accumulator / master dtype: f32, or f64 for float64 runs."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _mm_acc(a, b, acc):
    """a @ b with the output in `acc`. bf16 operands keep their type on
    the card (torch.mm with out_dtype: f32 accumulation and output); the
    CPU has no such kernel and upcasts the operands, which is exact for
    the products and accumulates in f32 as well."""
    if a.dtype == acc:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=acc)
    return a.to(acc) @ b.to(acc)


def _diag_block_mask(L, q, dtype, device):
    """(Lq, Lq) mask that zeroes the L diagonal q x q blocks."""
    site = torch.arange(L * q, device=device) // q
    return (site[:, None] != site[None, :]).to(dtype)


def _augmented_width(lq):
    """Width of the ones-augmented one-hot: Lq + 1 rounded up to a
    multiple of 128, so the contraction dimension of the logits product
    stays aligned (the zero padding costs ~3% extra flops at L=160)."""
    return max(lq + 1, ((lq + 1 + 127) // 128) * 128)


def build_augmented_onehot(codes, q, dtype):
    """(N, Lq_aug) [onehot | 1 | 0...] of an int code tensor, on its
    device. Entries of -1 (gap / padding) one-hot to the zero vector."""
    n, L = codes.shape
    lq = L * q
    out = torch.zeros((n, _augmented_width(lq)), dtype=dtype,
                      device=codes.device)
    out[:, :lq] = one_hot(codes, q, dtype=dtype).reshape(n, lq)
    out[:, lq] = 1
    return out


def _assemble_aug_rows(J_eff, h_row, lq, lq_aug):
    """J_aug row layout: J_eff rows, the fields as row Lq, zero rows up
    to lq_aug."""
    out = torch.zeros((lq_aug, lq), dtype=J_eff.dtype, device=J_eff.device)
    out[:lq] = J_eff
    out[lq] = h_row.reshape(lq)
    return out


def _build_j_aug(params, L, q, dtype, lq_aug, symmetric=False):
    """Augmented coupling matrix (Lq_aug, Lq) in the compute dtype.

    symmetric=True asserts that P is exactly symmetric (true inside
    fits) and skips the transposed read: P * mask == 0.5 (P + P^T) * mask
    bitwise on symmetric P."""
    lq = L * q
    P_c = params["J"].to(dtype)
    mask = _diag_block_mask(L, q, dtype, P_c.device)
    if symmetric:
        J_eff = P_c * mask
    else:
        J_eff = 0.5 * (P_c + P_c.T) * mask
    return _assemble_aug_rows(J_eff, params["h"].to(dtype), lq, lq_aug)


def _block_nll_residual(J_aug, oh_aug, c, w, L, q, acc):
    """(block NLL contribution, residual r) for one row block.

    oh_aug: (B, Lq_aug) augmented one-hot of codes c; w already in the
    compute dtype. The per-site softmax sums are reductions over each
    site's q lanes (the JAX package takes them as products against a
    0/1 segment matrix; the sums are the same)."""
    lq = L * q
    B = oh_aug.shape[0]
    oh = oh_aug[:, :lq]

    logits = oh_aug @ J_aug
    rowmax = logits.amax(dim=1, keepdim=True)
    e = torch.exp(torch.clamp(logits - rowmax, min=_SOFTMAX_SHIFT_FLOOR))
    Z = e.reshape(B, L, q).sum(dim=2, dtype=acc)

    # sum_r log P(x_sr|..) = sum_r [logit_obs - rowmax - log Z_r], with
    # m zeroing gap / padding positions
    m_acc = (c >= 0).to(acc)
    obs = (oh * logits).sum(dim=1).to(acc)
    logZ = ((torch.log(Z) + rowmax.to(acc)) * m_acc).sum(dim=1)
    nll_b = -torch.dot(w.to(acc), obs - logZ)

    # r = w * (softmax * m - oh)
    rz = (m_acc / Z).to(logits.dtype)
    bcast = rz.repeat_interleave(q, dim=1)
    r = w[:, None] * (e * bcast - oh)
    return nll_b, r


def _check_rows(n_pad, block_size):
    if n_pad % block_size:
        raise ValueError(
            "codes rows ({}) must be a multiple of block_size ({}): the "
            "block loop would drop the remainder rows. Pad with code -1 "
            "/ weight-0 rows (ops.encode.pad_rows) as fit_plm does."
            .format(n_pad, block_size))


def _local_vg_carried(J_aug, codes, weights, L, q, block_size, acc):
    n_pad = codes.shape[0]
    _check_rows(n_pad, block_size)
    dtype = J_aug.dtype
    lq = L * q
    nll = torch.zeros((), dtype=acc, device=J_aug.device)
    dJh = torch.zeros((lq, J_aug.shape[0]), dtype=acc, device=J_aug.device)
    for start in range(0, n_pad, block_size):
        c = codes[start:start + block_size]
        w = weights[start:start + block_size].to(dtype)
        oh_aug = build_augmented_onehot(c, q, dtype)
        nll_b, r = _block_nll_residual(J_aug, oh_aug, c, w, L, q, acc)
        nll = nll + nll_b
        dJh += _mm_acc(r.T, oh_aug, acc)
    return nll, dJh


def _local_vg_two_phase(J_aug, codes, weights, oh_all, L, q, block_size,
                        acc):
    n_pad = codes.shape[0]
    _check_rows(n_pad, block_size)
    dtype = J_aug.dtype
    lq = L * q
    nll = torch.zeros((), dtype=acc, device=J_aug.device)
    r_all = torch.empty((n_pad, lq), dtype=dtype, device=J_aug.device)
    for start in range(0, n_pad, block_size):
        sl = slice(start, start + block_size)
        nll_b, r_all[sl] = _block_nll_residual(
            J_aug, oh_all[sl], codes[sl], weights[sl].to(dtype), L, q, acc)
        nll = nll + nll_b
    return nll, _mm_acc(r_all.T, oh_all, acc)


def _resolve_grad_layout(cfg, dtype, local_rows, lq_aug):
    """Pick the dJh accumulation layout (see PlmConfig.grad_layout)."""
    if cfg.grad_layout != "auto":
        if cfg.grad_layout not in ("carried", "two_phase"):
            raise ValueError(
                "Unknown grad_layout: {}".format(cfg.grad_layout))
        return cfg.grad_layout
    onehot_bytes = local_rows * lq_aug * dtype.itemsize
    if (dtype == torch.bfloat16 and onehot_bytes <= _ONEHOT_HBM_BUDGET
            and cfg.block_size >= 2048):
        return "two_phase"
    return "carried"


def device_hbm_budget(device=None):
    """Device memory budget in bytes for the preflight router
    (couplings/fitter.py parametrization="auto").

    EVCOUPLINGS_HBM_BYTES overrides; on a CUDA device the card's total
    memory (torch.cuda.mem_get_info); otherwise 16 GiB.
    """
    env = os.environ.get("EVCOUPLINGS_HBM_BYTES")
    if env:
        return int(float(env))
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.mem_get_info(torch.device(device))[1])
    return 16 * 1024 ** 3


def estimate_fit_hbm_bytes(n, l, q, cfg, parametrization="symmetric",
                           n_data_shards=1, n_model_shards=1):
    """Rough peak device-memory estimate of a PLM fit, in bytes.

    Counts the resident arrays of the chosen path (master parameters,
    gradient, optimizer state, the grad-layout working set, codes /
    one-hot inputs) plus 25% allocator slack; treat as +-30%.
    """
    f32 = 4
    comp = 2 if cfg.dtype == "bfloat16" else 4
    lq = l * q
    lq_aug = _augmented_width(lq)
    n_loc = -(-n // max(1, n_data_shards))
    codes_bytes = n_loc * l

    if parametrization == "asymmetric":
        l_loc = -(-l // max(1, n_model_shards))
        d = l_loc * q * lq_aug
        params = d * f32
        grad = d * f32
        if cfg.solver == "lbfgs":
            opt = (2 * cfg.memory_size + 4) * d * f32
        else:
            opt = 2 * d * f32
        onehot = n_loc * lq_aug * comp
        act = cfg.block_size * (lq_aug + l_loc * q) * comp
        total = params + grad + opt + onehot + act + codes_bytes
    else:
        d = lq * lq_aug
        params = d * f32
        grad = d * f32
        if cfg.solver == "lbfgs":
            opt = (2 * cfg.memory_size + 4) * d * f32
        else:
            opt = 2 * d * f32
        layout = _resolve_grad_layout(
            cfg, torch.bfloat16 if cfg.dtype == "bfloat16"
            else torch.float32, n_loc, lq_aug)
        if layout == "two_phase":
            work = 2 * n_loc * lq_aug * comp
        else:
            work = d * f32 + 2 * cfg.block_size * lq_aug * comp
        total = params + grad + opt + work + codes_bytes

    return int(total * 1.25)


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "mesh (row-sharded multi-device fits) is not ported yet "
            "(ROADMAP A18)")


def make_plm_nll_vg(L, q, cfg, mesh=None):
    """Build nll_vg(J_aug, codes, weights, oh_aug) -> (nll, dJh): the
    data term and its raw closed-form gradient product (dJ_eff in
    columns :Lq, dh in column Lq)."""
    _no_mesh(mesh)
    dtype = _compute_dtype(cfg.dtype)
    acc = _acc_dtype(dtype)
    lq_aug = _augmented_width(L * q)

    def nll_vg(J_aug, codes, weights, oh_aug=None):
        layout = _resolve_grad_layout(cfg, dtype, codes.shape[0], lq_aug)
        if layout == "two_phase":
            if oh_aug is None:
                oh_aug = build_augmented_onehot(codes, q, dtype)
            return _local_vg_two_phase(J_aug, codes, weights, oh_aug, L, q,
                                       cfg.block_size, acc)
        return _local_vg_carried(J_aug, codes, weights, L, q,
                                 cfg.block_size, acc)

    return nll_vg


def make_plm_value_and_grad(L, q, cfg, mesh=None, symmetric_params=False):
    """Build vg(params, codes, weights, oh_aug=None) -> (loss, grads):
    the NLL gradient in closed form and the regularizer terms in closed
    form (the lambda_J l2 gradient through the symmetric gauge is
    0.5 ((dJ + lambda_J P) + (dJ + lambda_J P)^T) * mask).

    params: {"J": (Lq, Lq), "h": (L, q)} tensors; codes (N_pad, L) int8
    and weights (N_pad,) tensors on the same device.
    """
    dtype = _compute_dtype(cfg.dtype)
    acc = _acc_dtype(dtype)
    lq = L * q
    lq_aug = _augmented_width(lq)
    nll_vg = make_plm_nll_vg(L, q, cfg, mesh=mesh)

    def vg(params, codes, weights, oh_aug=None):
        J_aug = _build_j_aug(params, L, q, dtype, lq_aug,
                             symmetric=symmetric_params)
        J_eff = J_aug[:lq]
        h_c = J_aug[lq]

        nll, dJh = nll_vg(J_aug, codes, weights, oh_aug)
        dJ_eff = dJh[:, :lq]
        dh = dJh[:, lq]

        # l2 value on the compute-dtype matrix (the rounding the JAX
        # package uses); gradients in closed form from the masters
        reg_value = (
            cfg.lambda_h * torch.sum(h_c.to(acc) ** 2)
            + cfg.lambda_J * 0.5 * torch.sum(J_eff.to(acc) ** 2)
        )

        P_f = params["J"].to(acc)
        S = dJ_eff + cfg.lambda_J * P_f
        mask_f = _diag_block_mask(L, q, acc, P_f.device)
        if cfg.lambda_group > 0:
            blocks_v = J_eff.to(acc).reshape(L, q, L, q)
            reg_value = reg_value + cfg.lambda_group * 0.5 * torch.sum(
                torch.sqrt(torch.sum(blocks_v ** 2, dim=(1, 3))
                           + cfg.group_eps))
            blocks = (0.5 * (P_f + P_f.T) * mask_f).reshape(L, q, L, q)
            norms = torch.sqrt(torch.sum(blocks ** 2, dim=(1, 3))
                               + cfg.group_eps)
            S = S + (cfg.lambda_group * 0.5
                     * blocks / norms[:, None, :, None]).reshape(lq, lq)
        dP = 0.5 * (S + S.T) * mask_f

        value = nll + reg_value.to(acc)
        grads = {
            "J": dP.to(params["J"].dtype),
            "h": (dh.reshape(L, q) + 2.0 * cfg.lambda_h
                  * params["h"].to(acc)).to(params["h"].dtype),
        }
        return value, grads

    return vg


def _resolve_fused_update(cfg, mesh, master_dtype):
    """Whether the Adam steps run their epilogue through K2.

    "auto" resolves to off, with the JAX package's meaning; "on"
    requires the adam solver, lambda_group == 0, float32 masters and no
    mesh. On a CUDA device "on" launches K2; on the CPU it runs K2's
    plain version.
    """
    if cfg.fused_update == "off":
        return False
    eligible = (cfg.solver == "adam" and cfg.lambda_group == 0
                and master_dtype == torch.float32 and mesh is None)
    if cfg.fused_update == "on":
        if not eligible:
            raise ValueError(
                "fused_update='on' requires the adam solver, "
                "lambda_group=0, float32 master parameters, and no mesh")
        return True
    if cfg.fused_update != "auto":
        raise ValueError("Unknown fused_update: {}".format(cfg.fused_update))
    return False


def _lbfgs_dot(compute_dtype, precision):
    """The LBFGS engine's dot product. Parity mode (float32, precision
    "highest") takes every dot as one fused multiply-add chain in index
    order (K4 on the card), the arithmetic of the JAX engine on the CPU:
    the 40-iteration golden fit moves by ~1e-3 under any other summation
    order. Every other mode uses torch.dot."""
    if compute_dtype == torch.float32 and precision.startswith("highest"):
        return sequential_dot
    return torch.dot


def _tree_norm(params):
    return torch.sqrt(sum(torch.sum(v * v) for v in params.values()))


def _metric_row(value, gnorm, xnorm, params):
    return torch.stack([
        value.float(), gnorm.float(), xnorm.float(),
        torch.linalg.vector_norm(params["h"]).float(),
        torch.linalg.vector_norm(params["J"]).float(),
    ])


def _make_adam_step(vg_fn, cfg):
    """One unfused Adam step: optax.adam's scale_by_adam (eps_root 0)
    followed by scaling with -lr."""

    def step(params, state, codes, weights, oh_aug):
        value, grad = vg_fn(params, codes, weights, oh_aug)
        count = state["count"] + 1
        mu, nu, new = {}, {}, {}
        for k in ("J", "h"):
            g = grad[k]
            mu[k] = (1.0 - ADAM_B1) * g + ADAM_B1 * state["mu"][k]
            nu[k] = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * state["nu"][k]
            mu_hat = mu[k] / (1.0 - ADAM_B1 ** count)
            nu_hat = nu[k] / (1.0 - ADAM_B2 ** count)
            upd = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)
            new[k] = params[k] + (-cfg.adam_lr) * upd
        state = {"count": count, "mu": mu, "nu": nu}
        return new, state, _metric_row(value, _tree_norm(grad),
                                       _tree_norm(new), new)

    return step


def _bias_corrections(count):
    """Inverse Adam bias corrections 1/(1 - b^t), in float32."""
    cf = np.float32(count)
    one = np.float32(1.0)
    return (float(one / (one - np.float32(ADAM_B1) ** cf)),
            float(one / (one - np.float32(ADAM_B2) ** cf)))


def _make_fused_adam_step(nll_vg, L, q, cfg, dtype):
    """Adam step with the fused epilogue: the products give (nll, dJh),
    then one pass of K2 (fused_adam_update) does symmetrize + l2 + Adam
    + the next step's compute-dtype couplings. The augmented matrix is
    carried across steps in state["J_aug"], never rebuilt from the f32
    masters. Matches the unfused step up to float rounding."""
    lq = L * q

    def step(params, state, codes, weights, oh_aug):
        J_aug = state["J_aug"]
        nll, dJh = nll_vg(J_aug, codes, weights, oh_aug)
        value = (nll
                 + cfg.lambda_h * torch.sum(J_aug[lq].float() ** 2)
                 + cfg.lambda_J * 0.5 * torch.sum(J_aug[:lq].float() ** 2))

        count = state["count"] + 1
        bc1i, bc2i = _bias_corrections(count)
        P2, mu2, nu2, J_eff2, gsq = fused_adam_update(
            dJh, params["J"], state["mu"]["J"], state["nu"]["J"],
            bc1i, bc2i, q=q, lambda_j=cfg.lambda_J, lr=cfg.adam_lr,
            out_dtype=dtype)

        # fields: a plain (L, q)-sized Adam update
        g_h = dJh[:, lq].reshape(L, q) + 2.0 * cfg.lambda_h * params["h"]
        mu_h = ADAM_B1 * state["mu"]["h"] + (1.0 - ADAM_B1) * g_h
        nu_h = ADAM_B2 * state["nu"]["h"] + (1.0 - ADAM_B2) * g_h ** 2
        h2 = params["h"] - cfg.adam_lr * (mu_h * bc1i) / (
            torch.sqrt(nu_h * bc2i) + ADAM_EPS)

        new = {"J": P2, "h": h2}
        state = {
            "count": count,
            "mu": {"J": mu2, "h": mu_h},
            "nu": {"J": nu2, "h": nu_h},
            "J_aug": _assemble_aug_rows(J_eff2, h2.to(dtype), lq,
                                        J_aug.shape[0]),
        }
        gnorm = torch.sqrt(gsq[0, 0] + torch.sum(g_h ** 2))
        return new, state, _metric_row(value, gnorm, _tree_norm(new), new)

    return step


@dataclass
class PlmFitResult:
    J_ij: np.ndarray            # (L, L, q, q) float64, zero diagonal
    h_i: np.ndarray             # (L, q) float64
    iteration_table: list       # list of per-iteration dict records
    num_iter: int
    converged: bool
    final_loss: float
    # linesearch stopped at floating-point resolution before the
    # gradient criterion was met; mutually exclusive with converged
    ls_failed: bool = False


def _check_config(cfg, mesh, checkpoint_file):
    if cfg.group_mode not in ("prox", "smoothed"):
        raise ValueError("Unknown group_mode: {}".format(cfg.group_mode))
    if cfg.solver not in ("lbfgs", "adam", "fista"):
        raise ValueError("Unknown solver: {}".format(cfg.solver))
    if (cfg.lambda_group > 0 and cfg.solver == "fista"
            and cfg.group_mode == "smoothed"):
        raise ValueError(
            "solver='fista' implements the EXACT nonsmooth group-L1 "
            "penalty and cannot apply the smoothed approximation; use "
            "solver='lbfgs' or 'adam' with group_mode='smoothed'.")
    if (cfg.lambda_group > 0 and cfg.solver != "fista"
            and cfg.group_mode != "smoothed"):
        raise ValueError(
            "lambda_group > 0 with solver '{}' would silently apply the "
            "SMOOTHED group-L1 approximation, not the exact nonsmooth "
            "penalty. Opt in to the smooth approximation explicitly "
            "with group_mode='smoothed' (the exact penalty needs solver "
            "'fista').".format(cfg.solver))
    if cfg.solver == "fista":
        raise NotImplementedError(
            "solver='fista' (exact group-L1) is not ported yet "
            "(ROADMAP A8a)")
    if checkpoint_file is not None:
        raise NotImplementedError(
            "checkpoint_file (mid-fit checkpoint / resume) is not ported "
            "yet (ROADMAP A8b)")
    _no_mesh(mesh)


def fit_plm(codes, weights, num_symbols, cfg=PlmConfig(), mesh=None,
            callback=None, checkpoint_file=None, checkpoint_every=50,
            device=None):
    """Fit a Potts model by pseudolikelihood maximization.

    Parameters
    ----------
    codes : (N, L) int array, entries in [0, q) or -1 (excluded position)
    weights : (N,) float array of sequence weights
    num_symbols : alphabet size q
    cfg : PlmConfig
    mesh, checkpoint_file, checkpoint_every : accepted for the JAX
        package's signature; a mesh or a checkpoint file raises
        NotImplementedError (not ported yet)
    callback : optional fn(iteration_record_dict) for progress streaming
    device : torch device (None: the CUDA device; raises without one)

    Returns
    -------
    PlmFitResult
    """
    del checkpoint_every
    _check_config(cfg, mesh, checkpoint_file)
    device = resolve_device(device)
    codes = np.asarray(codes)
    weights = np.asarray(weights, dtype=np.float64)
    N, L = codes.shape
    q = int(num_symbols)
    lq = L * q
    dsize = lq * lq

    compute_dtype = _compute_dtype(cfg.dtype)
    # masters, moments and weights stay f32 (f64 in float64 runs)
    dtype = _acc_dtype(compute_dtype)

    # pad rows to a block multiple: weight 0 AND codes -1 rows
    codes_p, _ = pad_rows(codes.astype(np.int8), cfg.block_size)
    w_p, _ = pad_rows(weights, cfg.block_size)
    codes_p[N:] = -1
    codes_d = torch.as_tensor(codes_p, device=device)
    w_d = torch.as_tensor(w_p, device=device).to(dtype)

    layout = _resolve_grad_layout(cfg, compute_dtype, codes_p.shape[0],
                                  _augmented_width(lq))
    oh_d = (build_augmented_onehot(codes_d, q, compute_dtype)
            if layout == "two_phase" else None)

    vg_fn = make_plm_value_and_grad(L, q, cfg, symmetric_params=True)
    params = {
        "J": torch.zeros((lq, lq), dtype=dtype, device=device),
        "h": torch.zeros((L, q), dtype=dtype, device=device),
    }
    steps_per_call = max(1, int(cfg.steps_per_call))

    with matmul_precision(cfg.precision):
        if cfg.solver == "lbfgs":
            def _unflatten_x(x):
                return {"J": x[:dsize].reshape(lq, lq),
                        "h": x[dsize:].reshape(L, q)}

            def vg_flat(x, codes, weights, oh_aug):
                value, grads = vg_fn(_unflatten_x(x), codes, weights, oh_aug)
                return value.to(dtype), torch.cat(
                    [grads["J"].reshape(-1), grads["h"].reshape(-1)])

            lb_chunk = make_lbfgs_chunk(
                vg_flat, m=cfg.memory_size, steps_per_call=steps_per_call,
                conv_tol=cfg.conv_tol, norm_split=dsize,
                dot=_lbfgs_dot(compute_dtype, cfg.precision))
            x0 = torch.cat([params["J"].reshape(-1),
                            params["h"].reshape(-1)])
            value0, grad0 = vg_flat(x0, codes_d, w_d, oh_d)
            state = (x0, init_lbfgs_state(x0, value0, grad0,
                                          m=cfg.memory_size))

            def run_chunk(params, state):
                x, lstate = state
                x, lstate, metrics = lb_chunk(x, lstate, codes_d, w_d, oh_d)
                return _unflatten_x(x), (x, lstate), metrics
        else:
            zeros = {k: torch.zeros_like(v) for k, v in params.items()}
            state = {"count": 0, "mu": zeros,
                     "nu": {k: torch.zeros_like(v) for k, v in zeros.items()}}
            if _resolve_fused_update(cfg, mesh, dtype):
                step = _make_fused_adam_step(
                    make_plm_nll_vg(L, q, cfg), L, q, cfg, compute_dtype)
                state["J_aug"] = _build_j_aug(
                    params, L, q, compute_dtype, _augmented_width(lq),
                    symmetric=True)
            else:
                step = _make_adam_step(vg_fn, cfg)

            def run_chunk(params, state):
                rows = []
                for _ in range(steps_per_call):
                    params, state, row = step(params, state, codes_d, w_d,
                                              oh_d)
                    rows.append(row)
                return params, state, torch.stack(rows)

        (params, table, it, converged, ls_failed, value,
         last) = _fit_loop(run_chunk, params, state, cfg, steps_per_call,
                           callback)
        if cfg.solver == "adam":
            # Adam rows record fx at the PRE-update iterate; one more
            # evaluation prices the parameters actually returned
            value = float(vg_fn(params, codes_d, w_d, oh_d)[0])
        elif last is not None:
            # the final metrics row prices the returned parameters (a
            # chunk may overshoot max_iter with live steps)
            value = float(last[-1][0])
        elif np.isnan(value):
            value = float(vg_fn(params, codes_d, w_d, oh_d)[0])

    P_mat = params["J"].detach().to("cpu", torch.float64).numpy()
    J_ij = unflatten_J(0.5 * (P_mat + P_mat.T), L, q)
    return PlmFitResult(
        J_ij=J_ij,
        h_i=params["h"].detach().to("cpu", torch.float64).numpy(),
        iteration_table=table,
        num_iter=it,
        converged=converged,
        final_loss=value,
        ls_failed=ls_failed,
    )


def _fit_loop(run_chunk, params, state, cfg, steps_per_call, callback):
    """Dispatch chunks until max_iter, convergence or a linesearch
    failure, building the iteration table (plmc's per-iteration log).

    Returns (params, table, iterations, converged, ls_failed, last
    recorded fx, last chunk's metrics or None)."""
    table = []
    converged = ls_failed = False
    value = float("nan")
    t0 = time.time()
    it = 0
    metrics = None
    # LBFGS rows carry the linesearch-failure flag in column 3
    ls_col = 3 if cfg.solver == "lbfgs" else None
    while it < cfg.max_iter and not converged and not ls_failed:
        n_steps = min(steps_per_call, cfg.max_iter - it)
        params, state, metrics = run_chunk(params, state)
        metrics = metrics.cpu().double().numpy()
        now = time.time() - t0
        # the table is truncated at the first converged iteration (plmc
        # semantics); the parameters keep any extra steps of the chunk
        for k in range(n_steps):
            if ls_col is not None and metrics[k][ls_col] > 0:
                # the step did not move: drop its repeated row
                ls_failed = True
                if np.isnan(value):
                    value = float(metrics[k][0])
                break
            it += 1
            value, gnorm, xnorm = metrics[k][:3]
            record = {
                "iter": it,
                "fx": value,
                "gnorm": gnorm,
                "xnorm": xnorm,
                "hnorm": metrics[k][-2],
                "Jnorm": metrics[k][-1],
                "time": now,
            }
            table.append(record)
            if callback is not None:
                callback(record)
            if gnorm <= cfg.conv_tol * max(1.0, xnorm):
                converged = True
                break
        if ls_failed:
            break
        if cfg.solver == "lbfgs" and not converged and state[1]["converged"]:
            converged = True
    return params, table, it, converged, ls_failed, value, metrics
