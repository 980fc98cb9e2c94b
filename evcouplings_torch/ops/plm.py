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

Solvers: "lbfgs" (ops/lbfgs.py), "adam" (the optax.adam formula; with
fused_update="on", and "auto" on a CUDA device, the epilogue of each step
is K2, the Triton kernel behind ops/plm_update.fused_adam_update), and
"fista" (exact group-L1 by proximal steps, _make_fista_step).

Mesh
----
With a mesh (evcouplings_torch.parallel), every rank holds its block of
the rows (padded to block_size x the "data" axis size), the parameters and
the whole solver state. Each value+gradient evaluation sums (nll, dJh)
over the "data" ranks by exactly one all-reduce of one packed float buffer
(a loss-only evaluation: one all-reduce of the nll), so every rank runs
the same solver arithmetic on the same numbers, K4 included, and the
ranks' parameters stay bitwise equal.
"""

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from evcouplings_torch import parallel
from evcouplings_torch._device import matmul_precision, resolve_device
from evcouplings_torch.kernels.seqdot import sequential_dot, sequential_dots
from evcouplings_torch.ops.encode import one_hot, pad_rows, unflatten_J
from evcouplings_torch.ops.lbfgs import init_lbfgs_state, make_lbfgs_chunk
from evcouplings_torch.ops.plm_update import (
    ADAM_B1, ADAM_B2, ADAM_EPS, fused_adam_update,
)
from evcouplings_torch.utils.tracing import annotate


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
    # nonsmooth penalty (solver "fista", blocks reach exact zeros);
    # "smoothed" is sqrt(||J_ij||^2 + group_eps) with lbfgs/adam
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
    # Adam epilogue through K2: "on" | "off" | "auto" (on for an
    # eligible fit on a CUDA device, off on the CPU; see
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


def make_plm_nll_vg(L, q, cfg, mesh=None):
    """Build nll_vg(J_aug, codes, weights, oh_aug) -> (nll, dJh): the
    data term and its raw closed-form gradient product (dJ_eff in
    columns :Lq, dh in column Lq). With a mesh, codes/weights/oh_aug are
    this rank's rows and the result is summed over the "data" ranks (one
    all-reduce)."""
    dtype = _compute_dtype(cfg.dtype)
    acc = _acc_dtype(dtype)
    lq_aug = _augmented_width(L * q)

    def nll_vg(J_aug, codes, weights, oh_aug=None):
        layout = _resolve_grad_layout(cfg, dtype, codes.shape[0], lq_aug)
        if layout == "two_phase":
            if oh_aug is None:
                oh_aug = build_augmented_onehot(codes, q, dtype)
            nll, dJh = _local_vg_two_phase(J_aug, codes, weights, oh_aug, L,
                                           q, cfg.block_size, acc)
        else:
            nll, dJh = _local_vg_carried(J_aug, codes, weights, L, q,
                                         cfg.block_size, acc)
        dJh, nll = parallel.all_reduce_many([dJh, nll], mesh)
        return nll, dJh

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


def make_plm_loss(L, q, cfg, mesh=None, symmetric_params=False):
    """Build loss(params, codes, weights) -> 0-d tensor: the objective by
    a per-site log-softmax (no gradient; FISTA's backtracking evaluates
    it once per trial step).

    params: {"J": (Lq, Lq), "h": (L, q)}; the sums run in the f32-or-wider
    accumulation dtype whatever the compute dtype. With a mesh, codes and
    weights are this rank's rows and the NLL is summed over the "data"
    ranks (one all-reduce of one number)."""
    dtype = _compute_dtype(cfg.dtype)
    acc = _acc_dtype(dtype)
    lq = L * q

    def local_nll(J_eff, h_flat, codes, weights):
        n_pad = codes.shape[0]
        _check_rows(n_pad, cfg.block_size)
        total = torch.zeros((), dtype=acc, device=J_eff.device)
        for start in range(0, n_pad, cfg.block_size):
            c = codes[start:start + cfg.block_size]
            w = weights[start:start + cfg.block_size].to(dtype)
            oh = one_hot(c, q, dtype=dtype).reshape(-1, lq)
            logits = oh @ J_eff.T + h_flat[None, :]
            logp = torch.log_softmax(
                logits.reshape(-1, L, q), dim=-1).reshape(-1, lq)
            per_seq = (oh * logp).sum(dim=1)
            total = total - torch.dot(w.to(acc), per_seq.to(acc))
        return total

    def loss(params, codes, weights):
        P_c = params["J"].to(dtype)
        mask = _diag_block_mask(L, q, dtype, P_c.device)
        if symmetric_params:
            J_eff = P_c * mask
        else:
            J_eff = 0.5 * (P_c + P_c.T) * mask
        h_c = params["h"].to(dtype)
        value = local_nll(J_eff, h_c.reshape(lq), codes, weights)
        value = parallel.all_reduce(value.reshape(1), mesh)[0]
        reg = (cfg.lambda_h * torch.sum(h_c.to(acc) ** 2)
               + cfg.lambda_J * 0.5 * torch.sum(J_eff.to(acc) ** 2))
        if cfg.lambda_group > 0:
            blocks = J_eff.to(acc).reshape(L, q, L, q)
            reg = reg + cfg.lambda_group * 0.5 * torch.sum(torch.sqrt(
                torch.sum(blocks ** 2, dim=(1, 3)) + cfg.group_eps))
        return value + reg

    return loss


def _resolve_fused_update(cfg, mesh, master_dtype,
                          device=torch.device("cpu")):
    """Whether the Adam steps run their epilogue through K2.

    "on" requires the adam solver, lambda_group == 0, float32 masters
    and no mesh or a mesh of one rank (K2 updates the replicated arrays
    outside the sharded gradient, as the JAX package's Pallas epilogue
    does); on a CUDA device it launches K2, on the CPU it runs K2's plain
    version. "auto" resolves to on where those hold and the
    fit runs on a CUDA device: on an NVIDIA H100 80GB HBM3 at its 700 W
    limit a production step (N=16384, L=160) took 3.19-3.70 ms fused
    against 4.11-4.60 ms unfused, fused faster in every pair
    (chip_smoke.py phase 5, PERF.md). On the CPU "auto" stays off, the JAX
    package's rule, which came from a TPU measurement.
    """
    if cfg.fused_update == "off":
        return False
    eligible = (cfg.solver == "adam" and cfg.lambda_group == 0
                and master_dtype == torch.float32
                and (mesh is None or mesh.size == 1))
    if cfg.fused_update == "on":
        if not eligible:
            raise ValueError(
                "fused_update='on' requires the adam solver, "
                "lambda_group=0, float32 master parameters, and a "
                "single-rank (or absent) mesh")
        return True
    if cfg.fused_update != "auto":
        raise ValueError("Unknown fused_update: {}".format(cfg.fused_update))
    return eligible and torch.device(device).type == "cuda"


def fit_fingerprint(codes, weights, num_symbols, cfg, device=None,
                    mesh=None):
    """Identity of a fit for checkpoint-resume safety: the data plus every
    configuration field that shapes the optimization trajectory (the JAX
    package's string, so a snapshot of either package resumes in the
    other). max_iter, steps_per_call and the checkpoint cadence are left
    out: resuming with a raised iteration cap is legitimate.

    fused_update enters as its literal value, except that "auto" which
    resolves on (an eligible Adam fit on a CUDA `device`, on no mesh or a
    mesh of one rank) enters as "on":
    the fused epilogue matches the unfused one only up to rounding, so a
    snapshot of one must not resume in the other."""
    import hashlib

    fused = cfg.fused_update
    if fused == "auto" and device is not None and _resolve_fused_update(
            cfg, mesh, _acc_dtype(_compute_dtype(cfg.dtype)), device):
        fused = "on"
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(codes, dtype=np.int8).tobytes())
    h.update(np.asarray(weights, dtype=np.float64).tobytes())
    h.update(repr((
        int(num_symbols), cfg.lambda_h, cfg.lambda_J, cfg.lambda_group,
        cfg.solver, cfg.adam_lr, cfg.block_size, cfg.dtype,
        cfg.precision, cfg.memory_size, cfg.conv_tol, cfg.grad_layout,
        fused,
    ) + ((cfg.group_mode, cfg.group_eps)
         if cfg.lambda_group > 0 else ())).encode())
    return h.hexdigest()


def _check_ckpt_fingerprint(ckpt, fingerprint, checkpoint_file):
    """Reject a snapshot written by a different fit configuration
    (snapshots without a fingerprint are accepted)."""
    files = ckpt.files if hasattr(ckpt, "files") else list(ckpt)
    if "fingerprint" not in files:
        return
    saved = str(ckpt["fingerprint"])
    if saved != fingerprint:
        raise ValueError(
            "Checkpoint {} was written by a DIFFERENT fit configuration or "
            "input data (fingerprint {}... vs {}...); delete it to start "
            "this fit fresh instead of silently resuming a mixed-objective "
            "optimization.".format(checkpoint_file, saved[:12],
                                   fingerprint[:12]))


def write_snapshot(path, arrays):
    """Write a snapshot atomically: a temporary file, then os.replace."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _host(t):
    return t.detach().cpu().numpy()


# LBFGS snapshot keys, each stored as "lbfgs_<key>" (the JAX package's)
_LBFGS_KEYS = ("x", "s_hist", "y_hist", "rho", "gamma", "count", "nevals",
               "value", "grad", "converged", "ls_failed")


def snapshot_arrays(solver, params, state, iteration, fingerprint=None):
    """The npz arrays of a symmetric fit's snapshot, under the JAX
    package's keys: J, h, iteration, fingerprint, and the solver state
    (adam_*: Adam moments and count; lbfgs_*: the flat master vector,
    the (m, D) histories with zero rows for empty slots, the carried
    evaluation and flags; fista_*: y, x_prev, tk, step, f_prev)."""
    arrays = {"J": _host(params["J"]), "h": _host(params["h"]),
              "iteration": np.asarray(iteration)}
    if fingerprint is not None:
        arrays["fingerprint"] = np.asarray(fingerprint)
    if state is None:
        return arrays
    if solver == "adam":
        arrays.update(
            adam_count=np.asarray(state["count"], dtype=np.int32),
            adam_mu_J=_host(state["mu"]["J"]),
            adam_mu_h=_host(state["mu"]["h"]),
            adam_nu_J=_host(state["nu"]["J"]),
            adam_nu_h=_host(state["nu"]["h"]))
    elif solver == "lbfgs":
        x, ls = state
        zero = torch.zeros_like(x)
        arrays.update(
            lbfgs_x=_host(x),
            lbfgs_s_hist=_host(torch.stack(
                [zero if s is None else s for s in ls["s_hist"]])),
            lbfgs_y_hist=_host(torch.stack(
                [zero if y is None else y for y in ls["y_hist"]])),
            lbfgs_rho=_host(torch.stack(ls["rho"])),
            lbfgs_gamma=_host(ls["gamma"]),
            lbfgs_count=np.asarray(ls["count"], dtype=np.int32),
            lbfgs_nevals=np.asarray(ls["nevals"], dtype=np.int32),
            lbfgs_value=_host(ls["value"]),
            lbfgs_grad=_host(ls["grad"]),
            lbfgs_converged=np.asarray(bool(ls["converged"])),
            lbfgs_ls_failed=np.asarray(bool(ls["ls_failed"])))
    elif solver == "fista":
        arrays.update(
            fista_yJ=_host(state["y"]["J"]), fista_yh=_host(state["y"]["h"]),
            fista_xprevJ=_host(state["x_prev"]["J"]),
            fista_xprevh=_host(state["x_prev"]["h"]),
            fista_tk=_host(state["tk"]), fista_step=_host(state["step"]),
            fista_fprev=_host(state["f_prev"]))
    return arrays


def restore_snapshot(ckpt, solver, L, q, dtype, device, memory_size=5):
    """A symmetric fit's resume state from snapshot arrays (an npz file or
    a mapping with the JAX package's keys): (params, solver state or None,
    iteration). The solver state is None where the snapshot carries none
    for `solver` (a parameter-only snapshot; an LBFGS snapshot of another
    memory size): the fit then restarts its solver from the parameters.

    J and the Adam J-moments are symmetrized (a bitwise no-op for the
    snapshots a symmetric fit writes)."""
    files = set(ckpt.files if hasattr(ckpt, "files") else ckpt)
    lq = L * q
    if ckpt["J"].shape != (lq, lq) or ckpt["h"].shape != (L, q):
        raise ValueError(
            "Checkpoint does not match problem shape (L={}, q={})".format(
                L, q))

    def sym(a):
        a = np.asarray(a, dtype=np.float64)
        return torch.as_tensor(0.5 * (a + a.T)).to(device=device,
                                                    dtype=dtype)

    def put(a):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    params = {"J": sym(ckpt["J"]), "h": put(ckpt["h"])}
    state = None
    if solver == "adam" and "adam_mu_J" in files:
        state = {"count": int(ckpt["adam_count"]),
                 "mu": {"J": sym(ckpt["adam_mu_J"]),
                        "h": put(ckpt["adam_mu_h"])},
                 "nu": {"J": sym(ckpt["adam_nu_J"]),
                        "h": put(ckpt["adam_nu_h"])}}
    elif solver == "lbfgs":
        saved = {k[len("lbfgs_"):] for k in files if k.startswith("lbfgs_")}
        if (saved == set(_LBFGS_KEYS)
                and ckpt["lbfgs_s_hist"].shape[0] == memory_size
                and ckpt["lbfgs_x"].shape[0] == lq * lq + lq):
            x = put(ckpt["lbfgs_x"])
            rho = [put(r) for r in ckpt["lbfgs_rho"]]
            # a zero rho marks an empty slot (the port keeps None there)
            s_hist = [None if float(r) == 0 else put(s)
                      for r, s in zip(rho, ckpt["lbfgs_s_hist"])]
            y_hist = [None if float(r) == 0 else put(y)
                      for r, y in zip(rho, ckpt["lbfgs_y_hist"])]
            state = (x, {
                "s_hist": s_hist, "y_hist": y_hist, "rho": rho,
                "gamma": put(ckpt["lbfgs_gamma"]),
                "count": int(ckpt["lbfgs_count"]),
                "nevals": int(ckpt["lbfgs_nevals"]),
                "value": put(ckpt["lbfgs_value"]),
                "grad": put(ckpt["lbfgs_grad"]),
                "converged": bool(ckpt["lbfgs_converged"]),
                "ls_failed": bool(ckpt["lbfgs_ls_failed"]),
            })
    elif solver == "fista" and "fista_yJ" in files:
        state = {
            "y": {"J": put(ckpt["fista_yJ"]), "h": put(ckpt["fista_yh"])},
            "x_prev": {"J": put(ckpt["fista_xprevJ"]),
                       "h": put(ckpt["fista_xprevh"])},
            "tk": put(float(ckpt["fista_tk"])),
            "step": put(float(ckpt["fista_step"])),
            "f_prev": put(float(ckpt["fista_fprev"])),
        }
    return params, state, int(ckpt["iteration"])


def _lbfgs_dots(compute_dtype, precision):
    """The LBFGS engine's dot product and its batch of independent dots,
    (dot, dots). Parity mode (float32, precision "highest") takes every
    dot as one fused multiply-add chain in index order (K4 on the card,
    a batch in one launch), the arithmetic of the JAX engine on the CPU:
    the 40-iteration golden fit moves by ~1e-3 under any other summation
    order. Every other mode uses torch.dot (dots None: the engine takes
    a batch as torch.dots one after another)."""
    if compute_dtype == torch.float32 and precision.startswith("highest"):
        return sequential_dot, sequential_dots
    return torch.dot, None


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


# FISTA steps taken and the backtracking trials beyond each step's first
# (every trial is one objective evaluation and one host read of its
# acceptance test); read by chip_smoke.py
fista_counts = {"steps": 0, "backtracks": 0}

# objective evaluations a FISTA step tries before it takes the last trial
_FISTA_MAX_BACKTRACKS = 30


def _make_fista_step(L, q, cfg, mesh=None):
    """One FISTA step for the EXACT group-L1 objective (group_mode
    "prox"):

        F(theta) = NLL + l2 + lambda_group * sum_{i<j} ||J_ij||_F

    The smooth part is the closed-form value and gradient with
    lambda_group stripped; the prox is group soft-thresholding of the
    q x q blocks, which reaches exact zeros. Backtracking halves the step
    until the prox point meets the smooth part's quadratic upper bound
    (at most _FISTA_MAX_BACKTRACKS evaluations, the last trial taken if none
    passes), then the momentum restarts when the objective rose.

    The flat (Lq, Lq) matrix stores each pair twice, so in the shared
    metric the smooth J gradient is 2 dP and the J part of squared norms
    is halved. The dots are torch.dot (float64 in float64 fits): FISTA's
    dots pin no fixture's rounding, so they do not go through K4.

    Returns step(params, state, codes, weights, oh_aug) -> (params, state,
    metrics row [full objective, prox-gradient-mapping norm, ||theta||,
    ||h||, ||J||]); the mapping norm plays ||g||'s part in the fit loop's
    convergence test.
    """
    from dataclasses import replace

    lam = cfg.lambda_group
    smooth_cfg = replace(cfg, lambda_group=0.0)
    vg = make_plm_value_and_grad(L, q, smooth_cfg, mesh=mesh,
                                 symmetric_params=True)
    loss = make_plm_loss(L, q, smooth_cfg, mesh=mesh,
                         symmetric_params=True)
    acc = _acc_dtype(_compute_dtype(cfg.dtype))
    lq = L * q
    # acceptance slack scaled to the accumulation dtype's resolution: f_t
    # and f_y come from two differently ordered reductions
    bt_slack = max(1e-12, 64.0 * torch.finfo(acc).eps)

    def block_norms(P):
        return torch.sqrt(torch.sum(P.reshape(L, q, L, q) ** 2, dim=(1, 3)))

    def vdot(a, b):
        return torch.dot(a.reshape(-1), b.reshape(-1))

    def prox_from(y, gJ, gh, s):
        P = y["J"] - (2.0 * s) * gJ
        h = y["h"] - s * gh
        if lam == 0:
            return {"J": P, "h": h}
        # divisor floor representable in the master dtype (a 1e-300
        # literal flushes to 0 in float32: 0/0 on zero blocks)
        tiny = torch.finfo(P.dtype).tiny
        scale = torch.clamp(
            1.0 - (s * lam) / torch.clamp(block_norms(P), min=tiny), min=0.0)
        blocks = P.reshape(L, q, L, q) * scale[:, None, :, None]
        return {"J": blocks.reshape(lq, lq), "h": h}

    def step(params, state, codes, weights, oh_aug):
        y, x_prev = state["y"], state["x_prev"]
        tk, s = state["tk"], state["step"]
        f_y, grads = vg(y, codes, weights, oh_aug)
        f_y = f_y.to(acc)
        gJ, gh = grads["J"], grads["h"]
        slack = bt_slack * torch.clamp(torch.abs(f_y), min=1.0)

        def try_step(s):
            x_t = prox_from(y, gJ, gh, s)
            f_t = loss(x_t, codes, weights).to(acc)
            dP, dh = x_t["J"] - y["J"], x_t["h"] - y["h"]
            inner = vdot(gJ, dP) + vdot(gh, dh)
            sqn = (0.5 * vdot(dP, dP) + vdot(dh, dh)).to(acc)
            bound = f_y + inner + sqn / (2.0 * s) + slack
            return x_t, f_t, sqn, bool(f_t <= bound)

        x_new, f_new, sqn, ok = try_step(s)
        k = 1
        while not ok and k < _FISTA_MAX_BACKTRACKS:
            s = s * 0.5
            x_new, f_new, sqn, ok = try_step(s)
            k += 1
        fista_counts["steps"] += 1
        fista_counts["backtracks"] += k - 1

        full = f_new + lam * 0.5 * torch.sum(block_norms(x_new["J"]))
        gmap = torch.sqrt(torch.clamp(sqn, min=0.0)) / s
        xnorm = torch.sqrt(0.5 * vdot(x_new["J"], x_new["J"])
                           + vdot(x_new["h"], x_new["h"]))

        # momentum with function-value adaptive restart
        restart = full > state["f_prev"]
        one = torch.ones((), dtype=acc, device=full.device)
        tk_next = torch.where(restart, one,
                              0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk)))
        beta = torch.where(restart, torch.zeros_like(one),
                           (tk - 1.0) / tk_next)
        y_new = {k: a + beta.to(a.dtype) * (a - x_prev[k])
                 for k, a in x_new.items()}
        # optimistic growth; backtracking re-clamps next step
        state = {"y": y_new, "x_prev": x_new, "tk": tk_next,
                 "step": (s * 1.3).to(acc), "f_prev": full}
        row = torch.stack([
            full.float(), gmap.float(), xnorm.float(),
            torch.linalg.vector_norm(x_new["h"]).float(),
            torch.linalg.vector_norm(x_new["J"]).float()])
        return x_new, state, row

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


def _check_config(cfg):
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
            "penalty. Use solver='fista' (exact proximal handling), or opt "
            "in to the smooth approximation explicitly with "
            "group_mode='smoothed'.".format(cfg.solver))


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
    mesh : optional evcouplings_torch.parallel mesh: rows shard over its
        "data" axis (every rank of the mesh calls fit_plm with the same
        arguments), parameters and solver state are replicated, and each
        evaluation is summed over the ranks by one all-reduce
    callback : optional fn(iteration_record_dict) for progress streaming
    checkpoint_file : optional path; every `checkpoint_every` iterations
        the parameters, the full solver state (Adam moments; the LBFGS
        flat vector, history and carried evaluation; the FISTA momentum
        state) and the iteration count are written there atomically, and
        an existing file resumes the fit bit for bit. The file is the JAX
        package's snapshot (same keys and fingerprint): a snapshot of
        either package resumes in the other. A snapshot of a different
        fit configuration or data raises ValueError. On a mesh the first
        rank writes, and ranks that disagree on whether to resume (a file
        some of them cannot see) or from which iteration raise ValueError.
    checkpoint_every : checkpoint interval in iterations
    device : torch device (None: the mesh's device, else the CUDA device;
        raises without one)

    Returns
    -------
    PlmFitResult
    """
    _check_config(cfg)
    device = resolve_device(
        mesh.device if device is None and mesh is not None else device)
    codes = np.asarray(codes)
    weights = np.asarray(weights, dtype=np.float64)
    N, L = codes.shape
    q = int(num_symbols)
    lq = L * q
    dsize = lq * lq

    compute_dtype = _compute_dtype(cfg.dtype)
    # masters, moments and weights stay f32 (f64 in float64 runs)
    dtype = _acc_dtype(compute_dtype)

    # pad rows to a block multiple per "data" rank: weight 0 AND codes -1
    # rows; each rank keeps its own block of rows
    n_data = 1 if mesh is None else mesh.shape[parallel.DATA_AXIS]
    codes_p, _ = pad_rows(codes.astype(np.int8), cfg.block_size * n_data)
    w_p, _ = pad_rows(weights, cfg.block_size * n_data)
    codes_p[N:] = -1
    n_loc = codes_p.shape[0] // n_data
    d_idx = 0 if mesh is None else mesh.index(parallel.DATA_AXIS)
    rows = slice(d_idx * n_loc, (d_idx + 1) * n_loc)
    codes_d = torch.as_tensor(codes_p[rows], device=device)
    w_d = torch.as_tensor(w_p[rows], device=device).to(dtype)

    layout = _resolve_grad_layout(cfg, compute_dtype, n_loc,
                                  _augmented_width(lq))
    oh_d = (build_augmented_onehot(codes_d, q, compute_dtype)
            if layout == "two_phase" else None)

    vg_fn = make_plm_value_and_grad(L, q, cfg, mesh=mesh,
                                    symmetric_params=True)
    params = {
        "J": torch.zeros((lq, lq), dtype=dtype, device=device),
        "h": torch.zeros((L, q), dtype=dtype, device=device),
    }
    steps_per_call = max(1, int(cfg.steps_per_call))

    # resume from a snapshot if one exists
    start_iter = 0
    resumed = None
    fingerprint = (fit_fingerprint(codes, weights, q, cfg, device, mesh)
                   if checkpoint_file is not None else None)
    have_ckpt = checkpoint_file is not None and os.path.exists(
        checkpoint_file)
    _agree_on_resume(mesh, checkpoint_file, have_ckpt)
    if have_ckpt:
        ckpt = np.load(checkpoint_file)
        # the shape check (in restore_snapshot) comes first
        params, resumed, start_iter = restore_snapshot(
            ckpt, cfg.solver, L, q, dtype, device, cfg.memory_size)
        _check_ckpt_fingerprint(ckpt, fingerprint, checkpoint_file)
        _agree_on_resume(mesh, checkpoint_file, start_iter=start_iter)

    with matmul_precision(cfg.precision):
        if cfg.solver == "lbfgs":
            def _unflatten_x(x):
                return {"J": x[:dsize].reshape(lq, lq),
                        "h": x[dsize:].reshape(L, q)}

            def vg_flat(x, codes, weights, oh_aug):
                value, grads = vg_fn(_unflatten_x(x), codes, weights, oh_aug)
                return value.to(dtype), torch.cat(
                    [grads["J"].reshape(-1), grads["h"].reshape(-1)])

            dot, dots = _lbfgs_dots(compute_dtype, cfg.precision)
            lb_chunk = make_lbfgs_chunk(
                vg_flat, m=cfg.memory_size, steps_per_call=steps_per_call,
                conv_tol=cfg.conv_tol, norm_split=dsize,
                dot=dot, dots=dots)
            if resumed is not None:
                state = resumed
            else:
                # a parameter-only snapshot restarts the history here
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
            if cfg.solver == "fista":
                step = _make_fista_step(L, q, cfg, mesh)
                state = resumed or {
                    "y": params, "x_prev": params,
                    "tk": torch.ones((), dtype=dtype, device=device),
                    "step": torch.ones((), dtype=dtype, device=device),
                    "f_prev": torch.full((), float("inf"), dtype=dtype,
                                         device=device),
                }
            else:
                state = resumed or {
                    "count": 0,
                    "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                    "nu": {k: torch.zeros_like(v) for k, v in params.items()},
                }
                if _resolve_fused_update(cfg, mesh, dtype, device):
                    step = _make_fused_adam_step(
                        make_plm_nll_vg(L, q, cfg, mesh), L, q, cfg,
                        compute_dtype)
                    # carried across steps; from the masters it is bitwise
                    # the matrix K2 emits, so a resumed fit rebuilds it
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

        save = None
        if checkpoint_file is not None and (mesh is None or mesh.is_writer):
            # one writer: the ranks hold the same bytes
            def save(params, state, iteration):
                write_snapshot(checkpoint_file, snapshot_arrays(
                    cfg.solver, params, state, iteration, fingerprint))

        (params, state, table, it, converged, ls_failed, value,
         last) = _fit_loop(run_chunk, params, state, cfg, steps_per_call,
                           callback, start_iter, save, checkpoint_every,
                           resumed is not None)
        if cfg.solver == "adam":
            # Adam rows record fx at the PRE-update iterate; one more
            # evaluation prices the parameters actually returned
            value = float(vg_fn(params, codes_d, w_d, oh_d)[0])
        elif last is not None:
            # the final metrics row prices the returned parameters (a
            # chunk may overshoot max_iter with live steps)
            value = float(last[-1][0])
        elif np.isnan(value):
            # the loop never dispatched (a resume at max_iter, or a frozen
            # resumed state): the FISTA state carries the full nonsmooth
            # objective of its last iterate, which vg_fn would smooth
            f_prev = (float(state["f_prev"]) if cfg.solver == "fista"
                      else float("nan"))
            value = (f_prev if np.isfinite(f_prev)
                     else float(vg_fn(params, codes_d, w_d, oh_d)[0]))

    P_mat = params["J"].detach().to("cpu", torch.float64).numpy()
    J_ij = unflatten_J(0.5 * (P_mat + P_mat.T), L, q)
    return PlmFitResult(
        J_ij=J_ij,
        h_i=params["h"].detach().to("cpu", torch.float64).numpy(),
        iteration_table=table,
        # total iterations the returned parameters received, resumed
        # ones included
        num_iter=it,
        converged=converged,
        final_loss=value,
        ls_failed=ls_failed,
    )


def _agree_on_resume(mesh, checkpoint_file, have_ckpt=None,
                     start_iter=None):
    """On a mesh, raise ValueError on every rank unless all ranks see the
    checkpoint file alike (have_ckpt), or resume from the same iteration
    (start_iter): ranks that decide differently would run different
    iteration counts and wait forever in the next all-reduce."""
    if mesh is None or checkpoint_file is None:
        return
    if have_ckpt is not None:
        parallel.agree(mesh, have_ckpt,
              "checkpoint_file {!r} is visible on some ranks but not "
              "others: mid-fit checkpointing in a run of several processes "
              "requires a filesystem shared by all of them".format(
                  checkpoint_file))
    else:
        parallel.agree(mesh, start_iter,
              "checkpoint {!r} iteration differs across ranks: stale "
              "per-host copies?".format(checkpoint_file))


def _fit_loop(run_chunk, params, state, cfg, steps_per_call, callback,
              start_iter=0, save=None, checkpoint_every=50, resumed=False):
    """Dispatch chunks from start_iter until max_iter, convergence or a
    linesearch failure, building the iteration table (plmc's
    per-iteration log); with `save`, snapshot every checkpoint_every
    iterations and at the end. `resumed`: the solver state came from a
    snapshot.

    Returns (params, state, table, iterations, converged, ls_failed, last
    recorded fx, last chunk's metrics or None)."""
    table = []
    converged = ls_failed = False
    value = float("nan")
    t0 = time.time()
    it = last_ckpt = start_iter
    metrics = None
    if cfg.solver == "lbfgs" and resumed:
        # a resumed state that already converged or froze must not run a
        # chunk of pass-throughs: they would add duplicate rows and move
        # the snapshot's iteration count
        x, ls = state
        g = ls["grad"].double()
        xd = x.double()
        if ls["ls_failed"]:
            ls_failed = True
        elif ls["converged"] or bool(
                torch.sqrt(torch.dot(g, g))
                <= cfg.conv_tol * max(1.0, float(torch.sqrt(
                    torch.dot(xd, xd))))):
            converged = True
    # LBFGS rows carry the linesearch-failure flag in column 3
    ls_col = 3 if cfg.solver == "lbfgs" else None
    while it < cfg.max_iter and not converged and not ls_failed:
        n_steps = min(steps_per_call, cfg.max_iter - it)
        with annotate("plm_step_chunk"):
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
        last_ckpt = _checkpoint(save, it, last_ckpt, checkpoint_every,
                                params, state)
    _checkpoint(save, it, last_ckpt, checkpoint_every, params, state,
                final=True)
    return params, state, table, it, converged, ls_failed, value, metrics


def _checkpoint(save, it, last_ckpt, every, *args, final=False):
    """The fit loops' snapshot cadence: call save(*args, it) once `every`
    iterations have passed since the snapshot at last_ckpt (with `final`,
    at the end of the fit: once any has). No-op when save is None.
    Returns the iteration of the latest snapshot."""
    due = it > last_ckpt if final else it - last_ckpt >= every
    if save is None or not due:
        return last_ckpt
    save(*args, it)
    return it
