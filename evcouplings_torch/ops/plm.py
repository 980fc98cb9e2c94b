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
Each built function pins its own precision, chosen from cfg.precision
when it is built, whatever the caller's global TF32 setting (no product
of the port runs in TF32). dtype "float32" with precision "highest" is
the parity mode: IEEE float32 products. "high" and "default" are the JAX
package's definitions of those names, in bf16 limbs
(_device.precision_limbs): on a CUDA device the float32 operand of each
one-hot product (the couplings in the logits product, the residual in
the gradient product) is split into 2 or 1 bf16 limbs, each limb runs
one cuBLAS pass against the exactly-bf16 one-hot (torch.mm(...,
out_dtype=float32)), and the passes are summed in float32, largest limb
first (_limb_operand, _mm). The couplings are split once per evaluation,
the residual once per row block. On the CPU these products stay exact
float32, as XLA-CPU ignores the precision in the JAX package. The
per-site softmax sums and the weighted sums are float32 reductions at
every precision.
dtype "bfloat16" is the production mode: bf16 operands, with float32
outputs on the gradient products (torch.mm(..., out_dtype=float32) on the
card; the CPU upcasts the operands instead), while the logits product
keeps the compute dtype. On a CUDA device each bf16 row block's softmax,
per-site sums, NLL terms and residual are one launch of K6
(kernels/block_epilogue.py), in float32 with one bf16 rounding, at the
residual's store; elsewhere they are the plain PyTorch chain
(block_epilogue_plain), which rounds each step to the compute dtype.
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
from evcouplings_torch._device import (
    matmul_precision, precision_limbs, resolve_device,
)
from evcouplings_torch.kernels.block_epilogue import (
    block_epilogue, block_epilogue_plain, fuses_epilogue,
)
from evcouplings_torch.kernels.seqdot import sequential_dot, sequential_dots
from evcouplings_torch.ops.encode import one_hot, pad_rows, unflatten_J
from evcouplings_torch.ops.lbfgs import (
    _fit_sync, init_lbfgs_state, make_lbfgs_chunk,
)
from evcouplings_torch.ops.plm_update import (
    ADAM_B1, ADAM_B2, ADAM_EPS, fused_adam_update,
)
from evcouplings_torch.utils.tracing import add_counts, span


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


def _split_limbs(x, n):
    """n bfloat16 limbs of a float32 tensor, largest first: the first is x
    rounded to bf16, each next one what the limbs before it leave of x,
    rounded to bf16 (that rest is exact in float32). Two limbs hold x to
    within 2^-17 of it, relative; three hold it exactly."""
    limbs = [x.to(torch.bfloat16)]
    rest = x
    for _ in range(n - 1):
        rest = rest - limbs[-1]
        limbs.append(rest.to(torch.bfloat16))
    return tuple(limbs)


def _takes_limbs(dtype, limbs, device):
    """Whether a fit's one-hot products split their float32 operand into
    `limbs` bf16 limbs (precision_limbs of the fit's precision): at
    "high" and "default", on float32, on a CUDA device. Otherwise they
    are IEEE float32 at "highest" (limbs None), exact float32 on the CPU,
    and bf16 or float64 products as they are."""
    return (limbs is not None and dtype == torch.float32
            and torch.device(device).type == "cuda")


def _limb_operand(x, limbs):
    """The float32 operand x of a one-hot product: the tuple of its bf16
    limbs where the product takes them (_takes_limbs; _mm runs one pass
    per limb), else x itself."""
    return _split_limbs(x, limbs) if _takes_limbs(
        x.dtype, limbs, x.device) else x


def _exact_dtype(dtype, limbs, device):
    """dtype of the exactly-bf16 operand (the one-hot) of a fit's products:
    bfloat16 where the other one takes limbs (_takes_limbs), else the
    compute dtype."""
    return torch.bfloat16 if _takes_limbs(dtype, limbs, device) else dtype


def _mm(a, b, out, into=None):
    """a @ b with the output in `out` (_mm_acc); with `into`, the product
    is added into that tensor in place and it is returned. Where one
    operand is a tuple of bf16 limbs (_limb_operand), the other is exactly
    bf16 (a one-hot, cast to bf16 if it is not) and the product is one
    float32 pass per limb (_mm_acc), largest limb first, each added to the
    sum of those before; the output is then float32, and the sum is added
    into `into` after the last pass."""
    if isinstance(a, tuple) or isinstance(b, tuple):
        a = a if isinstance(a, tuple) else (a.to(torch.bfloat16),)
        b = b if isinstance(b, tuple) else (b.to(torch.bfloat16),)
        p = None
        for x in a:
            for y in b:
                t = _mm_acc(x, y, torch.float32)
                p = t if p is None else p.add_(t)
    else:
        p = _mm_acc(a, b, out)
    return p if into is None else into.add_(p)


def _transpose(x):
    """x.T, or the transposes of a tuple of limbs."""
    return tuple(t.T for t in x) if isinstance(x, tuple) else x.T


def _residual_store(n, width, dtype, limbs, device):
    """Buffer for the residuals of all row blocks of a two-phase layout:
    one (n, width) tensor of the compute dtype, or where the gradient
    product takes the limb route, one bf16 tensor per limb, filled a
    block at a time (_store_rows): no whole float32 copy is split."""
    if not _takes_limbs(dtype, limbs, device):
        return torch.empty((n, width), dtype=dtype, device=device)
    return tuple(torch.empty((n, width), dtype=torch.bfloat16,
                             device=device) for _ in range(limbs))


def _store_rows(store, rows, r):
    """store[rows] = r, split into the store's limbs if it has them."""
    if isinstance(store, tuple):
        for buf, limb in zip(store, _split_limbs(r, len(store))):
            buf[rows] = limb
    else:
        store[rows] = r


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
    """(block NLL contribution, residual r) for one row block by the plain
    route (block_epilogue_plain after the logits product).

    J_aug: the augmented couplings, or their limbs (_limb_operand);
    oh_aug: (B, Lq_aug) augmented one-hot of codes c (bf16 beside limbs);
    w already in the compute dtype."""
    logits = _mm(oh_aug, J_aug, w.dtype)
    return block_epilogue_plain(logits, oh_aug[:, :L * q], c, w, L, q, acc)


class _FusedEpilogue:
    """The K6 route of one evaluation's row blocks (kernels/block_epilogue,
    taken where fuses_epilogue holds: bf16 compute on a CUDA device):
    block() takes a block's logits product and launches K6 on it, which
    writes the block's residual into the caller's rows `r` and its rows'
    weighted terms into one float32 vector over all rows; nll() sums that
    vector once, in a fixed order, into the evaluation's NLL. Adds the
    count `epilogue_fused` to the open plm.value_grad span."""

    def __init__(self, codes, weights, q):
        add_counts(epilogue_fused=1)
        self.codes = codes.to(torch.int8)
        self.weights = weights.to(torch.float32)
        self.q = q
        self.terms = torch.empty((codes.shape[0],), dtype=torch.float32,
                                 device=codes.device)

    def block(self, J_op, oh_aug, rows, r):
        block_epilogue(_mm(oh_aug, J_op, torch.bfloat16), self.codes[rows],
                       self.weights[rows], self.q, r, self.terms[rows])
        return r

    def nll(self):
        return -self.terms.sum()


def _check_rows(n_pad, block_size):
    if n_pad % block_size:
        raise ValueError(
            "codes rows ({}) must be a multiple of block_size ({}): the "
            "block loop would drop the remainder rows. Pad with code -1 "
            "/ weight-0 rows (ops.encode.pad_rows) as fit_plm does."
            .format(n_pad, block_size))


def _local_vg_carried(J_aug, codes, weights, L, q, block_size, acc,
                      limbs=None):
    n_pad = codes.shape[0]
    _check_rows(n_pad, block_size)
    dtype = J_aug.dtype
    device = J_aug.device
    lq = L * q
    oh_dtype = _exact_dtype(dtype, limbs, device)
    nll = torch.zeros((), dtype=acc, device=device)
    dJh = torch.zeros((lq, J_aug.shape[0]), dtype=acc, device=device)
    J_op = _limb_operand(J_aug, limbs)
    fused = None
    if fuses_epilogue(dtype, device):
        fused = _FusedEpilogue(codes, weights, q)
        r_block = torch.empty((block_size, lq), dtype=dtype, device=device)
    for start in range(0, n_pad, block_size):
        rows = slice(start, start + block_size)
        c = codes[rows]
        oh_aug = build_augmented_onehot(c, q, oh_dtype)
        if fused is None:
            nll_b, r = _block_nll_residual(J_op, oh_aug, c,
                                           weights[rows].to(dtype), L, q, acc)
            nll = nll + nll_b
        else:
            r = fused.block(J_op, oh_aug, rows, r_block)
        _mm(_limb_operand(r.T, limbs), oh_aug, acc, into=dJh)
    return (nll if fused is None else fused.nll()), dJh


def _local_vg_two_phase(J_aug, codes, weights, oh_all, L, q, block_size,
                        acc, limbs=None):
    n_pad = codes.shape[0]
    _check_rows(n_pad, block_size)
    dtype = J_aug.dtype
    lq = L * q
    nll = torch.zeros((), dtype=acc, device=J_aug.device)
    r_all = _residual_store(n_pad, lq, dtype, limbs, J_aug.device)
    J_op = _limb_operand(J_aug, limbs)
    fused = (_FusedEpilogue(codes, weights, q)
             if fuses_epilogue(dtype, J_aug.device) else None)
    for start in range(0, n_pad, block_size):
        sl = slice(start, start + block_size)
        if fused is not None:
            # K6 writes the block's residual into its rows of r_all
            fused.block(J_op, oh_all[sl], sl, r_all[sl])
            continue
        nll_b, r = _block_nll_residual(
            J_op, oh_all[sl], codes[sl], weights[sl].to(dtype), L, q, acc)
        _store_rows(r_all, sl, r)
        nll = nll + nll_b
    if fused is not None:
        nll = fused.nll()
    return nll, _mm(_transpose(r_all), oh_all, acc)


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


# (Lq, Lq_aug)-sized arrays a fit holds at its peak, counted from the
# card's allocator (chip_smoke.py --peak-memory): the masters, the
# gradient, the solver's state, the values one step builds from them and
# the starting values fit_plm keeps while it loops; then, for LBFGS, the
# arrays per history pair. An Adam step without the fused epilogue holds
# the gradient's terms too: counted unless fused_update is "on" (the
# router resolves "auto" for the fit's device and mesh first)
_PEAK_ARRAYS = {   # (fit, solver): (arrays, arrays per history pair)
    ("symmetric", "lbfgs"): (13, 2),
    ("symmetric", "adam", "fused"): (13, 0),
    ("symmetric", "adam"): (15, 0),
    ("symmetric", "fista"): (9, 0),
    ("asymmetric", "lbfgs"): (13, 2),
    ("asymmetric", "adam"): (9, 0),
}
# (block, width) temporaries of the compute dtype one row block of the
# value+grad pass holds at once on the plain route (logits, their
# exponentials, the residual and its factors); K6's route holds the
# logits alone, and the estimate keeps the plain route's count for both
_BLOCK_TEMPORARIES = 5
# what the limb route ("high"/"default" with float32 compute on a CUDA
# device) adds in either layout: (Lq, Lq_aug) arrays, the couplings' bf16
# limbs, held for the whole evaluation, and the float32 rest of their
# split; and (block, Lq) temporaries, the residual's bf16 limbs and the
# float32 rest of its split (per block in the carried layout, at the
# store's rows in the two-phase ones)
_LIMB_ARRAYS = 2
_LIMB_TEMPORARIES = 2
# the caching allocator's reserve over what a fit allocates: 1.01-1.37 in
# chip_smoke.py --peak-memory, the most where differently sized row
# blocks come and go beside few (Lq, Lq_aug) arrays
_ALLOCATOR_SLACK = 1.35


def estimate_fit_hbm_bytes(n, l, q, cfg, parametrization="symmetric",
                           n_data_shards=1, n_model_shards=1):
    """Peak device memory of a PLM fit on one rank, in bytes: what the
    caching allocator reserves for the port's working set.

    The working set is _PEAK_ARRAYS arrays of (Lq, Lq_aug) masters
    ((l_loc q, Lq_aug) in the asymmetric fit) beside the rows' working
    set of the gradient layout: the two-phase layout's resident one-hot
    and residuals plus a block's temporaries, or the carried layout's
    block temporaries; then the codes, the limb route's arrays and
    temporaries (_LIMB_ARRAYS, _LIMB_TEMPORARIES, counted wherever a
    float32 fit runs at "high" or "default"), and 35% for the allocator.
    The counts are the port's, read off the card's allocator: they exceed
    the JAX package's (an eager step keeps its inputs while it builds
    its outputs, where XLA reuses buffers). On an NVIDIA H100 80GB HBM3
    at 700 W, `python3 chip_smoke.py --peak-memory` found every fit
    route's reserved peak (parity, balanced and per-site LBFGS, Adam with
    and without the fused epilogue, FISTA, asymmetric Adam; L=160 with
    N=16384 and L=400 with N=2048) at 0.66-0.93 of this estimate (the
    balanced fits 0.73-0.80), and near the router's limit on that card
    (N=16384) the production fit's at L=1500 (an estimate of 0.9 x the
    budget) at 0.77 and asymmetric Adam's at L=1980 (an estimate of the
    budget) at 0.88; chip_smoke.py's phase 5c holds the main path's fits
    to it on every run.
    """
    master = 8 if cfg.dtype == "float64" else 4
    comp = {"bfloat16": 2, "float64": 8}.get(cfg.dtype, 4)
    lq = l * q
    lq_aug = _augmented_width(lq)
    n_loc = -(-n // max(1, n_data_shards))
    block = min(cfg.block_size, n_loc)
    codes_bytes = n_loc * l

    if parametrization == "asymmetric":
        l_loc = -(-l // max(1, n_model_shards))
        key = ("asymmetric", cfg.solver)
        d = l_loc * q * lq_aug
        if cfg.grad_layout == "two_phase":
            rows = n_loc * (lq + l_loc * q) * comp
        else:
            rows = _BLOCK_TEMPORARIES * block * lq_aug * comp
    else:
        key = ("symmetric", cfg.solver)
        if cfg.solver == "adam" and cfg.fused_update == "on":
            key += ("fused",)
        d = lq * lq_aug
        layout = _resolve_grad_layout(cfg, _compute_dtype(cfg.dtype),
                                      n_loc, lq_aug)
        if layout == "two_phase":
            rows = (n_loc * (lq_aug + lq)
                    + _BLOCK_TEMPORARIES * block * lq) * comp
        else:
            rows = _BLOCK_TEMPORARIES * block * lq_aug * comp

    base, per_pair = _PEAK_ARRAYS[key]
    arrays = base + per_pair * cfg.memory_size
    if cfg.dtype == "float32" and precision_limbs(cfg.precision):
        arrays += _LIMB_ARRAYS
        rows += _LIMB_TEMPORARIES * block * lq * comp
    return int(_ALLOCATOR_SLACK * (arrays * d * master + rows + codes_bytes))


def _pinned(fn, precision):
    """fn with its products at `precision` whatever the caller's global
    TF32 setting (matmul_precision around every call)."""

    def call(*args, **kwargs):
        with matmul_precision(precision):
            return fn(*args, **kwargs)

    return call


def make_plm_nll_vg(L, q, cfg, mesh=None):
    """Build nll_vg(J_aug, codes, weights, oh_aug) -> (nll, dJh): the
    data term and its raw closed-form gradient product (dJ_eff in
    columns :Lq, dh in column Lq). With a mesh, codes/weights/oh_aug are
    this rank's rows and the result is summed over the "data" ranks (one
    all-reduce). The products run at cfg.precision (see Precision
    above); where they take limbs, oh_aug is best given in bf16
    (_exact_dtype), as fit_plm builds it."""
    dtype = _compute_dtype(cfg.dtype)
    acc = _acc_dtype(dtype)
    limbs = precision_limbs(cfg.precision)
    lq_aug = _augmented_width(L * q)

    def nll_vg(J_aug, codes, weights, oh_aug=None):
        layout = _resolve_grad_layout(cfg, dtype, codes.shape[0], lq_aug)
        if layout == "two_phase":
            if oh_aug is None:
                oh_aug = build_augmented_onehot(
                    codes, q, _exact_dtype(dtype, limbs, codes.device))
            nll, dJh = _local_vg_two_phase(J_aug, codes, weights, oh_aug, L,
                                           q, cfg.block_size, acc, limbs)
        else:
            nll, dJh = _local_vg_carried(J_aug, codes, weights, L, q,
                                         cfg.block_size, acc, limbs)
        dJh, nll = parallel.all_reduce_many([dJh, nll], mesh)
        return nll, dJh

    return _pinned(nll_vg, cfg.precision)


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

    pinned = _pinned(vg, cfg.precision)

    def value_grad(params, codes, weights, oh_aug=None):
        with span("plm.value_grad"):
            return pinned(params, codes, weights, oh_aug)

    return value_grad


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
    limbs = precision_limbs(cfg.precision)
    lq = L * q

    def local_nll(J_eff, h_flat, codes, weights):
        n_pad = codes.shape[0]
        _check_rows(n_pad, cfg.block_size)
        total = torch.zeros((), dtype=acc, device=J_eff.device)
        oh_dtype = _exact_dtype(dtype, limbs, J_eff.device)
        J_op = _limb_operand(J_eff.T, limbs)
        for start in range(0, n_pad, cfg.block_size):
            c = codes[start:start + cfg.block_size]
            w = weights[start:start + cfg.block_size].to(dtype)
            oh = one_hot(c, q, dtype=oh_dtype).reshape(-1, lq)
            logits = _mm(oh, J_op, dtype) + h_flat[None, :]
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

    return _pinned(loss, cfg.precision)


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


def _lbfgs_dots(compute_dtype, precision, device):
    """The LBFGS engine's dot product and its batch of independent dots,
    (dot, dots), by the tensors' device, as _takes_limbs rules the
    one-hot products. A float32 fit on the CPU takes every dot as one
    fused multiply-add chain in index order (the host chain), whatever
    its precision name: the JAX engine's arithmetic on the CPU, which
    its parity, balanced and "default" fits share bit for bit. On a CUDA
    device only parity mode (float32, "highest") takes the chain (K4, a
    batch in one launch): the 40-iteration golden fit moves by ~1e-3
    under any other summation order. Every other fit, and bfloat16
    compute on either device, uses torch.dot (dots None: the engine
    takes a batch as torch.dots one after another)."""
    if compute_dtype == torch.float32 and (
            torch.device(device).type == "cpu"
            or precision.startswith("highest")):
        return sequential_dot, sequential_dots
    return torch.dot, None


def _replays_value_grad(device, mesh):
    """Whether an LBFGS fit replays its flat value+grad as one CUDA graph
    (_ValueGradGraph): on a CUDA device without a mesh. A sharded fit
    sums each evaluation over its ranks through the host and stays
    eager, as does every fit on the CPU."""
    return torch.device(device).type == "cuda" and mesh is None


# one capture stream per CUDA device, kept for the process: PyTorch keeps a
# cuBLAS workspace per stream, so captures on one stream share one
_CAPTURE_STREAMS = {}


class _ValueGradGraph:
    """A fit's flat value+grad, vg_flat(x, *rows) -> (value, grad),
    captured once as a CUDA graph and replayed for each later evaluation.

    The graph reads the static buffer `x`, into which each call copies
    its argument, and the fit's row tensors `rows`, which keep their
    addresses for the whole fit; its temporaries live in a private memory
    pool. A call replays the same kernels in the same order on the same
    values as an eager evaluation, so it gives the same bits, and returns
    copies of the graph's outputs: the solver keeps a value and gradient
    across evaluations, which the next replay would overwrite. Each call
    is one "plm.value_grad" span with the count `replayed` (and
    `epilogue_fused` where the capture took K6), and adds the K6
    launches of the capture to their count, as an eager evaluation
    does. The capture launches nothing; take it after an eager
    evaluation of the same fit, which loads the kernels' libraries and
    cuBLAS's handle. release() frees the graph and, with its outputs,
    its pool."""

    def __init__(self, vg_flat, x, rows):
        device = x.device
        stream = _CAPTURE_STREAMS.get(device)
        if stream is None:
            stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
        self.rows = rows
        self.x = x.clone()
        self.graph = torch.cuda.CUDAGraph()
        launches = block_epilogue.launches
        stream.wait_stream(torch.cuda.current_stream(device))
        with span("plm.graph_capture"), torch.cuda.stream(stream):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.value, self.grad = vg_flat(self.x, *rows)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(stream)
        self.k6_launches = block_epilogue.launches - launches
        block_epilogue.launches = launches

    def __call__(self, x, *rows):
        if len(rows) != len(self.rows) or any(
                a is not b for a, b in zip(rows, self.rows)):
            raise ValueError("a value+grad graph replays on the rows it "
                             "was captured with")
        with span("plm.value_grad"):
            add_counts(replayed=1)
            if self.k6_launches:
                add_counts(epilogue_fused=1)
            self.x.copy_(x)
            self.graph.replay()
            block_epilogue.launches += self.k6_launches
            return self.value.clone(), self.grad.clone()

    def release(self):
        self.graph.reset()
        self.x = self.value = self.grad = self.rows = None


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
    followed by scaling with -lr; the elementwise update runs under the
    span "adam.update"."""

    def step(params, state, codes, weights, oh_aug):
        value, grad = vg_fn(params, codes, weights, oh_aug)
        count = state["count"] + 1
        mu, nu, new = {}, {}, {}
        with span("adam.update"):
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
    masters. Matches the unfused step up to float rounding. The products
    and the value run under the span "plm.value_grad", K2 and the fields'
    update under "adam.update" with the count `fused`."""
    lq = L * q

    def step(params, state, codes, weights, oh_aug):
        J_aug = state["J_aug"]
        with span("plm.value_grad"):
            nll, dJh = nll_vg(J_aug, codes, weights, oh_aug)
            value = (nll
                     + cfg.lambda_h * torch.sum(J_aug[lq].float() ** 2)
                     + cfg.lambda_J * 0.5
                     * torch.sum(J_aug[:lq].float() ** 2))

        count = state["count"] + 1
        bc1i, bc2i = _bias_corrections(count)
        with span("adam.update", fused=1):
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
            return x_t, f_t, sqn, _fit_sync("backtrack", f_t <= bound)

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

    While a torch profiler runs, the fit records the span "fit" (count:
    iterations) over "fit.setup" (with "fit.onehot" where the two-phase
    layout builds its one-hot, and "plm.graph_capture" where the fit
    captures its value+grad), "fit.loop" (every "plm.value_grad", count
    `replayed` where it is a replay; each Adam step's "adam.update", count
    `fused` where K2 takes the epilogue; and every "fit.sync.*" read of
    the device inside it) and "fit.finish" (utils/tracing.span).

    An LBFGS fit on a CUDA device without a mesh evaluates its first
    value+grad eagerly, captures the evaluation as one CUDA graph and
    replays it for every later one (_ValueGradGraph): the same kernels on
    the same values, so the same bits, issued by one launch.

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
    with span("fit"):
        return _fit_plm(codes, weights, num_symbols, cfg, mesh, callback,
                        checkpoint_file, checkpoint_every, device)


def _fit_plm(codes, weights, num_symbols, cfg, mesh, callback,
             checkpoint_file, checkpoint_every, device):
    """fit_plm inside its span: the set-up, the loop and the finish."""
    with span("fit.setup"):
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
        oh_dtype = _exact_dtype(compute_dtype, precision_limbs(cfg.precision),
                                device)
        oh_d = None
        if layout == "two_phase":
            with span("fit.onehot"):
                oh_d = build_augmented_onehot(codes_d, q, oh_dtype)

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

        graph = None
        with matmul_precision(cfg.precision):
            if cfg.solver == "lbfgs":
                def _unflatten_x(x):
                    return {"J": x[:dsize].reshape(lq, lq),
                            "h": x[dsize:].reshape(L, q)}

                def vg_flat(x, codes, weights, oh_aug):
                    value, grads = vg_fn(_unflatten_x(x), codes, weights,
                                         oh_aug)
                    return value.to(dtype), torch.cat(
                        [grads["J"].reshape(-1), grads["h"].reshape(-1)])

                rows_d = (codes_d, w_d, oh_d)
                if resumed is not None:
                    state = resumed
                else:
                    # a parameter-only snapshot restarts the history here
                    x0 = torch.cat([params["J"].reshape(-1),
                                    params["h"].reshape(-1)])
                    value0, grad0 = vg_flat(x0, *rows_d)
                    state = (x0, init_lbfgs_state(x0, value0, grad0,
                                                  m=cfg.memory_size))
                value_grad = vg_flat
                if _replays_value_grad(device, mesh):
                    if resumed is not None:
                        # the capture follows an eager evaluation
                        vg_flat(state[0], *rows_d)
                    graph = value_grad = _ValueGradGraph(vg_flat, state[0],
                                                         rows_d)
                dot, dots = _lbfgs_dots(compute_dtype, cfg.precision, device)
                lb_chunk = make_lbfgs_chunk(
                    value_grad, m=cfg.memory_size,
                    steps_per_call=steps_per_call, conv_tol=cfg.conv_tol,
                    norm_split=dsize, dot=dot, dots=dots)

                def run_chunk(params, state):
                    x, lstate = state
                    x, lstate, metrics = lb_chunk(x, lstate, codes_d, w_d,
                                                  oh_d)
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
                        "mu": {k: torch.zeros_like(v)
                               for k, v in params.items()},
                        "nu": {k: torch.zeros_like(v)
                               for k, v in params.items()},
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
            if checkpoint_file is not None and (mesh is None
                                                or mesh.is_writer):
                # one writer: the ranks hold the same bytes
                def save(params, state, iteration):
                    write_snapshot(checkpoint_file, snapshot_arrays(
                        cfg.solver, params, state, iteration, fingerprint))

    with matmul_precision(cfg.precision):
        try:
            with span("fit.loop"):
                (params, state, table, it, converged, ls_failed, value,
                 last) = _fit_loop(run_chunk, params, state, cfg,
                                   steps_per_call, callback, start_iter, save,
                                   checkpoint_every, resumed is not None)
        finally:
            # whether the loop ends, raises or is abandoned by its callback
            if graph is not None:
                graph.release()
        add_counts(iterations=len(table))
        with span("fit.finish"):
            if cfg.solver == "adam":
                # Adam rows record fx at the PRE-update iterate; one more
                # evaluation prices the parameters actually returned
                value = float(vg_fn(params, codes_d, w_d, oh_d)[0])
            elif last is not None:
                # the final metrics row prices the returned parameters (a
                # chunk may overshoot max_iter with live steps)
                value = float(last[-1][0])
            elif np.isnan(value):
                # the loop never dispatched (a resume at max_iter, or a
                # frozen resumed state): the FISTA state carries the full
                # nonsmooth objective of its last iterate, which vg_fn
                # would smooth
                f_prev = (float(state["f_prev"]) if cfg.solver == "fista"
                          else float("nan"))
                value = (f_prev if np.isfinite(f_prev)
                         else float(vg_fn(params, codes_d, w_d, oh_d)[0]))
            P_mat = params["J"].detach().to("cpu", torch.float64).numpy()
            J_ij = unflatten_J(0.5 * (P_mat + P_mat.T), L, q)
            h_i = params["h"].detach().to("cpu", torch.float64).numpy()
    return PlmFitResult(
        J_ij=J_ij,
        h_i=h_i,
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
        elif ls["converged"] or _fit_sync(
                "resume", torch.sqrt(torch.dot(g, g))
                <= cfg.conv_tol * max(1.0, _fit_sync("resume", torch.sqrt(
                    torch.dot(xd, xd))))):
            converged = True
    # LBFGS rows carry the linesearch-failure flag in column 3
    ls_col = 3 if cfg.solver == "lbfgs" else None
    while it < cfg.max_iter and not converged and not ls_failed:
        n_steps = min(steps_per_call, cfg.max_iter - it)
        params, state, metrics = run_chunk(params, state)
        metrics = np.asarray(_fit_sync("metrics", metrics), dtype=np.float64)
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
