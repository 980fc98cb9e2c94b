"""
K2/K3: the fused symmetrize + l2 + Adam + J emit pass of the PLM Adam step,
written in Triton for Hopper.

Replaces the TPU kernels evcouplings_tpu/ops/plm_update.py::_update_kernel
(K2, launched by fused_adam_update) and ::_update_kernel_presym (K3,
launched by fused_adam_update_presym). One @triton.jit function serves
both: the constexpr flag PRESYM selects whether the caller passes the raw
gradient GEMM output dJh (K2: the transposed tile is read from the same
array) or S = dJh + dJh^T already built (K3).

Per (BI, BJ) tile of the (Lq, Lq) matrices:

    live = (row site != col site) & in range
    g    = live ? 0.5 * (dJh + dJh^T) + lambda_J * P : 0   (0.5 * S for K3)
    mu'  = b1 mu + (1 - b1) g ;  nu' = b2 nu + (1 - b2) g^2
    P'   = P - lr * (mu' bc1i) / (sqrt(nu' bc2i) + eps)
    J'   = live ? P' : 0, cast to the compute dtype
    partial[program] = sum(g^2)

What bounds it: device-memory bytes. Per element it reads dJh, dJh^T, P,
mu, nu (5 x f32; 4 for K3) and writes P', mu', nu' (3 x f32) and J'
(2 or 4 bytes), with ~15 flops: far below the card's flop/byte balance.
The design reads each stream once with masked, coalesced loads; the
transposed tile is loaded as a (BJ, BI) block whose fast axis is
contiguous in memory and transposed in registers with tl.trans. The
ragged Lq edge is masked. sum(g^2) is deterministic: each program writes
its partial to its own slot and the wrapper reduces the slots with one
fixed-shape torch.sum (no float atomics, so the gradient norm in the
iteration table is the same from run to run).

This module imports no triton at load time (CPU hosts have none): the
kernel body is a plain function that names `tl`, and _jit() binds the
module global `tl` to triton.language and jits it at the first launch.
"""

from __future__ import annotations

import torch

# Adam constants, fixed to optax.adam's defaults as in the JAX package
# (ops/plm_update.py ADAM_B1/B2/EPS); duplicated from
# evcouplings_torch/ops/plm_update.py so this module stands alone
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8

BLOCK_I = 64
BLOCK_J = 64

tl = None       # triton.language, bound by _jit() at the first launch
_jitted = None


def _adam_update_kernel(
    a_ptr, lda, p_ptr, mu_ptr, nu_ptr,
    p_out_ptr, mu_out_ptr, nu_out_ptr, jeff_ptr, part_ptr,
    lq, q, lambda_j, lr, bc1i, bc2i,
    B1: tl.constexpr, B2: tl.constexpr, EPS: tl.constexpr,
    PRESYM: tl.constexpr, BI: tl.constexpr, BJ: tl.constexpr,
):
    pid_i = tl.program_id(0)
    pid_j = tl.program_id(1)
    rows = pid_i * BI + tl.arange(0, BI)
    cols = pid_j * BJ + tl.arange(0, BJ)
    in_r = rows < lq
    in_c = cols < lq
    inb = in_r[:, None] & in_c[None, :]
    live = inb & ((rows // q)[:, None] != (cols // q)[None, :])

    a = tl.load(a_ptr + rows[:, None] * lda + cols[None, :],
                mask=inb, other=0.0)
    off = rows[:, None] * lq + cols[None, :]
    p = tl.load(p_ptr + off, mask=inb, other=0.0)
    mu = tl.load(mu_ptr + off, mask=inb, other=0.0)
    nu = tl.load(nu_ptr + off, mask=inb, other=0.0)

    if PRESYM:
        g = 0.5 * a + lambda_j * p
    else:
        # tile (cols, rows) of dJh: the fast (last) axis runs over rows,
        # contiguous in memory, then transposed in registers
        at = tl.load(a_ptr + cols[:, None] * lda + rows[None, :],
                     mask=in_c[:, None] & in_r[None, :], other=0.0)
        g = 0.5 * (a + tl.trans(at)) + lambda_j * p
    g = tl.where(live, g, 0.0)

    mu2 = B1 * mu + (1.0 - B1) * g
    nu2 = B2 * nu + (1.0 - B2) * (g * g)
    upd = lr * (mu2 * bc1i) / (tl.sqrt(nu2 * bc2i) + EPS)
    p2 = p - upd

    tl.store(p_out_ptr + off, p2, mask=inb)
    tl.store(mu_out_ptr + off, mu2, mask=inb)
    tl.store(nu_out_ptr + off, nu2, mask=inb)
    jeff = tl.where(live, p2, 0.0)
    tl.store(jeff_ptr + off, jeff.to(jeff_ptr.dtype.element_ty), mask=inb)

    tl.store(part_ptr + pid_i * tl.num_programs(1) + pid_j,
             tl.sum(tl.sum(g * g, axis=1), axis=0))


def _jit():
    global tl, _jitted
    if _jitted is None:
        import triton
        import triton.language

        tl = triton.language
        _jitted = triton.jit(_adam_update_kernel)
    return _jitted


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError("{} is on {}, expected {}".format(
            name, t.device, device))
    if t.dtype != dtype:
        raise ValueError("{} must be {}, got {}".format(name, dtype, t.dtype))
    if tuple(t.shape) != shape:
        raise ValueError("{} must have shape {}, got {}".format(
            name, shape, tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("{} must be contiguous".format(name))


def _launch(a, P, mu, nu, bc1i, bc2i, q, lambda_j, lr, out_dtype, presym):
    """Check the operands and launch the kernel: K2 (presym=False: `a`
    is dJh, (Lq, >= Lq) f32 with unit column stride) or K3 (presym=True:
    `a` is S = dJh + dJh^T, (Lq, Lq)).

    Returns (P', mu', nu', J_eff', gsq) as fused_adam_update in
    ops/plm_update.py, gsq a (1, 1) f32 tensor.
    """
    if not P.is_cuda:
        raise ValueError("the fused Adam kernels need CUDA tensors")
    device = P.device
    lq = P.shape[0]
    for name, t in (("P", P), ("mu", mu), ("nu", nu)):
        _check(name, t, (lq, lq), torch.float32, device)
    if a.device != device or a.dtype != torch.float32 or a.dim() != 2:
        raise ValueError("dJh/S must be a 2-D float32 tensor on {}".format(
            device))
    if a.shape[0] != lq or a.shape[1] < lq or (presym and a.shape[1] != lq):
        raise ValueError("dJh/S has shape {}, expected ({}, {}{})".format(
            tuple(a.shape), lq, ">=" if not presym else "", lq))
    if a.stride(1) != 1:
        raise ValueError("dJh/S must have unit column stride")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("out_dtype must be bfloat16 or float32")

    kernel = _jit()
    grid = (-(-lq // BLOCK_I), -(-lq // BLOCK_J))
    P2 = torch.empty_like(P)
    mu2 = torch.empty_like(mu)
    nu2 = torch.empty_like(nu)
    J2 = torch.empty((lq, lq), dtype=out_dtype, device=device)
    partial = torch.empty(grid[0] * grid[1], dtype=torch.float32,
                          device=device)
    with torch.cuda.device(device):
        kernel[grid](
            a, a.stride(0), P, mu, nu, P2, mu2, nu2, J2, partial,
            lq, q, float(lambda_j), float(lr), float(bc1i), float(bc2i),
            B1=ADAM_B1, B2=ADAM_B2, EPS=ADAM_EPS, PRESYM=bool(presym),
            BI=BLOCK_I, BJ=BLOCK_J, num_warps=4,
        )
    # fixed-shape reduction of the per-program partials: deterministic
    gsq = partial.sum().reshape(1, 1)
    return P2, mu2, nu2, J2, gsq


def fused_adam_update_cuda(dJh, P, mu, nu, bc1i, bc2i, *, q, lambda_j, lr,
                           out_dtype=torch.bfloat16):
    """Launch K2 on the raw gradient product dJh ((Lq, >= Lq) float32,
    unit column stride); contract of ops/plm_update.fused_adam_update."""
    out = _launch(dJh, P, mu, nu, bc1i, bc2i, q, lambda_j, lr, out_dtype,
                  presym=False)
    fused_adam_update_cuda.launches += 1
    return out


def fused_adam_update_presym_cuda(S, P, mu, nu, bc1i, bc2i, *, q, lambda_j,
                                  lr, out_dtype=torch.bfloat16):
    """Launch K3 on S = dJh + dJh^T ((Lq, Lq) float32); contract of
    ops/plm_update.fused_adam_update_presym."""
    out = _launch(S, P, mu, nu, bc1i, bc2i, q, lambda_j, lr, out_dtype,
                  presym=True)
    fused_adam_update_presym_cuda.launches += 1
    return out


fused_adam_update_cuda.launches = 0
fused_adam_update_presym_cuda.launches = 0
