"""
Fused epilogue of the PLM Adam step (port of
evcouplings_tpu/ops/plm_update.py).

After the two GEMM phases of the PLM gradient (ops/plm.py), the rest of an
Adam step is elementwise over (Lq, Lq) float32 arrays:

    g   = mask * (0.5 * (dJh + dJh^T) + lambda_J * P)   # zero diagonal q x q blocks
    mu' = b1 * mu + (1 - b1) * g
    nu' = b2 * nu + (1 - b2) * g^2
    P'  = P - lr * (mu' * bc1i) / (sqrt(nu' * bc2i) + eps)
    J'  = (P' * mask) in the compute dtype               # next step's couplings
    gsq = sum(g^2)

fused_adam_update does it in one pass: on a CUDA tensor through K2, the
Triton kernel in kernels/adam_update.py; on a CPU tensor through the plain
version adam_update_reference. fused_adam_update_presym (K3) takes
S = dJh + dJh^T already built.

The symmetrized form relies on P being exactly symmetric with zero
diagonal blocks, which the fit keeps by construction (symmetric zero
init, symmetric masked updates).
"""

import torch

# Adam hyperparameters fixed to the optax.adam defaults the unfused path
# uses (optax.scale_by_adam: b1, b2, eps, eps_root=0)
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


def _site_mask(lq, q, dtype, device):
    """(Lq, Lq) mask, 0 on the L diagonal q x q blocks, 1 elsewhere."""
    site = torch.arange(lq, device=device) // q
    return (site[:, None] != site[None, :]).to(dtype)


def _update(S_half, P, mu, nu, bc1i, bc2i, q, lambda_j, lr, out_dtype):
    lq = P.shape[0]
    mask = _site_mask(lq, q, torch.float32, P.device)
    g = (S_half + lambda_j * P) * mask
    mu2 = ADAM_B1 * mu + (1.0 - ADAM_B1) * g
    nu2 = ADAM_B2 * nu + (1.0 - ADAM_B2) * (g * g)
    upd = lr * (mu2 * bc1i) / (torch.sqrt(nu2 * bc2i) + ADAM_EPS)
    p2 = P - upd
    return (p2, mu2, nu2, (p2 * mask).to(out_dtype),
            torch.sum(g * g).reshape(1, 1))


def adam_update_reference(dJh, P, mu, nu, bc1i, bc2i, *, q, lambda_j,
                          lr, out_dtype=torch.bfloat16):
    """Plain PyTorch version of K2: the whole step in ordinary tensor ops.

    dJh : (Lq, >= Lq) float32 raw NLL gradient GEMM output (columns past
        Lq, e.g. the dh column and padding, are ignored)
    P, mu, nu : (Lq, Lq) float32 master parameters and Adam moments
    bc1i, bc2i : inverse Adam bias corrections 1 / (1 - b^t)

    Returns (P', mu', nu', J_eff', gsq) with gsq a (1, 1) float32 tensor.
    """
    lq = P.shape[0]
    a = dJh[:, :lq]
    return _update(0.5 * (a + a.T), P, mu, nu, bc1i, bc2i, q, lambda_j,
                   lr, out_dtype)


def fused_adam_update(dJh, P, mu, nu, bc1i, bc2i, *, q, lambda_j, lr,
                      out_dtype=torch.bfloat16):
    """Fused symmetrize + l2 + Adam + J emit (K2 on CUDA tensors, the
    plain version on CPU tensors); same contract as
    adam_update_reference."""
    if P.is_cuda:
        from evcouplings_torch.kernels.adam_update import (
            fused_adam_update_cuda,
        )

        return fused_adam_update_cuda(
            dJh, P, mu, nu, bc1i, bc2i, q=q, lambda_j=lambda_j, lr=lr,
            out_dtype=out_dtype,
        )
    if P.device.type != "cpu":
        raise ValueError("no fused Adam path for device {}".format(P.device))
    return adam_update_reference(
        dJh, P, mu, nu, bc1i, bc2i, q=q, lambda_j=lambda_j, lr=lr,
        out_dtype=out_dtype,
    )


def fused_adam_update_presym(S, P, mu, nu, bc1i, bc2i, *, q, lambda_j,
                             lr, out_dtype=torch.bfloat16):
    """fused_adam_update with the symmetrization hoisted to the caller:
    S must be dJh[:, :Lq] + dJh[:, :Lq].T (K3 on CUDA tensors)."""
    if P.is_cuda:
        from evcouplings_torch.kernels.adam_update import (
            fused_adam_update_presym_cuda,
        )

        return fused_adam_update_presym_cuda(
            S, P, mu, nu, bc1i, bc2i, q=q, lambda_j=lambda_j, lr=lr,
            out_dtype=out_dtype,
        )
    if P.device.type != "cpu":
        raise ValueError("no fused Adam path for device {}".format(P.device))
    return _update(0.5 * S, P, mu, nu, bc1i, bc2i, q, lambda_j, lr,
                   out_dtype)
