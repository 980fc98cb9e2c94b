"""
Batched Gibbs sampling from Potts models (port of
evcouplings_tpu/ops/sampling.py).

The sampler state is the (S, L*q) one-hot matrix in the compute dtype on
the device, so each site update is one (S, Lq) @ (Lq, q) matrix product
against the site's coupling rows (cuBLAS on the card; the JAX package
leaves this product to XLA, it has no Pallas kernel). A sweep visits the
sites in order; a site update is the logits product, the categorical draw
at inverse temperature beta (the Gumbel-max trick) and the write-back of
the site's one-hot block: about five launches per site.

Randomness: the draws come from a torch.Generator on the device (`key`,
or a new one seeded with `seed`); JAX's PRNG stream is not reproduced, so
the port's draws differ from the JAX package's, while their distribution
is the same. Each sweep takes one block of uniforms, (L, S, q), so the
draws do not depend on `thin`.
"""

import numpy as np
import torch

from evcouplings_torch._device import matmul_precision, resolve_device
from evcouplings_torch.ops.encode import flatten_J, one_hot

# the Gumbel noise -log(-log(u)) is finite for u in [_TINY, 1)
_TINY = torch.finfo(torch.float32).tiny


def _gumbel_plus(bias, generator):
    """Fresh Gumbel noise of bias's shape, plus bias (float32)."""
    noise = torch.rand(bias.shape, generator=generator,
                       device=bias.device, dtype=torch.float32)
    noise.clamp_(min=_TINY).log_().neg_().log_().neg_()
    return noise.add_(bias)


def _gibbs_chain(J_flat, h_flat, generator, codes, n_sweeps, thin, beta):
    """Run n_sweeps sweeps from `codes` ((S, L) int64 on the device).
    Returns the final codes and the states after every thin-th sweep, both
    int8 on the device."""
    n_samples, L = codes.shape
    lq = h_flat.shape[0]
    q = lq // L
    oh = one_hot(codes, q, dtype=J_flat.dtype).reshape(n_samples, lq)
    # the site's q coupling rows, transposed (views, no copies)
    rows_t = [J_flat[i * q:(i + 1) * q].T for i in range(L)]
    # beta * h_i, rounded to the compute dtype first as the JAX package's
    # logits are: float32, broadcast over the chains as an (L, S, q) view
    bias = (beta * h_flat.float().reshape(L, 1, q)).expand(L, n_samples, q)

    def states():
        return oh.reshape(n_samples, L, q).argmax(dim=2).to(torch.int8)

    kept = []
    for sweep in range(n_sweeps):
        z_all = _gumbel_plus(bias, generator)
        for i in range(L):
            # conditional logits of site i for every chain: the site's q
            # coupling rows against the full one-hot context (the site's
            # own block contributes nothing: the diagonal q x q blocks of
            # J are zero by model convention)
            z = z_all[i].add_(torch.mm(oh, rows_t[i]), alpha=beta)
            new = z.argmax(dim=1, keepdim=True)
            block = oh[:, i * q:(i + 1) * q]
            block.zero_()
            block.scatter_(1, new, 1.0)
        if (sweep + 1) % thin == 0:
            kept.append(states())
    return states(), kept


def gibbs_sample(J_ij, h_i, n_samples, n_sweeps, key=None, seed=0,
                 init_codes=None, beta=1.0, thin=None, dtype=torch.float32,
                 device=None):
    """Draw sequences from a Potts model by blocked Gibbs sampling.

    Parameters
    ----------
    J_ij : (L, L, q, q) couplings (zero diagonal blocks)
    h_i : (L, q) fields
    n_samples : number of parallel chains (one sequence each)
    n_sweeps : full site sweeps per chain
    key : torch.Generator on `device` (or use `seed`)
    init_codes : optional (n_samples, L) int initial states; random
        uniform if absent
    beta : inverse temperature
    thin : if set, additionally return every `thin`-th sweep of every
        chain (trajectory of shape (n_sweeps//thin, n_samples, L))
    dtype : torch compute dtype of the state and the logit products
        (float32, or bfloat16)
    device : where the chains run (None: the CUDA device; "cpu": the host)

    Returns
    -------
    codes : (n_samples, L) int8 numpy final states
    trajectory : as above (int8 numpy), or None when `thin` is None
    """
    device = resolve_device(device)
    h_i = np.asarray(h_i)
    L, q = h_i.shape

    if key is None:
        key = torch.Generator(device=device).manual_seed(int(seed))
    elif torch.device(key.device).type != device.type:
        raise ValueError(
            "key is a generator on {}, the chains run on {}".format(
                key.device, device))

    return_traj = thin is not None
    if return_traj and not 0 < thin <= n_sweeps:
        raise ValueError(
            "thin must be in [1, n_sweeps] (got thin={}, "
            "n_sweeps={})".format(thin, n_sweeps)
        )
    thin = thin or max(1, n_sweeps)

    if init_codes is None:
        codes = torch.randint(0, q, (int(n_samples), L), generator=key,
                              device=device)
    else:
        codes = torch.as_tensor(
            np.asarray(init_codes, dtype=np.int8), device=device).long()

    J = J_ij if isinstance(J_ij, torch.Tensor) else torch.as_tensor(
        np.asarray(J_ij))
    J_flat = flatten_J(J.to(device)).to(dtype).contiguous()
    h_flat = torch.as_tensor(h_i, device=device).to(dtype).reshape(L * q)

    with matmul_precision("highest"):
        final, kept = _gibbs_chain(J_flat, h_flat, key, codes,
                                   int(n_sweeps), int(thin), float(beta))
    codes = final.cpu().numpy()
    if not return_traj:
        return codes, None
    traj = (torch.stack(kept).cpu().numpy() if kept
            else np.zeros((0, int(n_samples), L), dtype=np.int8))
    return codes, traj


def sample_from_model(model, n_samples, n_sweeps=500, **kwargs):
    """Sample sequences from a CouplingsModel; returns them as strings
    over the model's alphabet."""
    codes, _ = gibbs_sample(
        model.J_ij, model.h_i, n_samples, n_sweeps, **kwargs
    )
    alphabet = np.asarray(model.alphabet)
    return ["".join(alphabet[row]) for row in codes]
