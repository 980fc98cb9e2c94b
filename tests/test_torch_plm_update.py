"""The fused Adam epilogue: the port's plain version (what K2/K3 are
held against on the card) against the JAX package's Pallas kernels in
interpret mode and its jnp reference.

Tolerance rtol = atol = 2e-6, the JAX kernel's own gate
(tests/test_plm.py): the same f32 formula evaluated by two compilers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evcouplings_tpu.ops import plm_update as jpu
from evcouplings_torch.ops import plm_update as tpu

TOL = dict(rtol=2e-6, atol=2e-6)


def _rand_state(L, q, rng):
    lq = L * q
    site = np.arange(lq) // q
    mask = (site[:, None] != site[None, :]).astype(np.float32)
    A = rng.normal(size=(lq, lq)).astype(np.float32)
    P = (0.5 * (A + A.T) * mask).astype(np.float32)
    dJh = rng.normal(size=(lq, lq + 32)).astype(np.float32)
    B = rng.normal(size=(lq, lq)).astype(np.float32)
    mu = (0.5 * (B + B.T) * mask).astype(np.float32)
    nu = (np.abs(0.5 * (B + B.T)) * mask).astype(np.float32)
    return dJh, P, mu, nu


def _compare(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            g.float().numpy().astype(np.float64),
            np.asarray(w, dtype=np.float64), **TOL)


# (L, q, seed, lambda_j, lr, bc1i, bc2i): the shapes of the JAX kernel's
# tests, the second with the ragged edge Lq = 30
CASES = [(6, 5, 0, 0.7, 3e-3, 1.25, 1.05), (10, 3, 1, 0.3, 1e-2, 2.0, 1.5)]


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", CASES, ids=["lq30", "lq30edge"])
def test_reference_matches_jax_kernel(case, out_dtype):
    L, q, seed, lam, lr, bc1i, bc2i = case
    dJh, P, mu, nu = _rand_state(L, q, np.random.default_rng(seed))
    kw = dict(q=q, lambda_j=lam, lr=lr)
    got = tpu.adam_update_reference(
        torch.from_numpy(dJh), torch.from_numpy(P), torch.from_numpy(mu),
        torch.from_numpy(nu), bc1i, bc2i,
        out_dtype=getattr(torch, out_dtype), **kw)
    args = [jnp.asarray(a) for a in (dJh, P, mu, nu)]
    jdt = getattr(jnp, out_dtype)
    _compare(got, jpu.fused_adam_update(
        *args, bc1i, bc2i, bi=8, bj=128, interpret=True, out_dtype=jdt,
        **kw))
    _compare(got, jpu.adam_update_reference(*args, bc1i, bc2i,
                                            out_dtype=jdt, **kw))


@pytest.mark.parametrize("case", CASES, ids=["lq30", "lq30edge"])
def test_presym_matches_jax_kernel(case):
    L, q, seed, lam, lr, bc1i, bc2i = case
    lq = L * q
    dJh, P, mu, nu = _rand_state(L, q, np.random.default_rng(seed + 2))
    a = dJh[:, :lq]
    S = a + a.T
    kw = dict(q=q, lambda_j=lam, lr=lr)
    got = tpu.fused_adam_update_presym(
        torch.from_numpy(S), torch.from_numpy(P), torch.from_numpy(mu),
        torch.from_numpy(nu), bc1i, bc2i, **kw)
    want = jpu.fused_adam_update_presym(
        jnp.asarray(S), jnp.asarray(P), jnp.asarray(mu), jnp.asarray(nu),
        bc1i, bc2i, bi=8, bj=128, interpret=True, **kw)
    _compare(got, want)


def test_fused_entry_point_on_cpu_is_the_reference():
    dJh, P, mu, nu = _rand_state(6, 5, np.random.default_rng(4))
    t = [torch.from_numpy(a) for a in (dJh, P, mu, nu)]
    kw = dict(q=5, lambda_j=0.7, lr=3e-3)
    got = tpu.fused_adam_update(*t, 1.25, 1.05, **kw)
    want = tpu.adam_update_reference(*t, 1.25, 1.05, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_adam_constants_match():
    assert (tpu.ADAM_B1, tpu.ADAM_B2, tpu.ADAM_EPS) == (
        jpu.ADAM_B1, jpu.ADAM_B2, jpu.ADAM_EPS)
