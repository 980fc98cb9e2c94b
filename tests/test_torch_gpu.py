"""The port's kernels on the card against their plain versions (marked
`gpu`; they skip without a CUDA device). Run them on a machine with the
card, which has no JAX for tests/conftest.py to import:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    # decided per test, never at import: every worker collects the same
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n,L", [(1000, 37), (4099, 160)])
def test_k1_counts_equal_plain(cuda, n, L):
    from evcouplings_torch.kernels.reweight import neighbor_counts
    from evcouplings_torch.ops.weights import (
        _identity_count_threshold, _num_cluster_members_plain,
    )

    rng = np.random.default_rng(n)
    m = rng.integers(0, 21, size=(n, L))
    m[1::3] = m[0]
    m[5::17, : L // 2] = -1
    codes = torch.as_tensor(m.astype(np.int8), device=cuda)
    k = _identity_count_threshold(L, 0.8)
    assert torch.equal(neighbor_counts(codes, k),
                       _num_cluster_members_plain(codes, k))


@pytest.mark.parametrize("presym", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k2_k3_match_reference(cuda, presym, out_dtype):
    from evcouplings_torch.kernels import adam_update
    from evcouplings_torch.ops.plm_update import adam_update_reference

    L, q = 10, 3
    lq = L * q
    rng = np.random.default_rng(1)
    site = np.arange(lq) // q
    mask = (site[:, None] != site[None, :]).astype(np.float32)
    A = rng.normal(size=(lq, lq)).astype(np.float32)
    P = torch.as_tensor(0.5 * (A + A.T) * mask, device=cuda)
    mu = torch.as_tensor(0.5 * (A - A.T) ** 2 * mask, device=cuda)
    nu = mu.abs()
    dJh = torch.as_tensor(rng.normal(size=(lq, lq + 34)).astype(np.float32),
                          device=cuda)
    kw = dict(q=q, lambda_j=0.3, lr=1e-2, out_dtype=out_dtype)
    if presym:
        S = (dJh[:, :lq] + dJh[:, :lq].T).contiguous()
        got = adam_update.fused_adam_update_presym_cuda(
            S, P, mu, nu, 2.0, 1.5, **kw)
    else:
        got = adam_update.fused_adam_update_cuda(dJh, P, mu, nu, 2.0, 1.5,
                                                 **kw)
    want = adam_update_reference(dJh, P, mu, nu, 2.0, 1.5, **kw)
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=2e-6, atol=2e-6)
    torch.testing.assert_close(got[4], want[4], rtol=1e-5, atol=0)


def test_k4_bitwise_equals_host(cuda):
    from evcouplings_torch.kernels.seqdot import (
        _sequential_dot_plain, sequential_dot,
    )

    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=100003).astype(np.float32))
    y = torch.as_tensor(rng.normal(size=100003).astype(np.float32))
    got = sequential_dot(x.to(cuda), y.to(cuda))
    assert float(got) == float(_sequential_dot_plain(x, y))
