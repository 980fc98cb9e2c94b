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


def test_k4_batch_bitwise_equals_host(cuda):
    from evcouplings_torch.kernels import seqdot

    rng = np.random.default_rng(3)
    v = torch.as_tensor(rng.normal(size=300001).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=300001).astype(np.float32))
    nan = v[:5000].clone()
    nan[4321] = float("nan")
    # odd offsets (4-byte aligned only), x and y misaligned differently,
    # n = 0, 1, 4097 and smaller than one stage, NaN propagation
    pairs = [(v[3:], w[:-3]), (v[1:4098], w[2:4099]), (v[:0], w[:0]),
             (v[7:8], w[9:10]), (v[:4097], w[:4097]), (v, w),
             (nan, w[:5000]), (v[:17], v[:17])]
    before = (seqdot.sequential_dots.launches, seqdot.sequential_dots.chains)
    got = seqdot.sequential_dots([x.to(cuda) for x, _ in pairs],
                                 [y.to(cuda) for _, y in pairs])
    assert (seqdot.sequential_dots.launches - before[0],
            seqdot.sequential_dots.chains - before[1]) == (1, len(pairs))
    for g, (x, y) in zip(got, pairs):
        want = float(seqdot._sequential_dot_plain(x, y))
        g = float(g)
        assert g == want or (np.isnan(g) and np.isnan(want)), (g, want)
    assert float(got[2]) == 0.0 and np.isnan(float(got[6]))


def _k1_check(cuda, m, theta):
    from evcouplings_torch.kernels.reweight import neighbor_counts
    from evcouplings_torch.ops.weights import (
        _identity_count_threshold, _num_cluster_members_plain,
    )

    codes = torch.as_tensor(np.asarray(m).astype(np.int8), device=cuda)
    k = _identity_count_threshold(codes.shape[1], theta)
    got = neighbor_counts(codes, k)
    want = _num_cluster_members_plain(codes, k)
    assert torch.equal(got, want), int((got != want).sum())
    return got


@pytest.mark.parametrize("n,parts", [(4099, 3), (1000, 7), (129, 5)])
def test_k1_tile_ranges_sum_to_the_whole_launch(cuda, n, parts):
    # the range launch of a sharded run: `parts` ranges of the tiles, each
    # equal to the plain version over the same tiles, sum exactly to one
    # whole launch; an empty range (129 rows: 3 tiles in 5 parts) launches
    # nothing and counts nothing
    from evcouplings_torch.kernels.reweight import neighbor_counts, tile_range
    from evcouplings_torch.ops.weights import (
        _identity_count_threshold, _num_cluster_members_plain,
    )

    rng = np.random.default_rng(n)
    m = rng.integers(0, 21, size=(n, 160))
    m[1::3] = m[0]
    codes = torch.as_tensor(m.astype(np.int8), device=cuda)
    k = _identity_count_threshold(160, 0.8)
    before = neighbor_counts.launches
    ranges = [tile_range(n, r, parts) for r in range(parts)]
    got = [neighbor_counts(codes, k, t) for t in ranges]
    assert neighbor_counts.launches - before == sum(
        1 for _, count in ranges if count)
    for t, g in zip(ranges, got):
        assert torch.equal(g, _num_cluster_members_plain(codes, k, t))
    assert torch.equal(sum(got), neighbor_counts(codes, k))


@pytest.mark.parametrize("n,L", [(5, 3), (127, 37), (129, 161), (300, 1)])
def test_k1_ragged_and_all_missing_rows(cuda, n, L):
    # n below one 128-row tile, on either side of a tile edge, odd L; an
    # all -1 row counts nothing (not even itself) unless min_count is 0
    rng = np.random.default_rng(n + L)
    m = rng.integers(0, 21, size=(n, L))
    m[1::4] = m[0]
    m[n // 2] = -1
    m[n - 1] = -1
    got = _k1_check(cuda, m, 0.7)
    assert int(got[n - 1]) == 0
    got = _k1_check(cuda, m, 0.0)
    assert int(got[n - 1]) == n


@pytest.mark.parametrize("L,theta", [(20, 0.85), (40, 0.7), (37, 1.0)])
def test_k1_threshold_on_a_k_over_L_boundary(cuda, L, theta):
    # rows with exactly k identities to row 0 count, rows with k - 1 not
    from evcouplings_torch.ops.weights import _identity_count_threshold

    k = _identity_count_threshold(L, theta)
    rows = [np.zeros(L, dtype=np.int64)]
    for ident in (k, k - 1, k, k + 1):
        if 0 <= ident <= L:
            r = np.zeros(L, dtype=np.int64)
            r[ident:] = 5
            rows.append(r)
    _k1_check(cuda, np.stack(rows * 40), theta)


def test_k1_many_symbols(cuda):
    # q > 32: two 32-symbol slabs per site
    m = np.random.default_rng(1).integers(0, 45, size=(200, 30))
    m[::3] = m[0]
    _k1_check(cuda, m, 0.6)


@pytest.mark.parametrize("solver,extra", [
    ("lbfgs", {}),                                   # parity: K4 dots
    ("adam", {"dtype": "bfloat16"}),                 # fused "auto": K2
    ("fista", {"lambda_group": 0.5}),
])
def test_resume_is_bitwise_on_the_card(cuda, tmp_path, solver, extra):
    """Stopped at 6 and resumed to 12 on the card: the same bits as the
    uninterrupted fit on the card."""
    from evcouplings_torch.ops.plm import PlmConfig, fit_plm

    rng = np.random.default_rng(9)
    codes = rng.integers(0, 5, size=(300, 12)).astype(np.int8)
    w = rng.uniform(0.5, 1.0, 300)

    def cfg(n):
        return PlmConfig(max_iter=n, block_size=64, solver=solver,
                         conv_tol=0.0, **extra)

    ref = fit_plm(codes, w, 5, cfg(12), device=cuda)
    ckpt = str(tmp_path / "fit.npz")
    fit_plm(codes, w, 5, cfg(6), checkpoint_file=ckpt, device=cuda)
    res = fit_plm(codes, w, 5, cfg(12), checkpoint_file=ckpt, device=cuda)
    assert res.iteration_table[0]["iter"] == 7
    np.testing.assert_array_equal(res.J_ij, ref.J_ij)
    np.testing.assert_array_equal(res.h_i, ref.h_i)


def test_float64_inversion_and_di_on_the_card(cuda):
    """The mean-field covariance inverted in float64 on the card, and the
    DI fixed point there, against the host (1e-10)."""
    from evcouplings_torch.ops import mean_field as mf

    rng = np.random.default_rng(4)
    L, q, n = 30, 6, 400
    codes = rng.integers(0, q, size=(n, L))
    oh = np.eye(q)[codes].reshape(n, L * q)
    f_i = 0.5 * oh.mean(0).reshape(L, q) + 0.5 / q
    f_ij = (0.5 * (oh.T @ oh / n).reshape(L, q, L, q).transpose(0, 2, 1, 3)
            + 0.5 / q ** 2)
    idx = np.arange(L)
    f_ij[idx, idx] = 0.5 * np.eye(q)[None] * (oh.mean(0).reshape(L, q)
                                               [:, :, None]) + (
        0.5 / q) * np.eye(q)[None]
    C_cpu = mf.compute_covariance_matrix(f_i, f_ij, device="cpu")
    C = mf.compute_covariance_matrix(f_i, f_ij, device=cuda)
    inv = mf.invert_covariance(C)
    inv_cpu = mf.invert_covariance(C_cpu)
    np.testing.assert_allclose(inv.cpu().numpy(), inv_cpu.numpy(),
                               rtol=1e-10, atol=1e-10)
    J = mf.reshape_invC_to_4d(inv_cpu, L, q)
    di = mf.direct_information(J.to(cuda), f_i, device=cuda)
    np.testing.assert_allclose(
        di.cpu().numpy(), mf.direct_information(J, f_i, device="cpu").numpy(),
        rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("n_i,n_j,block", [(160, 160, 512), (70, 45, 16)])
def test_min_atom_distances_on_the_card_equal_the_host(cuda, n_i, n_j,
                                                       block):
    """The compare stage's float64 contraction: card against host within
    1e-9 A (the same closest atom pair, its difference-form distance),
    zeros exact."""
    import compare_fixtures as cf
    from evcouplings_torch.ops.distances import min_atom_distances

    rng = np.random.default_rng(n_i)
    ci = cf.make_chain(rng, n_i, single_atom=n_i // 2)
    cj = ci if n_i == n_j else cf.moved(cf.make_chain(rng, n_j), rng, 5.0)
    args = (cf.atom_ranges(ci), ci["xyz"], cf.atom_ranges(cj), cj["xyz"])
    card = min_atom_distances(*args, block_rows=block, device=cuda)
    host = min_atom_distances(*args, block_rows=block, device="cpu")
    assert np.abs(card - host).max() <= 1e-9
    assert np.array_equal(card == 0.0, host == 0.0)


def test_gibbs_sampler_on_the_card(cuda):
    """The sampler on the card (no hand-written kernel: cuBLAS products):
    the enumerated Boltzmann distribution (TV < 0.03), the same generator
    seed giving the same codes twice, and at beta = 1e6 the host path's
    final codes code for code (every logit gap along the chain > 1e-3)."""
    import sampling_fixtures as sfx
    from evcouplings_torch.ops.sampling import gibbs_sample

    J, h = sfx.tiny_model(0, 3, 3)
    codes, _ = gibbs_sample(J, h, 20000, 60, seed=1, device=cuda)
    assert sfx.total_variation(codes, sfx.boltzmann(J, h), 3) < 0.03
    again, _ = gibbs_sample(J, h, 20000, 60, seed=1, device=cuda)
    np.testing.assert_array_equal(codes, again)

    J, h = sfx.tiny_model(21, 7, 5, h_scale=1.0, J_scale=0.5)
    init = np.random.default_rng(22).integers(0, 5, (256, 7))
    want, gap = sfx.argmax_chain(J, h, init, 4)
    assert gap > 1e-3, gap
    for device in (cuda, "cpu"):
        got, _ = gibbs_sample(J, h, 256, 4, init_codes=init, beta=1e6,
                              seed=5, device=device)
        np.testing.assert_array_equal(got, want)


def test_device_codes_default_to_the_card(cuda):
    """device_codes(x, dtype) takes the twin's positional dtype and puts
    the codes on the card when no device is named."""
    from evcouplings_torch.ops.encode import device_codes

    m = np.arange(12).reshape(4, 3)
    got = device_codes(m, torch.int8)
    assert got.dtype == torch.int8 and got.device.type == "cuda"
    assert torch.equal(got.cpu(), torch.as_tensor(m, dtype=torch.int8))
