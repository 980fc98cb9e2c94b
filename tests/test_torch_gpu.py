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


def _set_tf32(on):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _plm_inputs(cuda, N=2048, L=60, q=21, seed=5):
    """Codes with gaps, weights and float32 parameters (J ~ N(0, 0.05^2),
    symmetric with zero diagonal blocks) on the card."""
    from evcouplings_torch.ops import plm as tp

    rng = np.random.default_rng(seed)
    codes = rng.integers(-1, q, size=(N, L)).astype(np.int8)
    lq = L * q
    site = np.arange(lq) // q
    A = rng.normal(size=(lq, lq)) * 0.05
    params = {
        "J": torch.as_tensor((0.5 * (A + A.T) * (site[:, None] != site[
            None, :])).astype(np.float32), device=cuda),
        "h": torch.as_tensor((rng.normal(size=(L, q)) * 0.05).astype(
            np.float32), device=cuda)}
    w = torch.as_tensor((rng.random(N) + 0.2).astype(np.float32),
                        device=cuda)
    c = torch.as_tensor(codes, device=cuda)
    oh = tp.build_augmented_onehot(c, q, torch.float32)
    return L, q, c, w, params, oh


@pytest.mark.parametrize("tf32", [False, True])
def test_high_precision_within_1e5_of_float64(cuda, tf32):
    """One evaluation at "high" (two bf16 limb passes): the logits and the
    raw gradient dJh within 1e-5 of the float64 products of the same
    float32 operands, relative to the largest value, whatever the global
    TF32 flag; "default" (one limb) at least 10x further."""
    from evcouplings_torch._device import matmul_precision, precision_limbs
    from evcouplings_torch.ops import plm as tp

    L, q, c, w, params, oh = _plm_inputs(cuda)
    lq_aug = tp._augmented_width(L * q)

    def evaluate(dtype, precision):
        cfg = tp.PlmConfig(dtype={torch.float32: "float32",
                                  torch.float64: "float64"}[dtype],
                           precision=precision, block_size=512)
        p = {k: v.to(dtype) for k, v in params.items()}
        J_aug = tp._build_j_aug(p, L, q, dtype, lq_aug, symmetric=True)
        limbs = precision_limbs(precision)
        with matmul_precision(precision):
            logits = tp._mm(oh.to(tp._exact_dtype(dtype, limbs, cuda)),
                            tp._limb_operand(J_aug, limbs), dtype)
        _, dJh = tp.make_plm_nll_vg(L, q, cfg)(J_aug, c, w.to(dtype))
        return logits.double(), dJh.double()

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        _set_tf32(tf32)
        ref = evaluate(torch.float64, "highest")
        errs = {p: [rel(g, r) for g, r in zip(evaluate(torch.float32, p),
                                                ref)]
                for p in ("high", "default")}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    assert max(errs["high"]) <= 1e-5, errs
    assert max(errs["high"]) * 10 <= min(errs["default"]), errs


def test_products_ignore_the_global_tf32_flag(cuda):
    """"highest" and "high" value+grads, frequencies, MI scores and
    Hamiltonians are bitwise equal with the global TF32 flag set and
    unset: every float32 product pins its own precision."""
    from evcouplings_torch.ops import plm as tp
    from evcouplings_torch.ops.frequencies import pair_frequencies
    from evcouplings_torch.ops.hamiltonian import hamiltonians_device
    from evcouplings_torch.ops.scores import mi_apc_from_codes

    L, q, c, w, params, _ = _plm_inputs(cuda, N=1024, L=30)
    codes = c.cpu().numpy()
    seqs = np.maximum(codes, 0)[:256]
    wn = w.cpu().numpy()
    J_ij = np.random.default_rng(3).normal(size=(L, L, q, q)) * 0.1
    h_i = np.random.default_rng(4).normal(size=(L, q))
    fi = np.full((L, q), 1.0 / q)

    def run():
        out = []
        for precision in ("highest", "high"):
            cfg = tp.PlmConfig(dtype="float32", precision=precision,
                               block_size=512, lambda_J=0.3)
            v, g = tp.make_plm_value_and_grad(L, q, cfg,
                                              symmetric_params=True)(
                params, c, w)
            out += [v.cpu().numpy(), g["J"].cpu().numpy(),
                    g["h"].cpu().numpy()]
        out.append(pair_frequencies(codes, wn, q, fi, device=cuda))
        out += list(mi_apc_from_codes(codes, 0.8, q, device=cuda))
        out.append(hamiltonians_device(seqs, J_ij, h_i, device=cuda))
        return out

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        _set_tf32(False)
        off = run()
        _set_tf32(True)
        on = run()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("precision,takes_k4", [
    ("highest", True), ("high", False), ("default", False)])
def test_card_lbfgs_takes_k4_only_in_parity(cuda, precision, takes_k4):
    """On the card the float32 LBFGS fit takes K4 for its dots at
    "highest" (parity) and torch.dot at "high" and "default" (the
    balanced mode): the host's chain is never taken for a CUDA tensor."""
    from evcouplings_torch.kernels import seqdot
    from evcouplings_torch.ops.plm import PlmConfig, fit_plm

    rng = np.random.default_rng(10)
    codes = rng.integers(0, 5, size=(300, 12)).astype(np.int8)
    before = seqdot.sequential_dots.launches
    res = fit_plm(codes, np.ones(300), 5,
                  PlmConfig(max_iter=4, block_size=64, solver="lbfgs",
                            conv_tol=0.0, precision=precision), device=cuda)
    assert np.isfinite(res.J_ij).all() and np.isfinite(res.h_i).all()
    assert (seqdot.sequential_dots.launches > before) == takes_k4


def _limb_case(cuda, form, L, B, rng):
    """One "high"/"default" product at L sites (q = 21) with B rows, as the
    fits hand it to ops/plm._mm: (float32 operand in the product's
    orientation, limb side maker (limbs -> tuple of bf16 limbs), exact
    bf16 side, `into` or None). "grad" dJh += limbs(r^T) @ [onehot | 1 |
    0], "stored" the two-phase product from the residual store's limbs,
    "logits" [onehot | 1 | 0] @ limbs(J_aug), "logits_t" onehot @
    limbs(J)^T, "sites_grad" the per-site fit's dJ += limbs(r^T) @
    onehot (unpadded one-hot). The product is limb side @ exact side, or
    exact side @ limb side for the logits forms."""
    from evcouplings_torch.ops.plm import (
        _augmented_width, _split_limbs, _transpose,
    )

    q = 21
    lq = L * q
    width = {"grad": _augmented_width(lq), "stored": _augmented_width(lq),
             "logits": _augmented_width(lq)}.get(form, lq)
    codes = rng.integers(-1, q, size=(B, L))
    oh = np.zeros((B, width), np.float32)
    rows, sites = np.nonzero(codes >= 0)
    oh[rows, sites * q + codes[rows, sites]] = 1.0
    if width > lq:
        oh[:, lq] = 1.0
    oh = torch.as_tensor(oh, device=cuda).to(torch.bfloat16)

    def f32(shape, scale):
        # several binades, and exact zeros
        x = rng.normal(size=shape) * scale * np.exp2(rng.integers(-6, 6,
                                                                  shape))
        x[rng.random(shape) < 0.05] = 0.0
        return torch.as_tensor(x.astype(np.float32), device=cuda)

    if form in ("grad", "sites_grad"):
        r = f32((B, lq), 0.1)
        return (r.T, lambda n: _split_limbs(r.T, n), oh,
                f32((lq, width), 1.0))
    if form == "stored":
        r = f32((B, lq), 0.1)
        return r.T, lambda n: _transpose(_split_limbs(r, n)), oh, None
    if form == "logits":
        J = f32((width, lq), 0.05)
        return J, lambda n: _split_limbs(J, n), oh, None
    J = f32((lq, lq), 0.05)
    return J.T, lambda n: _transpose(_split_limbs(J, n)), oh, None


def test_limb_route_matches_float64(cuda):
    """ops/plm._mm's limb route on the card (one torch.mm(...,
    out_dtype=float32) pass per bf16 limb, the passes summed largest limb
    first, the sum added into `into`) in every form the fits take, at
    L=160 (Lq 3360, Lq_aug 3456) with 512- and 2048-row blocks, at 1 and
    2 limbs: within float32 accumulation over depth + limbs terms, at
    twice the IEEE unit (the tensor cores need not round each add as IEEE
    does), of the float64 sum of the same limb products; within the
    limbs' split (2^-8 of sum |a||b| for one limb, 2^-17 for two) more of
    the float64 product of the float32 operand; the same bits on a second
    call."""
    from evcouplings_torch.ops.plm import _mm

    rng = np.random.default_rng(26)
    for B in (512, 2048):
        for form in ("grad", "stored", "logits", "logits_t", "sites_grad"):
            x, make, exact, into = _limb_case(cuda, form, 160, B, rng)
            logits = form.startswith("logits")
            ex64 = exact.double()
            depth = exact.shape[1] if logits else exact.shape[0]
            for limbs in (1, 2):
                side = make(limbs)

                def run():
                    if logits:
                        return _mm(exact, side, torch.float32)
                    return _mm(side, exact, torch.float32, into=None
                               if into is None else into.clone())

                got, again = run(), run()
                parts = [t.double() for t in side]
                terms = [ex64 @ p if logits else p @ ex64 for p in parts]
                absolute = sum(ex64 @ p.abs() if logits else p.abs() @ ex64
                               for p in parts)
                x64 = x.double()
                exact64 = ex64 @ x64 if logits else x64 @ ex64
                x_abs = ex64 @ x64.abs() if logits else x64.abs() @ ex64
                want = sum(terms)
                if into is not None:
                    want = want + into.double()
                    exact64 = exact64 + into.double()
                    absolute = absolute + into.double().abs()
                torch.cuda.synchronize()
                label = (form, B, limbs)
                assert torch.equal(got, again), label
                acc_bound = 2 * (depth + limbs) * 2.0 ** -24 * absolute
                assert bool(((got.double() - want).abs()
                             <= acc_bound).all()), label
                split = 2.0 ** -8 if limbs == 1 else 2.0 ** -17
                assert bool(((got.double() - exact64).abs()
                             <= acc_bound + split * x_abs).all()), label


# (B, L, q): the production block (8192 rows, L = 160, q = 21), and one
# of each of K6's other instantiations: q = 21 with rows of 147 logits,
# not 16-byte aligned; a runtime q with rows of 35; a runtime q with
# 16-byte rows
K6_SHAPES = [(8192, 160, 21), (129, 7, 21), (37, 7, 5), (300, 70, 32)]


@pytest.mark.parametrize("B,L,q", K6_SHAPES)
def test_k6_matches_float64_and_is_bitwise_repeatable(cuda, B, L, q):
    """K6 against K6's formula in float64 from the same bf16 logits,
    codes and weights (gaps, an all-gap row, zero-weight padding rows, a
    site 120 nats below its row's max, past the clamp): each residual
    within one bf16 ulp of the float64 value; no farther from it than the
    plain route's residual, element for element, except where the
    float64 value lies within float32 rounding of a tie between two bf16
    values (K6 rounds a float32 value there); the rows' terms and the
    block's NLL within 1e-6 relative; a second launch the same bits."""
    import epilogue_fixtures as efx
    from evcouplings_torch.kernels import block_epilogue as k6
    from evcouplings_torch.ops.encode import one_hot

    logits, codes, w = (t.to(cuda) for t in efx.epilogue_problem(
        B + L, B, L, q))
    lq = L * q
    # the residual lands in rows of a larger store, as in the fit
    store = torch.full((B + 16, lq), float("nan"), dtype=torch.bfloat16,
                       device=cuda)
    terms = torch.full((B + 4,), float("nan"), device=cuda)
    before = k6.block_epilogue.launches
    k6.block_epilogue(logits, codes, w, q, store[8:8 + B], terms[2:2 + B])
    r2 = torch.empty((B, lq), dtype=torch.bfloat16, device=cuda)
    t2 = torch.empty((B,), device=cuda)
    k6.block_epilogue(logits, codes, w, q, r2, t2)
    oh = one_hot(codes, q, dtype=torch.bfloat16).reshape(B, lq)
    nll_plain, r_plain = k6.block_epilogue_plain(
        logits, oh, codes, w.to(torch.bfloat16), L, q, torch.float32)
    torch.cuda.synchronize()
    assert k6.block_epilogue.launches == before + 2
    r = store[8:8 + B]
    assert torch.equal(r, r2) and torch.equal(terms[2:2 + B], t2)
    assert store[:8].isnan().all() and store[8 + B:].isnan().all()
    assert terms[:2].isnan().all() and terms[2 + B:].isnan().all()

    r64, t64 = efx.epilogue_f64(logits, codes, w, q)
    err = np.abs(r.double().cpu().numpy() - r64)
    err_plain = np.abs(r_plain.double().cpu().numpy() - r64)
    ulp = efx.bf16_ulp(r64)
    assert (err <= ulp).all(), float((err / ulp).max())
    tie = 0.5 * ulp + 2.0 ** -16 * np.abs(r64)
    assert (err <= np.maximum(err_plain, tie)).all()
    assert err.max() <= err_plain.max() and err.sum() <= err_plain.sum()
    got = t2.double().cpu().numpy()
    assert (np.abs(got - t64) <= 1e-6 * np.abs(t64)).all(), float(
        np.abs(got - t64).max())
    nll = float(-t2.sum())
    assert abs(nll - (-t64.sum())) <= 1e-6 * abs(t64.sum())
    # the plain route's NLL, its observed logits summed in bf16, is the
    # farther one
    assert abs(nll + t64.sum()) <= abs(float(nll_plain) + t64.sum())
    # gaps and padding rows: no residual, no term
    assert not r[1].any() and not r[-3:].any()
    assert not t2[1].any() and not t2[-3:].any()


def test_k6_refuses_what_it_does_not_take(cuda):
    """On CUDA tensors the wrapper launches K6 or raises, counting no
    launch: float32 logits, int64 codes, bf16 weights, a residual with a
    column stride."""
    import epilogue_fixtures as efx
    from evcouplings_torch.kernels import block_epilogue as k6

    logits, codes, w = (t.to(cuda) for t in efx.epilogue_problem(0, 16, 6,
                                                                  5))
    r = torch.empty_like(logits)
    t = torch.empty((16,), device=cuda)
    before = k6.block_epilogue.launches
    for args in ((logits.float(), codes, w, 5, r, t),
                 (logits, codes.long(), w, 5, r, t),
                 (logits, codes, w.to(torch.bfloat16), 5, r, t),
                 (logits, codes, w, 5, r.T.contiguous().T, t)):
        with pytest.raises(ValueError):
            k6.block_epilogue(*args)
    assert k6.block_epilogue.launches == before
