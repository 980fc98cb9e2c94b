"""The plain reference against the program's plain (CPU) versions at a tiny
size: they compute the same things by different code."""

import numpy as np
import pytest
import torch

from bench_port import generate, reference

L, Q, N = 9, 21, 240


@pytest.fixture(scope="module")
def codes():
    g = generate.generator(2 ** 31 + 11, torch.device("cpu"))
    return generate.synthetic_codes(g, N, L, Q, families=12, mutate=0.2,
                                    gap_rows=0.1)


def test_generator_repeats_its_seed():
    a, b, c = (generate.synthetic_codes(generate.generator(s, "cpu"), 50, L,
                                        Q, 4, 0.2, 0.1)
               for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.int8 and int(a.min()) >= 0 and int(a.max()) < Q


def test_cluster_counts_match_k1s_plain_version(codes):
    from evcouplings_torch.ops.weights import num_cluster_members

    for theta in (0.8, 0.5):
        want = num_cluster_members(codes, theta).numpy()
        got = reference.cluster_counts(codes, theta, Q, block=64).numpy()
        np.testing.assert_array_equal(got, want)
    assert want.max() > 1


def test_frequencies_match_the_program(codes):
    from evcouplings_torch.ops.frequencies import (frequencies,
                                                   pair_frequencies)

    w = 1.0 / reference.cluster_counts(codes, 0.8, Q).double()
    fi, fij = reference.frequencies(codes, w, Q)
    want_fi = frequencies(codes, w.numpy(), Q, dtype=torch.float64)
    want_fij = pair_frequencies(codes, w.numpy(), Q, want_fi,
                                dtype=torch.float64)
    np.testing.assert_allclose(fi, want_fi, rtol=0, atol=1e-14)
    np.testing.assert_allclose(fij, want_fij, rtol=0, atol=1e-14)


def _plm(codes):
    w = 1.0 / reference.cluster_counts(codes, 0.8, Q).double()
    return reference.Plm(codes, w, Q, 0.01, 0.01 * (Q - 1) * (L - 1),
                         block=64), w


def test_objective_and_gradient_match_the_program(codes):
    from evcouplings_torch.ops.plm import PlmConfig, make_plm_value_and_grad

    plm, w = _plm(codes)
    lq = L * Q
    g = torch.Generator().manual_seed(3)
    P = torch.randn(lq, lq, generator=g, dtype=torch.float64) * 0.05
    P = (P + P.T) * plm.mask
    h = torch.randn(L, Q, generator=g, dtype=torch.float64) * 0.1
    value, grad = plm.value_grad(torch.cat([P.reshape(-1), h.reshape(-1)]))
    cfg = PlmConfig(lambda_h=0.01, lambda_J=plm.lambda_J, dtype="float64",
                    block_size=N)
    vg = make_plm_value_and_grad(L, Q, cfg, symmetric_params=True)
    want_v, want_g = vg({"J": P, "h": h}, codes, w)
    assert abs(float(value) - float(want_v)) <= 1e-12 * abs(float(want_v))
    np.testing.assert_allclose(grad[:lq * lq].reshape(lq, lq),
                               want_g["J"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(grad[lq * lq:].reshape(L, Q), want_g["h"],
                               rtol=0, atol=1e-10)


def test_lbfgs_follows_the_programs_fit(codes):
    from evcouplings_torch.ops.plm import PlmConfig, fit_plm

    plm, w = _plm(codes)
    cfg = PlmConfig(lambda_h=0.01, lambda_J=plm.lambda_J, dtype="float64",
                    max_iter=12, conv_tol=0.0, block_size=N)
    fit = fit_plm(codes.numpy(), w.numpy(), Q, cfg, device="cpu")
    lq = L * Q
    x, rows = reference.lbfgs(plm.value_grad,
                              torch.zeros(lq * lq + lq, dtype=torch.float64),
                              12)
    assert len(rows) == len(fit.iteration_table) == 12
    for r, want in zip(rows, fit.iteration_table):
        # the program records f in float32
        assert abs(r[0] - want["fx"]) <= 2 ** -23 * abs(want["fx"])
    want_x = reference.flat_params(fit.J_ij, fit.h_i)
    np.testing.assert_allclose(x.numpy(), want_x, rtol=0, atol=1e-8)


def test_scores_and_files_match_the_program(tmp_path):
    from evcouplings_torch.couplings.fitter import write_raw_ec_file
    from evcouplings_torch.couplings.model import CouplingsModel
    from evcouplings_torch.ops.scores import apc, fn_scores

    rng = np.random.default_rng(4)
    J = rng.normal(size=(L, L, Q, Q)) * 0.1
    J = 0.5 * (J + J.transpose(1, 0, 3, 2))
    J[np.arange(L), np.arange(L)] = 0
    fn, cn = reference.fn_apc(J)
    np.testing.assert_allclose(fn, fn_scores(J), rtol=0, atol=1e-13)
    np.testing.assert_allclose(cn, apc(fn_scores(J)), rtol=0, atol=1e-13)

    h = rng.normal(size=(L, Q))
    f_i = rng.random((L, Q))
    f_ij = rng.random((L, L, Q, Q))
    weights = rng.random(30)
    model = CouplingsModel.from_params(
        J_ij=J, h_i=h, f_i=f_i, f_ij=f_ij,
        alphabet=np.array(list(reference.GAP_ALPHABET)),
        target_seq=np.array(list("ACDEFGHIK")),
        index_list=np.arange(3, 3 + L), weights=weights, theta=0.8,
        lambda_h=0.01, lambda_J=0.5, lambda_group=0.0, N_valid=30,
        N_invalid=0, num_iter=7, N_eff=12.5)
    model.to_file(tmp_path / "m.model", precision="float32",
                  file_format="plmc_v2")
    got = reference.read_model(tmp_path / "m.model")
    assert got["trailing_bytes"] == 0 and got["num_iter"] == 7
    np.testing.assert_array_equal(got["index_list"], np.arange(3, 3 + L))
    for key, want in (("J_ij", J), ("h_i", h), ("f_i", f_i),
                      ("weights", weights)):
        np.testing.assert_array_equal(got[key],
                                      want.astype(np.float32).astype(float))
    write_raw_ec_file(tmp_path / "ec", np.arange(3, 3 + L),
                      np.array(list("ACDEFGHIK")), fn, cn)
    i, j, fn_f, cn_f = reference.read_ec(tmp_path / "ec")
    ii, jj = np.triu_indices(L, k=1)
    np.testing.assert_array_equal(i, ii + 3)
    np.testing.assert_allclose(cn_f, cn[ii, jj], rtol=0, atol=5.1e-7)
    assert reference.rank_inversions(cn_f, cn[ii, jj], tie=2e-6) == 0


def test_mantissa_rounding_is_tf32s():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -12, -3.14159265])
    got = reference.round_mantissa(x, 10).tolist()
    assert got == [1.0, 1 + 2 ** -10, 1 + 2 ** -10, -3.140625]
