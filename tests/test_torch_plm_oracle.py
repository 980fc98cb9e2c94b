"""The port's symmetric PLM fit held against the independent float64 plmc
oracle (tests/oracle_plm.py, numpy only), through the cases of
tests/test_plm_oracle.py that tests/test_torch_{fista,plm,plm_sites}.py
do not hold: the objective and its gradient for each CASES entry, the
float64 fit reaching the oracle optimum, the parity-mode fit's EC ranks,
the `.model` fields, run_plm's artifacts (with and without ignore_gaps,
and with theta and scale), and the refusals (LBFGS with the exact group
penalty, the asymmetric fit with it, FISTA contradicting the smoothed
opt-in), each refusal through both packages.

The inputs are the JAX file's own (its CASES and seeds); the weights come
from the port's reweighting and are held exactly equal to the JAX
package's. Tolerances are the JAX file's: the objective within 1e-12
relative, the gradient within rtol 1e-9 / atol 1e-11, the float64 fit
within 5e-6 on h and 1e-6 on J (plus 2e-7 of float32 storage in a
`.model`) with the EC rank order exact, the float32 parity fit within
1e-2 on h and 2e-3 on J with the ranks exact.
"""

import numpy as np
import pytest
import torch

import oracle_plm as oracle
from evcouplings_tpu.couplings.fitter import run_plm as jax_run_plm
from evcouplings_tpu.ops import plm as jax_plm
from evcouplings_tpu.ops.weights import (
    num_cluster_members as jax_num_cluster_members,
)
from evcouplings_torch.couplings.fitter import run_plm
from evcouplings_torch.couplings.model import CouplingsModel
from evcouplings_torch.couplings.pairs import read_raw_ec_file
from evcouplings_torch.ops import scores
from evcouplings_torch.ops.frequencies import frequencies, pair_frequencies
from evcouplings_torch.ops.plm import (
    PlmConfig, fit_plm, make_plm_loss, make_plm_value_and_grad,
)
from evcouplings_torch.ops.weights import num_cluster_members
from oracles import o_num_cluster_members
from test_plm_oracle import CASES, _pad
from test_plm_oracle import TestFitParity as _FitParity

# the JAX file's gates (its class is bound under a private name, so this
# file does not collect and run it again)
H_ATOL, J_ATOL = _FitParity.H_ATOL, _FitParity.J_ATOL


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights_for(codes, theta=0.8):
    gapless = np.where(codes < 0, 0, codes).astype(np.int8)
    counts = num_cluster_members(gapless, theta, device="cpu").numpy()
    np.testing.assert_array_equal(
        counts, np.asarray(jax_num_cluster_members(gapless, theta)))
    return 1.0 / counts


def _case(name):
    import zlib

    N, L, q, gap_frac, lh, lj = CASES[name]
    codes = oracle.synthetic_msa(
        N, L, q, seed=zlib.crc32(name.encode()) % 2 ** 16,
        gap_frac=gap_frac)
    return codes, _weights_for(codes), L, q, lh, lj


def _params(h, J, L, q):
    P = np.transpose(J, (0, 2, 1, 3)).reshape(L * q, L * q)
    return {"J": torch.as_tensor(P), "h": torch.as_tensor(h)}


def _random_point(L, q, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(L, q)) * 0.3
    J_pairs = rng.normal(size=(L * (L - 1) // 2, q, q)) * 0.2
    return h, J_pairs


def _cn_rank_order(J):
    cn = scores.apc(scores.fn_scores(J))
    ii, jj = np.triu_indices(cn.shape[0], k=1)
    vals = cn[ii, jj]
    return np.argsort(-vals, kind="stable"), vals


def _oracle_fit(codes, weights, q, lh, lj):
    ref = oracle.fit(codes, weights, q, lambda_h=lh, lambda_J=lj,
                     epsilon=1e-8, polish=True)
    assert ref["result"]["converged"]
    return ref


def _f64_fit(codes, weights, q, lh, lj):
    cfg = PlmConfig(lambda_h=lh, lambda_J=lj, max_iter=3000,
                    conv_tol=1e-10, block_size=16, dtype="float64",
                    steps_per_call=10)
    fit = fit_plm(codes, weights, q, cfg, device="cpu")
    # conv_tol 1e-10 sits below the float64 floor: the fit runs to its
    # rounding-error stop, like plmc at -t 0
    assert fit.converged or fit.ls_failed
    return fit


@pytest.mark.parametrize("name", list(CASES))
def test_objective_value_matches_oracle(name):
    codes, weights, L, q, lh, lj = _case(name)
    h, J_pairs = _random_point(L, q, 7)
    f_oracle, _ = oracle.objective(oracle.pack(h, J_pairs), codes, weights,
                                   q, lh, lj)
    cp, wp = _pad(codes, weights, 16)
    loss = make_plm_loss(L, q, PlmConfig(lambda_h=lh, lambda_J=lj,
                                         block_size=16, dtype="float64"))
    f_port = float(loss(_params(h, oracle.pairs_to_tensor(J_pairs, L, q),
                                L, q),
                        torch.as_tensor(cp), torch.as_tensor(wp)))
    assert f_port == pytest.approx(f_oracle, rel=1e-12)


@pytest.mark.parametrize("name", list(CASES))
def test_gradient_matches_oracle(name):
    codes, weights, L, q, lh, lj = _case(name)
    h, J_pairs = _random_point(L, q, 11)
    _, g = oracle.objective(oracle.pack(h, J_pairs), codes, weights, q, lh,
                            lj)
    g_h, g_J = oracle.unpack(g, L, q)
    cp, wp = _pad(codes, weights, 16)
    vg = make_plm_value_and_grad(L, q, PlmConfig(
        lambda_h=lh, lambda_J=lj, block_size=16, dtype="float64"))
    _, grads = vg(_params(h, oracle.pairs_to_tensor(J_pairs, L, q), L, q),
                  torch.as_tensor(cp), torch.as_tensor(wp))
    np.testing.assert_allclose(grads["h"].numpy(), g_h, rtol=1e-9,
                               atol=1e-11)
    # each shared pair parameter is spread over both triangles of the flat
    # matrix: its per-entry gradient is half the shared one
    dP = grads["J"].numpy().reshape(L, q, L, q).transpose(0, 2, 1, 3)
    ii, jj = oracle.pair_index(L)
    for p, (i, j) in enumerate(zip(ii, jj)):
        np.testing.assert_allclose(2.0 * dP[i, j], g_J[p], rtol=1e-9,
                                   atol=1e-11)


@pytest.mark.parametrize("name", list(CASES))
def test_f64_fit_matches_oracle_optimum(name):
    codes, weights, L, q, lh, lj = _case(name)
    ref = _oracle_fit(codes, weights, q, lh, lj)
    fit = _f64_fit(codes, weights, q, lh, lj)
    np.testing.assert_allclose(fit.h_i, ref["h"], atol=H_ATOL)
    np.testing.assert_allclose(fit.J_ij, ref["J"], atol=J_ATOL)
    order_ref, vals_ref = _cn_rank_order(ref["J"])
    order_fit, vals_fit = _cn_rank_order(fit.J_ij)
    np.testing.assert_array_equal(order_fit, order_ref)
    np.testing.assert_allclose(vals_fit, vals_ref, atol=1e-6)


def test_parity_mode_fit_matches_oracle_ranks():
    """float32 with IEEE products (the plmc-replacement configuration):
    the EC rank order exactly; the parameters within the float32
    linesearch floor."""
    codes, weights, L, q, lh, lj = _case("small_q6")
    ref = _oracle_fit(codes, weights, q, lh, lj)
    cfg = PlmConfig(lambda_h=lh, lambda_J=lj, max_iter=3000, conv_tol=1e-6,
                    block_size=16, dtype="float32", precision="highest",
                    steps_per_call=10)
    fit = fit_plm(codes, weights, q, cfg, device="cpu")
    assert fit.converged or fit.ls_failed
    np.testing.assert_allclose(fit.h_i, ref["h"], atol=1e-2)
    np.testing.assert_allclose(fit.J_ij, ref["J"], atol=2e-3)
    np.testing.assert_array_equal(_cn_rank_order(fit.J_ij)[0],
                                  _cn_rank_order(ref["J"])[0])


def test_model_file_fields_match_oracle(tmp_path):
    codes, weights, L, q, lh, lj = _case("small_q6")
    ref = _oracle_fit(codes, weights, q, lh, lj)
    fit = _f64_fit(codes, weights, q, lh, lj)
    alphabet = "-ACDEF"[:q]
    f_i = frequencies(codes, weights, q, dtype=torch.float64, device="cpu")
    f_ij = pair_frequencies(codes, weights, q, f_i, dtype=torch.float64,
                            device="cpu")
    target = np.array(list(alphabet))[np.where(codes[0] < 0, 0, codes[0])]
    model = CouplingsModel.from_params(
        J_ij=fit.J_ij, h_i=fit.h_i, f_i=np.asarray(f_i),
        f_ij=np.asarray(f_ij), alphabet=alphabet, target_seq=target,
        index_list=np.arange(1, L + 1), weights=weights, theta=0.8,
        lambda_h=lh, lambda_J=lj, lambda_group=0.0,
        N_valid=codes.shape[0], N_invalid=0, num_iter=fit.num_iter,
        N_eff=float(weights.sum()))
    path = str(tmp_path / "oracle_case.model")
    model.to_file(path, precision="float32", file_format="plmc_v2")
    loaded = CouplingsModel(path, device="cpu")
    np.testing.assert_allclose(loaded.h_i, ref["h"], atol=H_ATOL)
    np.testing.assert_allclose(loaded.J_ij, ref["J"], atol=J_ATOL + 2e-7)


def _write_fasta(path, codes, alphabet):
    L = codes.shape[1]
    with open(path, "w") as f:
        for s, row in enumerate(codes):
            f.write(">seq{}/1-{}\n{}\n".format(
                s, L, "".join(alphabet[c] for c in row)))


@pytest.mark.parametrize("case", ["plain", "ignore_gaps", "theta_scale"])
def test_run_plm_artifacts_match_oracle(tmp_path, case):
    """The whole run_plm chain (file in, reweighting, float64 fit, .model
    and raw EC file out) on the oracle's optimum under the literal-loop
    reweighting oracle's weights: the JAX file's three artifact cases.
    ignore_gaps makes gap positions missing data in the likelihood while
    the reweighting still counts them; theta and scale set the identity
    threshold and the weights' numerator."""
    if case == "plain":
        q, alphabet, L, N = 6, "-ACDEF", 8, 20
        codes = oracle.synthetic_msa(N, L, q, seed=99, n_coupled=2)
        theta, scale, kw = 0.8, 1.0, {}
    elif case == "ignore_gaps":
        q, alphabet, L, N = 5, "-ACDE", 7, 18
        rng = np.random.default_rng(123)
        codes = oracle.synthetic_msa(N, L, q, seed=7, n_coupled=2)
        codes = np.where(rng.random((N, L)) < 0.2, 0, codes).astype(np.int8)
        theta, scale, kw = 0.8, 1.0, {"ignore_gaps": True}
    else:
        q, alphabet, L, N = 5, "-ACDE", 7, 16
        codes = oracle.synthetic_msa(N, L, q, seed=31, n_coupled=2)
        theta, scale, kw = 0.6, 2.5, {"scale": 2.5}
    fasta = str(tmp_path / "in.fasta")
    _write_fasta(fasta, codes, alphabet)
    lh, lj = 0.01, 0.1
    ec_file, model_file = str(tmp_path / "ECs.txt"), str(tmp_path / "m.model")
    res = run_plm(fasta, ec_file, model_file, alphabet=alphabet, theta=theta,
                  iterations=2000, lambda_h=lh, lambda_J=lj, solver="lbfgs",
                  compute_dtype="float64", steps_per_call=10,
                  conv_tol=1e-10, device="cpu", **kw)
    assert res.num_valid_seqs == N

    weights = scale / o_num_cluster_members(codes, theta)
    fit_codes = np.where(codes == 0, -1, codes) if kw.get("ignore_gaps") \
        else codes
    ref = _oracle_fit(fit_codes, weights, q, lh, lj)
    model = CouplingsModel(model_file, device="cpu")
    np.testing.assert_allclose(model.weights, weights, rtol=1e-6)
    assert model.theta == pytest.approx(theta)
    np.testing.assert_allclose(model.h_i, ref["h"], atol=H_ATOL)
    np.testing.assert_allclose(model.J_ij, ref["J"], atol=J_ATOL + 2e-7)
    if case == "plain":
        ecs = read_raw_ec_file(ec_file, sort=False)
        cn_ref = scores.apc(scores.fn_scores(ref["J"]))
        ii, jj = np.triu_indices(L, k=1)
        np.testing.assert_array_equal(
            np.argsort(-ecs.cn.values, kind="stable"),
            np.argsort(-cn_ref[ii, jj], kind="stable"))
        np.testing.assert_allclose(ecs.cn.values, cn_ref[ii, jj], atol=1e-5)


def _raises(fn, match):
    with pytest.raises(ValueError, match=match) as info:
        fn()
    return str(info.value)


def test_lbfgs_with_group_raises():
    codes = oracle.synthetic_msa(24, 6, 4, seed=17, n_coupled=2)
    kw = dict(lambda_h=0.01, lambda_J=0.05, lambda_group=12.0,
              solver="lbfgs", block_size=8)
    _raises(lambda: fit_plm(codes, np.ones(24), 4, PlmConfig(**kw),
                            device="cpu"), "fista")
    _raises(lambda: jax_plm.fit_plm(codes, np.ones(24), 4,
                                    jax_plm.PlmConfig(**kw)), "fista")


def test_asymmetric_with_exact_group_refuses(tmp_path):
    """Only the smoothed penalty on the asymmetric path: an exact one
    refuses in both packages, the explicit opt-in runs."""
    codes = oracle.synthetic_msa(16, 5, 4, seed=3, n_coupled=2)
    fasta = str(tmp_path / "a.fasta")
    _write_fasta(fasta, codes, "-ACD")
    kw = dict(alphabet="-ACD", iterations=3, lambda_g=1.0,
              parametrization="asymmetric")
    _raises(lambda: run_plm(fasta, str(tmp_path / "a_ECs.txt"), None,
                            device="cpu", **kw), "smoothed")
    _raises(lambda: jax_run_plm(fasta, str(tmp_path / "j_ECs.txt"), None,
                                **kw), "smoothed")
    run_plm(fasta, str(tmp_path / "a2_ECs.txt"), None, device="cpu",
            group_mode="smoothed", **kw)


def test_fista_with_smoothed_optin_contradiction_refuses():
    codes, weights, L, q, lh, lj = _case("small_q6")
    kw = dict(lambda_h=lh, lambda_J=lj, lambda_group=1.0, solver="fista",
              group_mode="smoothed", block_size=16)
    _raises(lambda: fit_plm(codes, weights, q, PlmConfig(**kw),
                            device="cpu"), "EXACT")
    _raises(lambda: jax_plm.fit_plm(codes, weights, q,
                                    jax_plm.PlmConfig(**kw)), "EXACT")
