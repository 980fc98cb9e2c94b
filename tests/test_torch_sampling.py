"""The port's Gibbs sampler (evcouplings_torch/ops/sampling.py) on the CPU:
the cases of tests/test_sampling.py (Boltzmann exactness by enumeration,
TV < 0.03; beta = 0 uniform, atol 0.03; trajectory shape; remainder
sweeps; thin rejected), then what the port adds. Its draws come from a
torch.Generator, so they differ from the JAX package's: the same seed
must give the same draws within the port, and at beta = 1e6 (where the
draw is the argmax, every logit gap along the chain asserted above 1e-3)
the final codes must equal the JAX package's and the float64 argmax
chain's code for code."""

import numpy as np
import pytest
import torch

import sampling_fixtures as sfx
from evcouplings_tpu.ops.sampling import gibbs_sample as jax_gibbs_sample
from evcouplings_torch.ops.sampling import gibbs_sample, sample_from_model

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 0.03),
                                       (torch.bfloat16, 0.04)])
def test_matches_boltzmann_distribution(dtype, tol):
    """bfloat16 rounds h and J (relative 2^-8): its TV bound is 0.04."""
    J, h = sfx.tiny_model(0, 3, 3)
    codes, _ = gibbs_sample(J, h, n_samples=20000, n_sweeps=60, seed=1,
                            dtype=dtype, **CPU)
    assert codes.dtype == np.int8 and codes.shape == (20000, 3)
    tv = sfx.total_variation(codes, sfx.boltzmann(J, h), 3)
    assert tv < tol, tv


def test_beta_zero_is_uniform():
    rng = np.random.default_rng(1)
    L, q = 4, 4
    h = rng.normal(size=(L, q))
    codes, _ = gibbs_sample(np.zeros((L, L, q, q)), h, n_samples=8000,
                            n_sweeps=10, seed=2, beta=0.0, **CPU)
    freqs = np.stack([np.bincount(codes[:, i].astype(int), minlength=q)
                      / 8000 for i in range(L)])
    np.testing.assert_allclose(freqs, 1.0 / q, atol=0.03)


def test_trajectory_shape():
    L, q = 3, 2
    codes, traj = gibbs_sample(np.zeros((L, L, q, q)), np.zeros((L, q)),
                               n_samples=16, n_sweeps=20, thin=5, seed=0,
                               **CPU)
    assert codes.shape == (16, L)
    assert traj.shape == (4, 16, L) and traj.dtype == np.int8
    np.testing.assert_array_equal(traj[-1], codes)


def _thin_model():
    rng = np.random.default_rng(11)
    return np.zeros((5, 5, 3, 3)), rng.normal(scale=0.3, size=(5, 3))


@pytest.mark.parametrize("thin,n_keep", [(2, 2), (5, 1), (1, 5)])
def test_draws_do_not_depend_on_thin(thin, n_keep):
    """The final codes reflect all n_sweeps sweeps (remainder sweeps
    run) and equal an unthinned run's of the same seed."""
    J, h = _thin_model()
    ref, _ = gibbs_sample(J, h, n_samples=4, n_sweeps=5, seed=2, **CPU)
    codes, traj = gibbs_sample(J, h, n_samples=4, n_sweeps=5, seed=2,
                               thin=thin, **CPU)
    assert traj.shape == (n_keep, 4, 5)
    np.testing.assert_array_equal(codes, ref)


@pytest.mark.parametrize("thin", [8, 0, -1])
def test_thin_outside_its_range_rejected(thin):
    J, h = _thin_model()
    for sampler, extra in ((gibbs_sample, CPU), (jax_gibbs_sample, {})):
        with pytest.raises(ValueError, match="thin"):
            sampler(J, h, n_samples=4, n_sweeps=3, seed=0, thin=thin,
                    **extra)


def test_same_seed_same_draws():
    J, h = sfx.tiny_model(4, 6, 5)
    a, ta = gibbs_sample(J, h, 64, 7, seed=9, thin=3, **CPU)
    b, tb = gibbs_sample(J, h, 64, 7, seed=9, thin=3, **CPU)
    gen = torch.Generator().manual_seed(9)
    c, _ = gibbs_sample(J, h, 64, 7, key=gen, **CPU)
    d, _ = gibbs_sample(J, h, 64, 7, seed=10, **CPU)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ta, tb)
    np.testing.assert_array_equal(a, c)
    assert not np.array_equal(a, d)


def test_zero_temperature_equals_jax():
    """beta = 1e6 from the same init_codes: the port, the JAX package and
    the float64 argmax chain agree code for code. The model's smallest
    logit gap along the chain is asserted above 1e-3, so that
    beta * gap (>= 1000) dwarfs the Gumbel noise (< 21)."""
    J, h = sfx.tiny_model(21, 7, 5, h_scale=1.0, J_scale=0.5)
    init = np.random.default_rng(22).integers(0, 5, (256, 7))
    want, gap = sfx.argmax_chain(J, h, init, 4)
    assert gap > 1e-3, gap
    got, _ = gibbs_sample(J, h, 256, 4, init_codes=init, beta=1e6, seed=5,
                          **CPU)
    jax_codes, _ = jax_gibbs_sample(J, h, 256, 4, init_codes=init,
                                    beta=1e6, seed=6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jax_codes, want)


def test_init_codes_default_is_uniform():
    L, q = 8, 4
    codes, _ = gibbs_sample(np.zeros((L, L, q, q)), np.zeros((L, q)),
                            n_samples=4000, n_sweeps=0, seed=3, **CPU)
    freqs = np.bincount(codes.ravel().astype(int), minlength=q) / codes.size
    np.testing.assert_allclose(freqs, 1.0 / q, atol=0.02)


def test_sample_from_model_strings_over_the_alphabet():
    import os

    from evcouplings_torch.couplings.model import CouplingsModel

    model = CouplingsModel(os.path.join(
        os.path.dirname(__file__), "data", "golden", "golden.model"))
    seqs = sample_from_model(model, 12, n_sweeps=3, seed=4, **CPU)
    assert len(seqs) == 12
    alphabet = set(model.alphabet)
    assert all(len(s) == model.L and set(s) <= alphabet for s in seqs)
    assert seqs == sample_from_model(model, 12, n_sweeps=3, seed=4, **CPU)


def test_no_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gibbs_sample(np.zeros((2, 2, 2, 2)), np.zeros((2, 2)), 4, 1)


@pytest.mark.slow
def test_sample_then_refit_recovers_planted_couplings():
    """tests/test_sampling.py's round trip through the port."""
    from evcouplings_torch.ops.gauge import zero_sum_gauge
    from evcouplings_torch.ops.plm import PlmConfig, fit_plm
    from evcouplings_torch.ops.scores import apc, fn_scores

    rng = np.random.default_rng(7)
    L, q = 10, 4
    h = rng.normal(scale=0.2, size=(L, q))
    J = np.zeros((L, L, q, q))
    planted = [(1, 6), (3, 8), (0, 9)]
    for i, j in planted:
        block = rng.normal(scale=1.2, size=(q, q))
        J[i, j] = block
        J[j, i] = block.T
    codes, _ = gibbs_sample(J, h, n_samples=6000, n_sweeps=80, seed=3, **CPU)
    fit = fit_plm(codes, np.ones(len(codes)), q,
                  PlmConfig(max_iter=80, block_size=2048, solver="lbfgs",
                            lambda_h=0.01, lambda_J=1.0), device="cpu")
    cn = apc(fn_scores(zero_sum_gauge(fit.J_ij)))
    iu = np.triu_indices(L, k=1)
    order = np.argsort(cn[iu])[::-1]
    top = {(int(iu[0][k]), int(iu[1][k])) for k in order[:len(planted)]}
    assert top == set(planted), (top, planted)
