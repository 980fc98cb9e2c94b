"""The port's mean-field DCA (ops/mean_field.py, couplings/mean_field.py
and the `mean_field` couplings protocol) against the JAX package's, on the
host: every numeric function in float64 within 1e-10, MeanFieldDCA.fit on
the golden alignment within 1e-9, and mean-field .model files byte for
byte."""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from evcouplings_tpu.align.alignment import Alignment as JaxAlignment
from evcouplings_tpu.couplings import mean_field as jmf
from evcouplings_tpu.couplings import protocol as jax_protocol
from evcouplings_tpu.couplings.model import CouplingsModel as JaxModel
from evcouplings_tpu.ops import mean_field as jops
from evcouplings_torch.align.alignment import Alignment
from evcouplings_torch.convert import model_from_jax
from evcouplings_torch.couplings import mean_field as tmf
from evcouplings_torch.couplings import protocol
from evcouplings_torch.couplings.model import CouplingsModel
from evcouplings_torch.ops import mean_field as tops
from test_protocols import COUPLINGS_KWARGS, write_synthetic_a2m

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "golden", "golden.a2m")


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread (the test runners share the
    host's cores, and thread pools of tiny ops then spin against each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _freqs(L=6, q=4, seed=0):
    """Regularized frequencies of a random alignment (a valid covariance:
    f_ij the Gram matrix of weighted one-hot rows)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, q, size=(40, L))
    oh = np.eye(q)[codes].reshape(40, L * q)
    w = rng.uniform(0.5, 1.0, 40)
    f_i = (w @ oh).reshape(L, q) / w.sum()
    f_ij = ((oh * w[:, None]).T @ oh).reshape(L, q, L, q).transpose(
        0, 2, 1, 3) / w.sum()
    return (jmf.regularize_frequencies(f_i, 0.5),
            jmf.regularize_pair_frequencies(f_ij, 0.5))


def _np(t):
    return t.cpu().numpy()


@pytest.fixture(scope="module")
def fits():
    jax_model = jmf.MeanFieldDCA(JaxAlignment.from_file(
        open(GOLDEN), "fasta")).fit(theta=0.8, pseudo_count=0.5)
    model = tmf.MeanFieldDCA(Alignment.from_path(
        GOLDEN, "fasta", device="cpu")).fit(theta=0.8, pseudo_count=0.5)
    return model, jax_model


def test_regularizers_match_jax():
    rng = np.random.default_rng(1)
    f_i, f_ij = rng.uniform(size=(5, 4)), rng.uniform(size=(5, 5, 4, 4))
    np.testing.assert_array_equal(tmf.regularize_frequencies(f_i, 0.3),
                                  jmf.regularize_frequencies(f_i, 0.3))
    np.testing.assert_array_equal(
        tmf.regularize_pair_frequencies(f_ij.copy(), 0.3),
        jmf.regularize_pair_frequencies(f_ij.copy(), 0.3))


def test_covariance_inverse_and_fields_match_jax():
    f_i, f_ij = _freqs()
    L, q = f_i.shape
    C = tops.compute_covariance_matrix(f_i, f_ij, device="cpu")
    C_want = jops.compute_covariance_matrix(f_i, f_ij)
    np.testing.assert_allclose(_np(C), C_want, rtol=0, atol=1e-15)
    inv = tops.invert_covariance(C)
    np.testing.assert_allclose(_np(inv), -np.linalg.inv(C_want), rtol=1e-10)
    inv32 = tops.invert_covariance_device(C)
    assert inv32.dtype == torch.float64
    np.testing.assert_allclose(_np(inv32), np.asarray(
        jops.invert_covariance_device(C_want), dtype=np.float64), rtol=1e-4,
        atol=1e-4)
    J = tops.reshape_invC_to_4d(inv, L, q)
    J_want = jops.reshape_invC_to_4d(-np.linalg.inv(C_want), L, q)
    np.testing.assert_allclose(_np(J), J_want, rtol=1e-10)
    np.testing.assert_allclose(
        _np(tops.fields_from_couplings(J, f_i, device="cpu")),
        jops.fields_from_couplings(J_want, f_i), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("check_every", [1, 7])
def test_direct_information_matches_jax(check_every, monkeypatch):
    """Every pair's DI within 1e-10 whatever the cadence of the host's
    check for active pairs (frozen pairs are left untouched)."""
    monkeypatch.setattr(tops, "_DI_CHECK_EVERY", check_every)
    f_i, f_ij = _freqs(L=7, seed=3)
    L, q = f_i.shape
    C = jops.compute_covariance_matrix(f_i, f_ij)
    J = jops.reshape_invC_to_4d(-np.linalg.inv(C), L, q)
    before = (tops.direct_information.sweeps, tops.direct_information.syncs)
    got = tops.direct_information(J, f_i, device="cpu")
    np.testing.assert_allclose(_np(got), jops.direct_information(J, f_i),
                               rtol=1e-10, atol=1e-14)
    sweeps = tops.direct_information.sweeps - before[0]
    syncs = tops.direct_information.syncs - before[1]
    assert syncs == -(-sweeps // check_every)
    h = tops.tilde_fields(np.exp(J[0, 3]), f_i[0], f_i[3], device="cpu")
    for g, w in zip(h, jops.tilde_fields(np.exp(J[0, 3]), f_i[0], f_i[3])):
        np.testing.assert_allclose(_np(g), w, rtol=1e-10)


def test_direct_information_device_matches_jax():
    """The JAX package's device-variant name and signature: a float64
    numpy (L, L) matrix. Its JAX twin iterates in float64 under x64 here,
    so the two agree to 1e-10."""
    f_i, f_ij = _freqs(L=6, seed=4)
    L, q = f_i.shape
    C = jops.compute_covariance_matrix(f_i, f_ij)
    J = jops.reshape_invC_to_4d(-np.linalg.inv(C), L, q)
    got = tops.direct_information_device(J, f_i, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_allclose(got, jops.direct_information_device(J, f_i),
                               rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(
        tops.direct_information_device(J, f_i, epsilon=1e-2, device="cpu"),
        jops.direct_information_device(J, f_i, epsilon=1e-2),
        rtol=1e-10, atol=1e-14)


def test_direct_information_flags_nan_pairs():
    f_i, _ = _freqs(L=3)
    J = np.zeros((3, 3, 4, 4))
    J[0, 1] = J[1, 0] = np.nan
    with pytest.warns(RuntimeWarning, match="NaN"):
        tops.direct_information(J, f_i, device="cpu")


def test_fit_matches_jax_on_the_golden_alignment(fits):
    """Weights and frequencies equal; J, h and DI within 1e-9."""
    model, want = fits
    np.testing.assert_array_equal(model.weights, want.weights)
    np.testing.assert_array_equal(model.f_i, want.f_i)
    np.testing.assert_array_equal(model.f_ij, want.f_ij)
    assert model.N_eff == want.N_eff and model.L == want.L
    np.testing.assert_allclose(model.J_ij, want.J_ij, rtol=0, atol=1e-9)
    np.testing.assert_allclose(model.h_i, want.h_i, rtol=0, atol=1e-9)
    np.testing.assert_allclose(model.di_scores, want.di_scores, rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(model.cn_scores, want.cn_scores, atol=1e-9)
    ecs, want_ecs = model.ecs, want.ecs
    assert list(ecs.columns) == list(want_ecs.columns)
    np.testing.assert_allclose(ecs.di.values, want_ecs.di.values, atol=1e-9)


def test_float32_inversion_matches_jax_device_path():
    ali = Alignment.from_path(GOLDEN, "fasta", device="cpu")
    got = tmf.MeanFieldDCA(ali).fit(theta=0.8, device=True)
    want = jmf.MeanFieldDCA(JaxAlignment.from_file(
        open(GOLDEN), "fasta")).fit(theta=0.8, device=True)
    np.testing.assert_allclose(got.J_ij, want.J_ij, rtol=1e-3, atol=1e-3)


def test_raw_ec_file_equals_jax(fits, tmp_path):
    model, want = fits
    model.to_raw_ec_file(str(tmp_path / "t.txt"))
    want.to_raw_ec_file(str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()


def test_model_file_bytes_equal_jax(fits, tmp_path):
    """The same parameters (carried over by convert.model_from_jax) give
    the same plmc_v2 bytes; the file reads back as a mean-field model in
    both packages."""
    _, want = fits
    model = model_from_jax(want, device="cpu")
    assert isinstance(model, tmf.MeanFieldCouplingsModel)
    model.to_file(str(tmp_path / "t.model"))
    want.to_file(str(tmp_path / "j.model"))
    assert (tmp_path / "t.model").read_bytes() == \
        (tmp_path / "j.model").read_bytes()
    back = CouplingsModel(str(tmp_path / "t.model"), device="cpu")
    jback = JaxModel(str(tmp_path / "t.model"))
    assert isinstance(back, tmf.MeanFieldCouplingsModel)
    assert back.pseudo_count == jback.pseudo_count == 0.5
    assert back.lambda_h is None and back.num_iter is None
    np.testing.assert_array_equal(back.regularized_f_ij,
                                  jback.regularized_f_ij)
    np.testing.assert_allclose(back.di_scores, jback.di_scores, atol=1e-12)
    with pytest.raises(ValueError, match="plmc_v1"):
        model.to_file(str(tmp_path / "x.model"), file_format="plmc_v1")


def test_independent_model_matches_jax(fits):
    model, want = fits
    np.testing.assert_allclose(model.to_independent_model().h_i,
                               want.to_independent_model().h_i, atol=1e-9)
    assert not model.to_independent_model().J_ij.any()


def test_fit_refuses_a_mesh():
    ali = Alignment.from_path(GOLDEN, "fasta", device="cpu")
    # a mesh over more ranks than the run has (one process here)
    from evcouplings_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmf.MeanFieldDCA(ali).fit(mesh=make_mesh(2, device="cpu"))


@pytest.mark.parametrize("score", ["cn", "di"])
def test_protocol_matches_jax(tmp_path, score):
    """couplings protocol `mean_field` through both packages on the same
    focus alignment: the same outcfg keys and scalars, raw EC files equal
    to their printed 6 decimals, scored EC tables within 1e-6."""
    a2m = str(tmp_path / "input.a2m")
    write_synthetic_a2m(a2m)
    kw = dict(COUPLINGS_KWARGS, protocol="mean_field", alignment_file=a2m,
              focus_mode=True, focus_sequence="TARGET_SEQ", segments=None,
              pseudo_count=0.5, ec_score_type=score, frequencies_file=None,
              scoring_model="skewnormal")
    got = protocol.run(prefix=str(tmp_path / "t" / "job"), device="cpu",
                       **kw)
    want = jax_protocol.run(prefix=str(tmp_path / "j" / "job"), **kw)
    assert set(got) == set(want)
    for key in ("num_sites", "num_valid_sequences", "effective_sequences",
                "region_start"):
        assert got[key] == want[key], key
    with open(got["raw_ec_file"]) as a, open(want["raw_ec_file"]) as b:
        assert a.read() == b.read()
    ecs, want_ecs = (pd.read_csv(o["ec_file"]) for o in (got, want))
    assert list(ecs.columns) == list(want_ecs.columns)
    np.testing.assert_allclose(ecs.score.values, want_ecs.score.values,
                               atol=1e-6)
    assert isinstance(CouplingsModel(got["model_file"], device="cpu"),
                      tmf.MeanFieldCouplingsModel)


def test_protocol_refuses_non_focus_mode(tmp_path):
    from evcouplings_torch.utils.config import InvalidParameterError

    kw = dict(COUPLINGS_KWARGS, protocol="mean_field", alignment_file=GOLDEN,
              focus_mode=False, focus_sequence=None, segments=None,
              pseudo_count=0.5, ec_score_type="cn")
    with pytest.raises(InvalidParameterError, match="focus mode"):
        protocol.run(prefix=str(tmp_path / "job"), device="cpu", **kw)


def test_pipeline_matches_jax(tmp_path):
    """align `existing` -> couplings `mean_field` through both packages'
    execute_wrapped: the same final outcfg keys, raw EC files equal."""
    from evcouplings_tpu.utils import pipeline as jax_pipeline
    from evcouplings_torch.utils import pipeline
    from test_torch_pipeline import _config

    states = {}
    for tag, runtime in (("torch", pipeline), ("jax", jax_pipeline)):
        (tmp_path / tag).mkdir()
        config = _config(tmp_path / tag)
        config["couplings"] = dict(
            config["couplings"], protocol="mean_field", pseudo_count=0.5,
            ec_score_type="cn")
        states[tag] = runtime.execute_wrapped(**config)
    got, want = states["torch"], states["jax"]
    assert set(got) == set(want)
    with open(got["raw_ec_file"]) as a, open(want["raw_ec_file"]) as b:
        assert a.read() == b.read()
    assert got["effective_sequences"] == want["effective_sequences"]
