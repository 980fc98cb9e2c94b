"""CouplingsModel of the PyTorch port: parameters carried over from the
JAX package through evcouplings_torch.convert must write byte-identical
plmc_v2 and plmc_v1 files and read back unchanged."""

import numpy as np
import pytest
import torch

from evcouplings_tpu.couplings.model import CouplingsModel as JaxModel
from evcouplings_tpu.ops.encode import flatten_J
from evcouplings_torch.convert import model_from_jax, params_from_jax
from evcouplings_torch.couplings.model import CouplingsModel

ALPHABET = "-ACDEFGHIKLMNPQRSTVWY"


def _jax_model(seed=0, L=6, q=21):
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(L, L, q, q))
    J = 0.5 * (J + J.transpose(1, 0, 3, 2))
    J[np.arange(L), np.arange(L)] = 0.0
    f_i = rng.random((L, q))
    f_i /= f_i.sum(axis=1, keepdims=True)
    f_ij = rng.random((L, L, q, q)) / q ** 2
    f_ij = 0.5 * (f_ij + f_ij.transpose(1, 0, 3, 2))
    return JaxModel.from_params(
        J_ij=J, h_i=rng.normal(size=(L, q)), f_i=f_i, f_ij=f_ij,
        alphabet=ALPHABET, target_seq="ACDEFG"[:L],
        index_list=np.arange(11, 11 + L), weights=rng.random(9),
        theta=0.8, lambda_h=0.01, lambda_J=16.15, lambda_group=0.25,
        N_valid=8, N_invalid=1, num_iter=40, N_eff=5.5)


@pytest.mark.parametrize("file_format", ["plmc_v2", "plmc_v1"])
def test_files_are_byte_identical(tmp_path, file_format):
    jm = _jax_model()
    tm = model_from_jax(jm)
    jm.to_file(str(tmp_path / "j.model"), precision="float32",
               file_format=file_format)
    tm.to_file(str(tmp_path / "t.model"), precision="float32",
               file_format=file_format)
    assert ((tmp_path / "j.model").read_bytes()
            == (tmp_path / "t.model").read_bytes())


def test_round_trip_through_files(tmp_path):
    jm = _jax_model(seed=1)
    tm = model_from_jax(jm)
    path = str(tmp_path / "m.model")
    tm.to_file(path)
    back = CouplingsModel(path)
    jback = JaxModel(path)
    for name in ("J_ij", "h_i", "f_i", "f_ij", "weights"):
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(jback, name))
    # float32 on file; f_ij's diagonal blocks are not stored
    off = ~np.eye(6, dtype=bool)
    for name in ("J_ij", "h_i", "f_i", "weights"):
        np.testing.assert_allclose(getattr(back, name), getattr(tm, name),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(back.f_ij[off], tm.f_ij[off], rtol=1e-6,
                               atol=1e-7)
    assert "".join(back.target_seq) == "".join(jm.target_seq)
    assert list(back.index_list) == list(jm.index_list)
    assert (back.L, back.num_symbols, back.num_iter) == (6, 21, 40)
    v1 = str(tmp_path / "m1.model")
    tm.to_file(v1, file_format="plmc_v1")
    back1 = CouplingsModel(v1, file_format="plmc_v1")
    np.testing.assert_array_equal(back1.J_ij, back.J_ij)
    np.testing.assert_array_equal(back1.h_i, back.h_i)


def test_scores_and_energies_match_jax():
    jm = _jax_model(seed=2)
    tm = model_from_jax(jm)
    for name in ("fn_scores", "cn_scores", "mi_scores_raw", "mi_scores_apc",
                 "single_mut_mat"):
        np.testing.assert_allclose(getattr(tm, name), getattr(jm, name),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tm.ecs.cn.values, jm.ecs.cn.values,
                               rtol=1e-12)
    seqs = ["ACDEFG", "GFEDCA"]
    np.testing.assert_allclose(tm.hamiltonians(seqs), jm.hamiltonians(seqs),
                               rtol=1e-12)
    subs = [(12, "C", "W"), (14, "E", "-")]
    np.testing.assert_allclose(tm.delta_hamiltonian(subs),
                               jm.delta_hamiltonian(subs), rtol=1e-12)
    assert tm.cn(12, 14) == pytest.approx(jm.cn(12, 14))


def test_params_from_jax_flattens_like_jax():
    jm = _jax_model(seed=3, L=4, q=5)
    p = params_from_jax(jm.J_ij, jm.h_i)
    assert p["J"].dtype == torch.float64 and p["J"].is_contiguous()
    np.testing.assert_array_equal(p["J"].numpy(),
                                  np.asarray(flatten_J(jm.J_ij)))
    np.testing.assert_array_equal(p["h"].numpy(), jm.h_i)
