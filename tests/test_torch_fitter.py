"""run_plm of the PyTorch port on the host against the golden parity
fixtures and against the JAX package's run_plm on the same inputs, at
the golden gate's tolerance (RTOL 1e-4, ATOL 1e-5) with exact rank
order (tests/test_golden_regression.py)."""

import os

import numpy as np
import pytest

from evcouplings_tpu.couplings.fitter import run_plm as jax_run_plm
from evcouplings_tpu.couplings.model import CouplingsModel as JaxModel
from evcouplings_tpu.couplings.pairs import read_raw_ec_file
from evcouplings_torch.couplings.fitter import run_plm
from evcouplings_torch.couplings.model import CouplingsModel
from test_golden_regression import ATOL, RTOL, assert_exact_rank_order

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "golden")

GOLDEN_KW = dict(focus_seq="TARGET_SEQ/11-28", theta=0.8, iterations=40,
                 lambda_h=0.01, lambda_J=16.15, solver="lbfgs",
                 compute_dtype="float32", matmul_precision="highest")


def _both(d, a2m, kw):
    out = {}
    for tag, fn, extra in (("torch", run_plm, {"device": "cpu"}),
                           ("jax", jax_run_plm, {})):
        ec, model = str(d / (tag + "_ECs.txt")), str(d / (tag + ".model"))
        res = fn(os.path.join(GOLDEN, a2m), ec, model, **kw, **extra)
        out[tag] = (read_raw_ec_file(ec, sort=False), model, res)
    return out


@pytest.fixture(scope="module")
def refit(tmp_path_factory):
    return _both(tmp_path_factory.mktemp("torch_golden"), "golden.a2m",
                 GOLDEN_KW)


@pytest.mark.parametrize("a2m,focus", [
    ("golden.a2m", "TARGET_SEQ/11-28"), ("golden2.a2m", "TARGET_SEQ/21-36"),
    ("golden.a2m", None),
])
def test_prepare_alignment_matches_jax(a2m, focus):
    from evcouplings_tpu.align.alignment import parse_header as jax_parse
    from evcouplings_tpu.couplings.fitter import (
        prepare_alignment as jax_prepare,
    )
    from evcouplings_torch.align.alignment import parse_header
    from evcouplings_torch.couplings.fitter import prepare_alignment

    got = prepare_alignment(os.path.join(GOLDEN, a2m), focus_seq=focus)
    want = jax_prepare(os.path.join(GOLDEN, a2m), focus_seq=focus)
    for key in ("codes", "valid_index", "target_seq", "index_list"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("focus_index", "region_start", "num_valid_seqs",
                "num_total_seqs", "num_valid_sites", "num_total_sites"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(got["alignment"].matrix,
                                  want["alignment"].matrix)
    assert list(got["alignment"].ids) == list(want["alignment"].ids)
    for header in ("seq/3-40 desc", "seq", "a/b/7-9"):
        assert parse_header(header) == jax_parse(header)


def _check_ecs(got, want):
    assert (got.i == want.i).all() and (got.j == want.j).all()
    np.testing.assert_allclose(got.cn.values, want.cn.values, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.fn.values, want.fn.values, rtol=RTOL,
                               atol=ATOL)
    assert_exact_rank_order(got, want)


def _check_models(got, want):
    assert got.L == want.L and got.num_symbols == want.num_symbols
    assert list(got.index_list) == list(want.index_list)
    assert "".join(got.target_seq) == "".join(want.target_seq)
    np.testing.assert_allclose(got.weights, want.weights, rtol=1e-6)
    np.testing.assert_allclose(got.f_i, want.f_i, rtol=1e-6)
    np.testing.assert_allclose(got.h_i, want.h_i, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.J_ij, want.J_ij, rtol=RTOL, atol=ATOL)


def test_ec_table_matches_golden(refit):
    _check_ecs(refit["torch"][0], read_raw_ec_file(
        os.path.join(GOLDEN, "golden_ECs.txt"), sort=False))


def test_model_file_matches_golden(refit):
    _check_models(CouplingsModel(refit["torch"][1]),
                  CouplingsModel(os.path.join(GOLDEN, "golden.model")))


def test_matches_jax_run_plm(refit):
    out = refit
    _check_ecs(out["torch"][0], out["jax"][0])
    _check_models(JaxModel(out["torch"][1]), JaxModel(out["jax"][1]))
    rt, rj = out["torch"][2], out["jax"][2]
    for name in ("focus_seq_index", "num_valid_seqs", "num_total_seqs",
                 "num_valid_sites", "num_total_sites", "region_start",
                 "optimization_status"):
        assert getattr(rt, name) == getattr(rj, name), name
    np.testing.assert_allclose(rt.effective_samples, rj.effective_samples,
                               rtol=1e-12)
    np.testing.assert_allclose(rt.iteration_table.fx.values,
                               rj.iteration_table.fx.values, rtol=1e-5)


def test_gappy_group_l1_fit(tmp_path):
    """The second fixture (heavy gaps, ignore_gaps, smoothed group-L1).
    Here the host's gradient product rounds a few ulps away from the JAX
    package's (its rows of -1 codes change the summation blocks), and
    the 40-iteration fit amplifies 1-ulp gradient differences to ~3e-4
    in the scores (measured by injecting 1-ulp noise). So the fit is
    held to that envelope, and its objective to 1e-5 of the JAX fit's at
    every iteration."""
    kw = dict(focus_seq="TARGET_SEQ/21-36", theta=0.8, ignore_gaps=True,
              iterations=40, lambda_h=0.01, lambda_J=12.3, lambda_g=0.25,
              solver="lbfgs", compute_dtype="float32",
              matmul_precision="highest", group_mode="smoothed")
    out = _both(tmp_path, "golden2.a2m", kw)
    got_ec, got_file, got_res = out["torch"]
    want_ec = read_raw_ec_file(os.path.join(GOLDEN, "golden2_ECs.txt"),
                               sort=False)
    got = CouplingsModel(got_file)
    want = CouplingsModel(os.path.join(GOLDEN, "golden2.model"))
    assert (got_ec.i == want_ec.i).all() and (got_ec.j == want_ec.j).all()
    np.testing.assert_allclose(got_ec.cn.values, want_ec.cn.values,
                               atol=1e-3)
    np.testing.assert_allclose(got.J_ij, want.J_ij, atol=1e-3)
    np.testing.assert_allclose(got.h_i, want.h_i, atol=1e-2)
    np.testing.assert_allclose(got.weights, want.weights, rtol=1e-6)
    np.testing.assert_allclose(got.f_i, want.f_i, rtol=1e-6)
    np.testing.assert_allclose(got.lambda_group, 0.25, rtol=1e-6)
    np.testing.assert_allclose(got_res.iteration_table.fx.values,
                               out["jax"][2].iteration_table.fx.values,
                               rtol=1e-5)


def test_site_and_row_padding_is_inert(tmp_path):
    kw = dict(GOLDEN_KW, iterations=8)
    a2m = os.path.join(GOLDEN, "golden.a2m")
    base = run_plm(a2m, str(tmp_path / "a.txt"), str(tmp_path / "a.model"),
                   device="cpu", **kw)
    pad = run_plm(a2m, str(tmp_path / "b.txt"), str(tmp_path / "b.model"),
                  device="cpu", pad_sites_to=8, pad_rows_to=64, **kw)
    jpad = jax_run_plm(a2m, str(tmp_path / "c.txt"),
                       str(tmp_path / "c.model"), pad_sites_to=8,
                       pad_rows_to=64, **kw)
    assert pad.num_valid_sites == base.num_valid_sites
    got = CouplingsModel(str(tmp_path / "b.model"))
    np.testing.assert_allclose(
        got.J_ij, CouplingsModel(str(tmp_path / "a.model")).J_ij,
        rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        got.J_ij, JaxModel(str(tmp_path / "c.model")).J_ij,
        rtol=RTOL, atol=ATOL)


def test_unported_parametrizations_raise(tmp_path, monkeypatch):
    a2m = os.path.join(GOLDEN, "golden.a2m")
    kw = dict(device="cpu", focus_seq="TARGET_SEQ/11-28")
    with pytest.raises(NotImplementedError, match="A15"):
        run_plm(a2m, str(tmp_path / "e.txt"), parametrization="asymmetric",
                **kw)
    # a fit past the memory budget: "auto" would route to the
    # asymmetric fit, an explicit "symmetric" refuses to start
    monkeypatch.setenv("EVCOUPLINGS_HBM_BYTES", "1e5")
    with pytest.raises(NotImplementedError, match="A15"):
        run_plm(a2m, str(tmp_path / "e.txt"), **kw)
    with pytest.raises(MemoryError):
        run_plm(a2m, str(tmp_path / "e.txt"), parametrization="symmetric",
                **kw)
    with pytest.raises(ValueError):
        run_plm(a2m, str(tmp_path / "e.txt"), device="cpu",
                parametrization="sideways")


def test_golden_fit_ulp_sensitivity(tmp_path, monkeypatch):
    """How far one-ulp gradient noise moves the golden fit: the reason
    the card (whose GEMMs, exp and log round differently from the host)
    is held to the golden gate over 20 iterations and to an envelope at
    40 (chip_smoke.py phase 4). Prints the drifts (pytest -s)."""
    import torch

    from evcouplings_torch.ops import plm as tp

    clean = tp.make_plm_value_and_grad
    gen = torch.Generator().manual_seed(0)

    def noisy(*args, **kw):
        vg = clean(*args, **kw)

        def vg_noisy(params, codes, weights, oh_aug=None):
            value, grads = vg(params, codes, weights, oh_aug)
            # one f32 ulp of relative noise on every gradient entry
            return value, {k: g * (1 + 6e-8 * torch.randn(
                g.shape, generator=gen, dtype=g.dtype))
                for k, g in grads.items()}
        return vg_noisy

    a2m = os.path.join(GOLDEN, "golden.a2m")
    drift = {}
    for its in (20, 40):
        fits = {}
        for tag in ("clean", "noisy"):
            monkeypatch.setattr(tp, "make_plm_value_and_grad",
                                noisy if tag == "noisy" else clean)
            path = str(tmp_path / "{}{}.model".format(tag, its))
            run_plm(a2m, str(tmp_path / "ec.txt"), path, device="cpu",
                    **dict(GOLDEN_KW, iterations=its))
            fits[tag] = CouplingsModel(path)
        a, b = fits["clean"], fits["noisy"]
        drift[its] = {k: float(np.abs(getattr(a, k) - getattr(b, k)).max())
                      for k in ("J_ij", "h_i")}
        if its == 20:
            _check_models(b, a)
    print("golden fit drift under 1-ulp gradient noise:", drift)
    assert drift[40]["J_ij"] <= 1e-3 and drift[40]["h_i"] <= 1e-2
