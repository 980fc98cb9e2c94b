"""Mid-fit checkpoint/resume of the port: the fingerprint string and the
snapshot keys are the JAX package's, a resumed fit equals the
uninterrupted one bit for bit, and a snapshot of either package resumes
in the other."""

import os

import numpy as np
import pytest
import torch

from evcouplings_tpu.ops import plm as jp
from evcouplings_tpu.ops import plm_sites as js
from evcouplings_torch import convert
from evcouplings_torch.ops import plm as tp
from evcouplings_torch.ops import plm_sites as ts

SOLVERS = [
    ("adam", {}),
    ("adam", {"fused_update": "on"}),
    ("lbfgs", {}),
    ("lbfgs", {"precision": "high"}),
    ("fista", {"lambda_group": 0.5}),
]


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread (the test runners share the
    host's cores, and thread pools of tiny ops then spin against each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data():
    rng = np.random.default_rng(9)
    return rng.integers(0, 5, size=(48, 6)).astype(np.int8), np.ones(48)


def _cfg(solver, extra, max_iter, dtype="float32"):
    return tp.PlmConfig(max_iter=max_iter, block_size=16, solver=solver,
                        conv_tol=0.0, dtype=dtype, **extra)


@pytest.mark.parametrize("cfg", [
    tp.PlmConfig(),
    tp.PlmConfig(solver="adam", adam_lr=1e-2, block_size=64),
    tp.PlmConfig(solver="fista", lambda_group=0.3),
    tp.PlmConfig(solver="lbfgs", lambda_group=0.3, group_mode="smoothed",
                 group_eps=1e-10),
    tp.PlmConfig(solver="adam", dtype="bfloat16", fused_update="on"),
    tp.PlmConfig(solver="adam", dtype="bfloat16", grad_layout="two_phase"),
])
def test_fingerprint_matches_jax(cfg):
    codes, w = _data()
    want = jp.fit_fingerprint(codes, w, 5, jp.PlmConfig(**cfg.__dict__))
    assert tp.fit_fingerprint(codes, w, 5, cfg) == want
    assert tp.fit_fingerprint(codes, w, 5, cfg, device="cpu") == want


def test_fingerprint_of_fused_auto_on_the_card():
    """'auto' that resolves on (an eligible Adam fit on a CUDA device)
    hashes as 'on'; where it resolves off, the literal value."""
    codes, w = _data()
    auto = tp.PlmConfig(solver="adam")
    cuda = torch.device("cuda")
    assert tp.fit_fingerprint(codes, w, 5, auto, cuda) == tp.fit_fingerprint(
        codes, w, 5, tp.PlmConfig(solver="adam", fused_update="on"))
    lbfgs = tp.PlmConfig()
    assert tp.fit_fingerprint(codes, w, 5, lbfgs, cuda) == \
        jp.fit_fingerprint(codes, w, 5, jp.PlmConfig())


@pytest.mark.parametrize("solver,extra", SOLVERS)
def test_resume_is_bitwise_identical(tmp_path, solver, extra):
    """Stop at 10 (snapshots every 5), resume to 20: parameters, final
    loss and the resumed rows equal the uninterrupted fit's."""
    codes, w = _data()
    ref = tp.fit_plm(codes, w, 5, _cfg(solver, extra, 20), device="cpu")
    ckpt = str(tmp_path / "fit.npz")
    tp.fit_plm(codes, w, 5, _cfg(solver, extra, 10), checkpoint_file=ckpt,
               checkpoint_every=5, device="cpu")
    assert int(np.load(ckpt)["iteration"]) == 10
    res = tp.fit_plm(codes, w, 5, _cfg(solver, extra, 20),
                     checkpoint_file=ckpt, checkpoint_every=5, device="cpu")
    assert res.iteration_table[0]["iter"] == 11
    assert (res.num_iter, res.converged, res.ls_failed) == (
        ref.num_iter, ref.converged, ref.ls_failed)
    np.testing.assert_array_equal(res.J_ij, ref.J_ij)
    np.testing.assert_array_equal(res.h_i, ref.h_i)
    assert res.final_loss == ref.final_loss
    assert [r["fx"] for r in res.iteration_table] == \
        [r["fx"] for r in ref.iteration_table[10:]]
    assert not os.path.exists(ckpt + ".tmp.npz")


@pytest.mark.parametrize("solver,extra", SOLVERS)
def test_snapshot_keys_match_jax(tmp_path, solver, extra):
    codes, w = _data()
    cfg = _cfg(solver, extra, 4)
    ours, theirs = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tp.fit_plm(codes, w, 5, cfg, checkpoint_file=ours, device="cpu")
    jp.fit_plm(codes, w, 5, jp.PlmConfig(**cfg.__dict__),
               checkpoint_file=theirs)
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].shape == b[k].shape, k
    assert str(a["fingerprint"]) == str(b["fingerprint"])


@pytest.mark.parametrize("solver,extra", [s for s in SOLVERS
                                          if "fused_update" not in s[1]])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_snapshot_resumes_across_packages(tmp_path, solver, extra, writer):
    """float64: a snapshot written at iteration 10 by one package resumes
    to 20 in the other within 1e-9 of that package's uninterrupted fit."""
    codes, w = _data()
    c10, c20 = (_cfg(solver, extra, n, dtype="float64") for n in (10, 20))
    ckpt = str(tmp_path / "fit.npz")
    j10, j20 = (jp.PlmConfig(**c.__dict__) for c in (c10, c20))
    if writer == "jax":
        jp.fit_plm(codes, w, 5, j10, checkpoint_file=ckpt)
        ref = jp.fit_plm(codes, w, 5, j20)
        res = tp.fit_plm(codes, w, 5, c20, checkpoint_file=ckpt,
                         device="cpu")
    else:
        tp.fit_plm(codes, w, 5, c10, checkpoint_file=ckpt, device="cpu")
        ref = tp.fit_plm(codes, w, 5, c20, device="cpu")
        res = jp.fit_plm(codes, w, 5, j20, checkpoint_file=ckpt)
    assert res.iteration_table[0]["iter"] == 11
    np.testing.assert_allclose(res.J_ij, ref.J_ij, atol=1e-9)
    np.testing.assert_allclose(res.h_i, ref.h_i, atol=1e-9)


def test_snapshot_of_another_fit_is_refused(tmp_path):
    codes, w = _data()
    ckpt = str(tmp_path / "fit.npz")
    tp.fit_plm(codes, w, 5, _cfg("adam", {}, 4), checkpoint_file=ckpt,
               device="cpu")
    with pytest.raises(ValueError, match="DIFFERENT"):
        tp.fit_plm(codes, w, 5, _cfg("adam", {"adam_lr": 1e-2}, 8),
                   checkpoint_file=ckpt, device="cpu")
    with pytest.raises(ValueError, match="problem shape"):
        tp.fit_plm(codes[:, :5], w, 5, _cfg("adam", {}, 8),
                   checkpoint_file=ckpt, device="cpu")


def test_resume_at_max_iter_reports_the_snapshot(tmp_path):
    """A resume with nothing left to run returns the snapshot's
    parameters; FISTA reports its carried nonsmooth objective."""
    codes, w = _data()
    ckpt = str(tmp_path / "fit.npz")
    cfg = _cfg("fista", {"lambda_group": 0.5}, 6)
    first = tp.fit_plm(codes, w, 5, cfg, checkpoint_file=ckpt, device="cpu")
    again = tp.fit_plm(codes, w, 5, cfg, checkpoint_file=ckpt, device="cpu")
    assert again.iteration_table == [] and again.num_iter == 6
    # the restore symmetrizes J, which FISTA's block prox leaves
    # asymmetric in the last float32 bits
    np.testing.assert_allclose(again.J_ij, first.J_ij, atol=1e-7)
    assert again.final_loss == pytest.approx(first.final_loss, rel=1e-6)


def test_parameter_only_snapshot_restarts_lbfgs(tmp_path):
    """A snapshot without solver state (written by another solver)
    resumes from its parameters with a fresh LBFGS history."""
    codes, w = _data()
    ckpt = str(tmp_path / "fit.npz")
    adam = tp.fit_plm(codes, w, 5, _cfg("adam", {}, 5),
                      checkpoint_file=ckpt, device="cpu")
    snap = dict(np.load(ckpt))
    snap.pop("fingerprint")
    np.savez(ckpt, **snap)
    res = tp.fit_plm(codes, w, 5, _cfg("lbfgs", {}, 8),
                     checkpoint_file=ckpt, device="cpu")
    assert res.iteration_table[0]["iter"] == 6
    assert res.iteration_table[-1]["fx"] < adam.final_loss


def test_convert_snapshot_round_trip(tmp_path):
    """snapshot_from_jax reads a JAX snapshot into the port's state, and
    snapshot_to_jax gives back the same arrays."""
    codes, w = _data()
    ckpt = str(tmp_path / "fit.npz")
    cfg = jp.PlmConfig(max_iter=6, block_size=16, solver="lbfgs")
    jp.fit_plm(codes, w, 5, cfg, checkpoint_file=ckpt)
    params, state, it = convert.snapshot_from_jax(ckpt, "lbfgs", 6, 5)
    assert it == 6 and isinstance(state, tuple)
    back = convert.snapshot_to_jax("lbfgs", params, state, it,
                                   str(np.load(ckpt)["fingerprint"]))
    want = np.load(ckpt)
    assert sorted(back) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


@pytest.mark.parametrize("solver", ["adam", "lbfgs"])
def test_asymmetric_resume_is_bitwise_identical(tmp_path, solver):
    codes, w = _data()
    def cfg(n):
        return tp.PlmConfig(max_iter=n, block_size=16, solver=solver,
                            conv_tol=0.0)

    ref = ts.fit_plm_asym(codes, w, 5, cfg(12), device="cpu")
    ckpt = str(tmp_path / "asym.npz")
    ts.fit_plm_asym(codes, w, 5, cfg(6), checkpoint_file=ckpt,
                    checkpoint_every=3, device="cpu")
    res = ts.fit_plm_asym(codes, w, 5, cfg(12), checkpoint_file=ckpt,
                          device="cpu")
    assert res.iteration_table[0]["iter"] == 7
    np.testing.assert_array_equal(res.J_ij, ref.J_ij)
    np.testing.assert_array_equal(res.h_i, ref.h_i)
    # the JAX package writes the same keys
    theirs = str(tmp_path / "jax.npz")
    js.fit_plm_asym(codes, w, 5, jp.PlmConfig(**cfg(6).__dict__),
                    checkpoint_file=theirs)
    assert sorted(np.load(theirs).files) == sorted(np.load(ckpt).files)
    with pytest.raises(ValueError, match="no "):
        ts.fit_plm_asym(codes, w, 5, tp.PlmConfig(
            max_iter=12, block_size=16, conv_tol=0.0,
            solver="lbfgs" if solver == "adam" else "adam"),
            checkpoint_file=_strip_fp(ckpt, tmp_path),
            device="cpu")


def _strip_fp(path, tmp_path):
    """A copy of a snapshot without its fingerprint."""
    snap = dict(np.load(path))
    snap.pop("fingerprint")
    out = str(tmp_path / "nofp.npz")
    np.savez(out, **snap)
    return out


def test_couplings_stage_snapshots_and_removes_them(tmp_path, monkeypatch):
    """checkpoint_every in the couplings stage snapshots the fit to
    <prefix>.fit_checkpoint.npz; the completed fit removes it, and a stale
    snapshot left by an earlier run is removed too."""
    from evcouplings_torch.utils import pipeline
    from evcouplings_torch.utils.system import insert_dir
    from test_torch_pipeline import _config

    written = []
    real = tp.write_snapshot

    def spy(path, arrays):
        written.append((path, int(arrays["iteration"])))
        real(path, arrays)

    monkeypatch.setattr(tp, "write_snapshot", spy)
    config = _config(tmp_path, iterations=6)
    config["couplings"]["checkpoint_every"] = 2
    pipeline.execute_wrapped(**config)
    snap = insert_dir(config["global"]["prefix"], "couplings") + \
        ".fit_checkpoint.npz"
    assert [it for _, it in written] == [2, 4, 6]
    assert {p for p, _ in written} == {snap}
    assert not os.path.exists(snap)

    # a snapshot left behind, then a run without checkpointing
    (tmp_path / "again").mkdir()
    config = _config(tmp_path / "again", iterations=2)
    snap = insert_dir(config["global"]["prefix"], "couplings") + \
        ".fit_checkpoint.npz"
    os.makedirs(os.path.dirname(snap), exist_ok=True)
    np.savez(snap, J=np.zeros(1))
    pipeline.execute_wrapped(**config)
    assert not os.path.exists(snap)


@pytest.mark.parametrize("fit", ["symmetric", "asymmetric"])
def test_resume_of_a_stopped_lbfgs_fit_runs_nothing(tmp_path, fit):
    """A snapshot of a converged (or frozen) LBFGS fit resumed with a
    higher iteration cap adds no rows and keeps the iteration count, as
    in the JAX package."""
    codes, w = _data()
    fn = tp.fit_plm if fit == "symmetric" else ts.fit_plm_asym
    ckpt = str(tmp_path / "fit.npz")

    def cfg(n):
        return tp.PlmConfig(max_iter=n, block_size=16, solver="lbfgs",
                            conv_tol=1e-2)

    first = fn(codes, w, 5, cfg(200), checkpoint_file=ckpt, device="cpu")
    assert first.converged or first.ls_failed
    again = fn(codes, w, 5, cfg(400), checkpoint_file=ckpt, device="cpu")
    assert again.iteration_table == []
    assert (again.num_iter, again.converged, again.ls_failed) == (
        first.num_iter, first.converged, first.ls_failed)
    np.testing.assert_array_equal(again.J_ij, first.J_ij)
    assert int(np.load(ckpt)["iteration"]) == first.num_iter
