"""The port's preflight memory routing of the couplings fit
(couplings/fitter.py parametrization "auto", ops/plm's
estimate_fit_hbm_bytes and device_hbm_budget) against the JAX package's,
through the cases of tests/test_auto_parametrization.py that
tests/test_torch_fitter.py (test_routing_matches_jax) and
tests/test_torch_plm.py do not hold: the estimator's shape (the
asymmetric fit is the cheaper one, the two-phase layout's resident rows
are counted, a model axis does not shrink the symmetric estimate), and
run_plm and the couplings protocol under the same EVCOUPLINGS_HBM_BYTES in
both packages: symmetric with room, the asymmetric fit past the symmetric
ceiling, the refusals of an explicit symmetric fit and of an asymmetric
fit past the budget.

The port's estimate counts its own working set (measured on the card,
chip_smoke.py --peak-memory), not the JAX package's, so each budget is
chosen where both packages' estimates give the same decision. Routing
decisions, exception types and messages are compared exactly; the two
asymmetric fits' EC scores within rtol 1e-4 (three float32 Adam steps
through each package). The JAX file's calibration anchor (a 16 GiB
device) is a figure of the JAX package's device and has no counterpart
here.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import evcouplings_tpu.couplings.fitter as jax_fitter
import evcouplings_tpu.ops.plm_sites as jax_sites
from evcouplings_tpu.couplings import protocol as jax_protocol
from evcouplings_tpu.ops import plm as jax_plm
from evcouplings_torch.couplings import fitter
from evcouplings_torch.couplings import protocol
from evcouplings_torch.ops import plm

AA = "-ACDEFGHIKLMNPQRSTVWY"
N_SEQ, L = 40, 14


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_alignment(tmp_path):
    rng = np.random.default_rng(7)
    f = tmp_path / "aln.fa"
    with open(f, "w") as fh:
        for k in range(N_SEQ):
            seq = "".join(AA[i + 1] for i in rng.integers(0, 20, L))
            fh.write(">s{}/1-{}\n{}\n".format(k, L, seq))
    return str(f)


def _estimates(module):
    sym = module.estimate_fit_hbm_bytes(
        N_SEQ, L, 21, module.PlmConfig(solver="lbfgs"), "symmetric")
    asym = module.estimate_fit_hbm_bytes(
        N_SEQ, L, 21, module.PlmConfig(solver="adam"), "asymmetric")
    return sym, asym


def _past_symmetric_budget():
    """A budget both packages' symmetric estimates miss (0.9 x budget)
    and both asymmetric estimates meet."""
    (sym, asym), (jsym, jasym) = _estimates(plm), _estimates(jax_plm)
    budget = max(asym, jasym)
    assert 0.9 * budget < min(sym, jsym)
    return budget


@pytest.mark.parametrize("module", [plm, jax_plm], ids=["torch", "jax"])
def test_estimator_shapes_and_budget(monkeypatch, module):
    sym, asym = _estimates(module)
    assert asym < sym
    monkeypatch.setenv("EVCOUPLINGS_HBM_BYTES", "12345")
    assert module.device_hbm_budget() == 12345


@pytest.mark.parametrize("module", [plm, jax_plm], ids=["torch", "jax"])
def test_estimator_counts_two_phase_working_set(module):
    n, l, q = 32768, 160, 21
    carried = module.estimate_fit_hbm_bytes(n, l, q, module.PlmConfig(
        solver="adam", dtype="bfloat16", block_size=512))
    two_phase = module.estimate_fit_hbm_bytes(n, l, q, module.PlmConfig(
        solver="adam", dtype="bfloat16", block_size=8192))
    assert two_phase - carried > n * l * q * 2


@pytest.mark.parametrize("module", [plm, jax_plm], ids=["torch", "jax"])
def test_symmetric_estimate_ignores_model_axis(module):
    cfg = module.PlmConfig(solver="lbfgs")
    base = module.estimate_fit_hbm_bytes(4096, 64, 21, cfg, "symmetric",
                                         n_data_shards=2)
    assert module.estimate_fit_hbm_bytes(
        4096, 64, 21, cfg, "symmetric", n_data_shards=4) < base
    assert module.estimate_fit_hbm_bytes(
        4096, 64, 21, cfg, "symmetric", n_data_shards=2,
        n_model_shards=4) == base


def _spy(monkeypatch, calls):
    """Record which fit each package's run_plm calls."""
    for owner, name, tag in ((fitter, "fit_plm", "symmetric"),
                             (fitter, "fit_plm_asym", "asymmetric"),
                             (jax_fitter, "fit_plm", "jax symmetric"),
                             (jax_sites, "fit_plm_asym", "jax asymmetric")):
        real = getattr(owner, name)

        def spy(*args, _real=real, _tag=tag, **kwargs):
            calls.append(_tag)
            return _real(*args, **kwargs)

        monkeypatch.setattr(owner, name, spy)


def _run_both(alignment, tmp_path, **kw):
    out = {}
    for tag, run, extra in (("torch", fitter.run_plm, {"device": "cpu"}),
                            ("jax", jax_fitter.run_plm, {})):
        ec = str(tmp_path / (tag + "_ECs.txt"))
        res = run(alignment, ec, str(tmp_path / (tag + ".model")),
                  iterations=3, **kw, **extra)
        assert res.num_valid_seqs == N_SEQ
        assert os.path.getsize(tmp_path / (tag + ".model")) > 0
        out[tag] = pd.read_csv(ec, sep=" ", header=None)
    return out


def test_auto_stays_symmetric_with_room(tiny_alignment, tmp_path,
                                        monkeypatch):
    calls = []
    _spy(monkeypatch, calls)
    monkeypatch.setenv("EVCOUPLINGS_HBM_BYTES", str(10 ** 12))
    _run_both(tiny_alignment, tmp_path)
    assert calls == ["symmetric", "jax symmetric"]


def test_auto_falls_back_to_asymmetric(tiny_alignment, tmp_path,
                                       monkeypatch):
    calls = []
    _spy(monkeypatch, calls)
    monkeypatch.setenv("EVCOUPLINGS_HBM_BYTES", str(_past_symmetric_budget()))
    ecs = _run_both(tiny_alignment, tmp_path)
    assert calls == ["asymmetric", "jax asymmetric"]
    got, want = ecs["torch"], ecs["jax"]
    assert len(got) == len(want) == L * (L - 1) // 2
    pd.testing.assert_frame_equal(got[[0, 1, 2, 3]], want[[0, 1, 2, 3]])
    np.testing.assert_allclose(got[5], want[5], rtol=1e-4, atol=1e-6)


def _per_site_budget(module):
    """A budget at which the package's router sends "auto" with solver
    lbfgs past the symmetric fit to per-site LBFGS: its per-site estimate
    (the router's configurations: block 1024 there, 512 for the
    symmetric fit), which the symmetric estimate must miss at 0.9 x."""
    asym = module.estimate_fit_hbm_bytes(N_SEQ, L, 21, module.PlmConfig(
        solver="lbfgs", block_size=1024), "asymmetric")
    sym = module.estimate_fit_hbm_bytes(N_SEQ, L, 21, module.PlmConfig(
        solver="lbfgs", block_size=512), "symmetric")
    assert 0.9 * asym < sym
    return asym


def test_auto_with_lbfgs_past_the_symmetric_ceiling(tiny_alignment, tmp_path,
                                                    monkeypatch):
    """Where the symmetric LBFGS fit misses 0.9 x the budget and the
    per-site fit meets it, both packages route "auto" with solver lbfgs
    to per-site LBFGS, and three iterations give the same ECs (scores
    within rtol 1e-4). Each package gets the budget at its own per-site
    estimate: the port's counts its own working set (ROADMAP C13), so no
    one budget lies in both packages' windows."""
    calls = []
    _spy(monkeypatch, calls)
    solvers = []
    for owner, name in ((fitter, "fit_plm_asym"),
                        (jax_sites, "fit_plm_asym")):
        spied = getattr(owner, name)

        def record(*args, _spied=spied, **kwargs):
            solvers.append(args[3].solver)
            return _spied(*args, **kwargs)
        monkeypatch.setattr(owner, name, record)
    out = {}
    for tag, run, module, extra in (
            ("torch", fitter.run_plm, plm, {"device": "cpu"}),
            ("jax", jax_fitter.run_plm, jax_plm, {})):
        monkeypatch.setenv("EVCOUPLINGS_HBM_BYTES",
                           str(_per_site_budget(module)))
        ec = str(tmp_path / (tag + "_ECs.txt"))
        run(tiny_alignment, ec, str(tmp_path / (tag + ".model")),
            iterations=3, solver="lbfgs", **extra)
        out[tag] = pd.read_csv(ec, sep=" ", header=None)
    assert calls == ["asymmetric", "jax asymmetric"]
    assert solvers == ["lbfgs", "lbfgs"]
    got, want = out["torch"], out["jax"]
    assert len(got) == len(want) == L * (L - 1) // 2
    pd.testing.assert_frame_equal(got[[0, 1, 2, 3]], want[[0, 1, 2, 3]])
    np.testing.assert_allclose(got[5], want[5], rtol=1e-4, atol=1e-6)


def _message(fn):
    with pytest.raises(MemoryError) as info:
        fn()
    return str(info.value)


def test_explicit_symmetric_raises_actionable(tiny_alignment, tmp_path,
                                              monkeypatch):
    monkeypatch.setenv("EVCOUPLINGS_HBM_BYTES", str(_past_symmetric_budget()))
    kw = dict(iterations=3, parametrization="symmetric")
    got = _message(lambda: fitter.run_plm(
        tiny_alignment, str(tmp_path / "ECs.txt"), None, device="cpu",
        **kw))
    want = _message(lambda: jax_fitter.run_plm(
        tiny_alignment, str(tmp_path / "j_ECs.txt"), None, **kw))
    for message in (got, want):
        assert "parametrization: asymmetric" in message
    assert got.split(" needs ")[0] == want.split(" needs ")[0]


def test_asymmetric_past_budget_suggests_model_shards(
        tiny_alignment, tmp_path, monkeypatch):
    monkeypatch.setenv("EVCOUPLINGS_HBM_BYTES", "1024")
    got = _message(lambda: fitter.run_plm(
        tiny_alignment, str(tmp_path / "ECs.txt"), None, iterations=3,
        device="cpu"))
    want = _message(lambda: jax_fitter.run_plm(
        tiny_alignment, str(tmp_path / "j_ECs.txt"), None, iterations=3))
    for message in (got, want):
        assert "model_shards" in message
    assert got.split(" needs ")[0] == want.split(" needs ")[0]


def test_protocol_routes_auto(tiny_alignment, tmp_path, monkeypatch):
    """The standard couplings protocol (no parametrization key) succeeds
    past the simulated symmetric ceiling through both packages, on the
    asymmetric fit."""
    calls = []
    _spy(monkeypatch, calls)
    monkeypatch.setenv("EVCOUPLINGS_HBM_BYTES", str(_past_symmetric_budget()))
    kw = dict(alignment_file=tiny_alignment, focus_mode=False,
              focus_sequence=None, theta=0.8, alphabet=None, segments=None,
              ignore_gaps=False, iterations=3, lambda_h=0.01,
              lambda_J=0.01, lambda_group=0.0, lambda_J_times_Lq=True,
              scale_clusters=None, cpu=1, reuse_ecs=False)
    out = {}
    for tag, module, extra in (("torch", protocol, {"device": "cpu"}),
                               ("jax", jax_protocol, {})):
        outcfg, ecs, _ = module.infer_plmc(
            prefix=str(tmp_path / tag / "job"), **kw, **extra)
        assert os.path.isfile(outcfg["model_file"])
        out[tag] = ecs
    assert calls == ["asymmetric", "jax asymmetric"]
    assert len(out["torch"]) == len(out["jax"]) > 0
    assert list(out["torch"].columns) == list(out["jax"].columns)


class _Routed(Exception):
    """Raised by the stand-in fits below, carrying the route taken."""


@pytest.mark.parametrize("fused_update,want", [
    ("on", "symmetric"), ("off", "asymmetric"), ("auto", "asymmetric")])
def test_router_counts_the_adam_epilogue_as_run(tiny_alignment, monkeypatch,
                                                fused_update, want):
    """The port's symmetric Adam estimate counts the fused epilogue's
    working set (fewer arrays) when the fit will run it: "on", and "auto"
    where it resolves on (a CUDA device; on the CPU it resolves off). A
    budget whose 0.9 x lies between the fused and the unfused estimates
    keeps the fused fit symmetric and sends the unfused one past it. The
    JAX package's estimate has one Adam count, so this case is the
    port's own."""
    def cfg(fused):
        return plm.PlmConfig(solver="adam", block_size=512,
                             fused_update=fused)
    fused = plm.estimate_fit_hbm_bytes(N_SEQ, L, 21, cfg("on"))
    unfused = plm.estimate_fit_hbm_bytes(N_SEQ, L, 21, cfg("off"))
    assert fused < unfused
    monkeypatch.setenv("EVCOUPLINGS_HBM_BYTES",
                       str(int((fused + unfused) / 2 / 0.9)))

    def stand_in(kind):
        def fit(*args, **kwargs):
            raise _Routed(kind)
        return fit
    monkeypatch.setattr(fitter, "fit_plm", stand_in("symmetric"))
    monkeypatch.setattr(fitter, "fit_plm_asym", stand_in("asymmetric"))
    with pytest.raises(_Routed) as routed:
        fitter.run_plm(tiny_alignment, os.devnull, None, iterations=1,
                       solver="adam", fused_update=fused_update,
                       device="cpu")
    assert routed.value.args[0] == want
