"""The port's sharded fits over torch.distributed against the JAX
package's sharded fits and against the port in one process: the symmetric
fit (adam, lbfgs, fista) on meshes of 2 and 3 ranks, the balanced LBFGS
fit on one rank, the asymmetric fit on (1, 2) and (2, 2) ("data", "model")
meshes, the checkpoint guard, and the couplings `standard` stage with
fit_devices 2.

Four gloo workers on the CPU (tests/dist_fixtures.py, started once for
the module) are the ranks; the first 2 or 3 of them form a mesh, the
others stay outside it. The JAX side runs on its 8-virtual-device CPU mesh
(tests/conftest.py) while the workers run.

Tolerances (those of the JAX package's tests/test_distributed.py):
- the port's sharded fit against the port in one process: bitwise where
  the shards' sums associate like the one-process block loop (adam: one
  32-row block per rank; a third rank holds only padding rows, and x + 0
  is exact), else rtol 1e-4, atol 1e-6 (the JAX package's 3-process
  tolerance);
- against the JAX package's sharded fit: rtol 1e-4, atol 1e-6 (two float32
  implementations; measured differences up to 4.5e-8 in J, 1.8e-7 in h);
- the asymmetric fit: rtol 1e-3, atol 2e-5, as the JAX package holds its
  own. Its per-site LBFGS case runs to conv_tol 0, and at its 12th
  iteration the linesearches reach float resolution, where the two
  packages' one-process fits already differ by 2.2 times that tolerance
  (the amplification of ROADMAP C4): the port's mesh fit is held to the
  JAX package's over 10 iterations (within 0.004 of the tolerance there),
  and to the port in one process over all 12;
- every rank of a mesh returns bitwise the same parameters.
"""

import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

import dist_fixtures as df
from evcouplings_tpu.couplings import protocol as jax_couplings
from evcouplings_tpu.ops.plm import PlmConfig as JaxConfig
from evcouplings_tpu.ops.plm import fit_plm as jax_fit_plm
from evcouplings_tpu.ops.plm_sites import fit_plm_asym as jax_fit_plm_asym
from evcouplings_tpu.parallel import make_mesh as jax_make_mesh
from evcouplings_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from evcouplings_torch.align import protocol as align
from evcouplings_torch.couplings import protocol as couplings
from test_golden_regression import ATOL, RTOL, assert_exact_rank_order
from test_protocols import ALIGN_KWARGS, COUPLINGS_KWARGS, write_synthetic_a2m

WORLD = 4
SIZES = (2, 3)
# cases whose shards associate like the one-process block loop
BITWISE = {"adam"}
FIT_TOL = dict(rtol=1e-4, atol=1e-6)
ASYM_TOL = dict(rtol=1e-3, atol=2e-5)
# the asymmetric cases held to the JAX package's (see the module's
# docstring)
JAX_ASYM_CASES = ("1x2@10", "2x2")
# the stage's fit: 20 LBFGS iterations (tests/test_torch_protocols.py)
STAGE_KWARGS = {**COUPLINGS_KWARGS, "iterations": 20}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The four ranks' results; the JAX package's fits and couplings stage
    (fit_devices 2) and the port's stage in one process on the same
    inputs, computed while the ranks run."""
    out = tmp_path_factory.mktemp("torch_distributed")
    write_synthetic_a2m(str(out / "input.a2m"))
    a = align.run(protocol="existing", prefix=str(out / "align" / "job"),
                  input_alignment=str(out / "input.a2m"), device="cpu",
                  **ALIGN_KWARGS)
    stage_in = dict(alignment_file=a["alignment_file"],
                    focus_sequence=a["focus_sequence"],
                    segments=a["segments"],
                    frequencies_file=a["frequencies_file"], **STAGE_KWARGS)
    with open(out / "stage_in.pkl", "wb") as f:
        pickle.dump(dict(stage_in, device="cpu"), f)
    started = df.start_workers("distributed", WORLD, str(out))

    jax = {}
    for case in df.FIT_CASES:
        codes, w, q, kw = df.fit_case(case)
        res = jax_fit_plm(codes, w, q, JaxConfig(**kw), mesh=jax_make_mesh())
        jax["fit", case] = {"J": res.J_ij, "h": res.h_i}
    for case in JAX_ASYM_CASES:
        codes, w, q, kw, shape = df.asym_case(case)
        res = jax_fit_plm_asym(codes, w, q, JaxConfig(**kw),
                               mesh=jax_make_mesh_2d(*shape))
        jax["asym", case] = {"J": res.J_ij, "h": res.h_i}
    jax["stage"] = jax_couplings.run(
        protocol="standard", prefix=str(out / "jax" / "job"),
        fit_devices=2, **stage_in)
    one = couplings.run(protocol="standard", prefix=str(out / "one" / "job"),
                        device="cpu", **stage_in)
    return df.wait_workers(started), jax, one


def _close(got, want, **tol):
    for key in ("J", "h"):
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", df.FIT_CASES)
def test_sharded_fit_matches_one_process(run, case, n):
    """fit_plm(mesh=) on n ranks against the port's fit in one process
    (bitwise for adam, rtol 1e-4 / atol 1e-6 otherwise), with the same
    iteration count and objective trace."""
    ranks, _, _ = run
    got, one = ranks[0]["fit", case, n], ranks[0]["fit", case, 1]
    assert got["num_iter"] == one["num_iter"]
    if case in BITWISE:
        for key in ("J", "h", "fx"):
            np.testing.assert_array_equal(got[key], one[key])
    else:
        _close(got, one, **FIT_TOL)
        np.testing.assert_allclose(got["fx"], one["fx"], rtol=1e-5)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", df.FIT_CASES)
def test_sharded_fit_matches_jax(run, case, n):
    """fit_plm(mesh=) on n ranks against the JAX package's fit_plm on its
    8-device mesh: rtol 1e-4, atol 1e-6."""
    ranks, jax, _ = run
    _close(ranks[0]["fit", case, n], jax["fit", case], **FIT_TOL)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", df.FIT_CASES)
def test_ranks_return_equal_parameters(run, case, n):
    """Every rank of the mesh returns bitwise rank 0's fit."""
    ranks, _, _ = run
    want = ranks[0]["fit", case, n]
    for res in ranks[1:n]:
        for key in ("J", "h", "fx"):
            np.testing.assert_array_equal(res["fit", case, n][key],
                                          want[key])
    assert all(("fit", case, n) not in res for res in ranks[n:])


@pytest.mark.parametrize("case", df.ASYM_CASES)
def test_asym_mesh_fit_matches_one_process_and_jax(run, case):
    """fit_plm_asym on a (1, 2) mesh (per-site LBFGS, sites split over
    two ranks) and a (2, 2) mesh (Adam, rows and sites split) against the
    port in one process and (JAX_ASYM_CASES) the JAX package's fit on the
    same mesh shape: rtol 1e-3, atol 2e-5; every rank of the mesh returns
    bitwise the same fit."""
    ranks, jax, _ = run
    shape = df.asym_case(case)[-1]
    size = shape[0] * shape[1]
    got = ranks[0]["asym", case]
    _close(got, ranks[0]["asym", case, 1], **ASYM_TOL)
    if case in JAX_ASYM_CASES:
        _close(got, jax["asym", case], **ASYM_TOL)
    for res in ranks[1:size]:
        for key in ("J", "h", "fx"):
            np.testing.assert_array_equal(res["asym", case][key], got[key])


def test_balanced_mesh_fit_equals_fit_without_mesh(run):
    """fit_plm(mesh=) on one gloo rank at "high" (the balanced mode's
    precision) equals the fit without a mesh bitwise, and both equal the
    parity fit ("highest") bitwise: on the CPU the sharded path takes
    the host's sequential LBFGS dot too."""
    ranks, _, _ = run
    got = ranks[0]["balanced"]
    for want in ("one", "parity"):
        assert got["mesh"]["num_iter"] == got[want]["num_iter"]
        for key in ("J", "h", "fx"):
            np.testing.assert_array_equal(got["mesh"][key], got[want][key],
                                          err_msg=(want, key))
    assert all("balanced" not in res for res in ranks[1:])


@pytest.mark.parametrize("rank", range(WORLD))
def test_checkpoint_visible_to_one_rank_raises_everywhere(run, rank):
    """A checkpoint file only rank 0 can see (a per-rank directory, the
    stand-in for host-local disk) makes every rank raise ValueError
    instead of resuming on one and waiting forever on the others."""
    ranks, _, _ = run
    assert "requires a filesystem shared" in ranks[rank]["guard"]


def test_checkpoint_written_by_rank_0_resumes_bitwise(run):
    """On a shared file the mesh's first rank writes every snapshot (the
    other rank none), and the fit resumed from it equals the fit run
    without a break, bitwise, on both ranks."""
    ranks, _, _ = run
    assert ranks[0]["resume"]["writes"] == 3
    assert ranks[1]["resume"]["writes"] == 0
    for res in ranks[:2]:
        for key in ("J", "h"):
            np.testing.assert_array_equal(res["resume"]["resumed"][key],
                                          res["resume"]["whole"][key])


def _scores(outcfg):
    return pd.read_csv(outcfg["ec_file"]).sort_values(
        ["i", "j"]).reset_index(drop=True)


def test_stage_with_fit_devices_2(run):
    """The couplings `standard` stage with fit_devices 2 on four ranks:
    every rank returns rank 0's outcfg; its scores are within the golden
    gate (rtol 1e-4, atol 1e-5) of the port's stage in one process and of
    the JAX package's stage with fit_devices 2, in the same order."""
    ranks, jax, one = run
    got = ranks[0]["stage"]
    assert all(res["stage"] == got for res in ranks[1:])
    assert set(got) == set(one) == set(jax["stage"])
    for key, value in got.items():
        if key.endswith("_file") and value is not None:
            assert os.path.isfile(value), key
    scores = _scores(got)
    for want in (_scores(one), _scores(jax["stage"])):
        assert (scores[["i", "j"]].values == want[["i", "j"]].values).all()
        for col in ("cn", "fn"):
            np.testing.assert_allclose(scores[col], want[col], rtol=RTOL,
                                       atol=ATOL, err_msg=col)
        assert_exact_rank_order(scores, want)
