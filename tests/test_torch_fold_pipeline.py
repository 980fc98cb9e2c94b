"""The port's fold stage end to end against the JAX package's: both
fake-binary protocol runs of tests/test_fold_pipeline.py (fake CNS
through the real templates; then fake PSIPRED and maxcluster clustering)
through both packages, every artifact equal; the port's non-forking
process pool; and the five-stage monomer job (align, couplings, compare,
mutate, fold) through both packages' execute_wrapped on the CPU, with the
JAX fold stage also run on a copy of the port job's tree, where every
fold artifact must be equal byte for byte.
"""

import multiprocessing
import os
import shutil

import numpy as np
import pandas as pd
import pytest

import fold_fixtures as ff
from evcouplings_tpu.fold import protocol as jax_protocol
from evcouplings_tpu.utils import pipeline as jax_pipeline
from evcouplings_torch.fold import protocol
from evcouplings_torch.utils import pipeline
from evcouplings_torch.utils.config import read_config_file
from evcouplings_torch.utils.system import insert_dir
from test_fold_pipeline import (
    FAKE_CNS, FAKE_MAXCLUSTER, FAKE_PSIPRED, L, SEQ, helix_pdb,
)
from test_golden_regression import ATOL, RTOL
from test_torch_pipeline import _config


@pytest.fixture
def fake_tools(tmp_path, monkeypatch):
    """tests/test_fold_pipeline.py's fake cns (three levels deep, copying
    $PDBSRC), runpsipred and maxcluster."""
    monkeypatch.delenv("EVCOUPLINGS_CNS_TEMPLATE_DIR", raising=False)
    bin_dir = tmp_path / "cnsroot" / "intel" / "bin"
    bin_dir.mkdir(parents=True)
    out = {}
    for name, path, text in (
            ("cns", bin_dir / "cns", FAKE_CNS),
            ("psipred", tmp_path / "runpsipred", FAKE_PSIPRED),
            ("maxcluster", tmp_path / "maxcluster", FAKE_MAXCLUSTER)):
        path.write_text(text)
        path.chmod(0o755)
        out[name] = str(path)
    pdb_src = tmp_path / "model_src.pdb"
    pdb_src.write_text(helix_pdb(L))
    monkeypatch.setenv("PDBSRC", str(pdb_src))
    return out


def _ec_file(tmp_path, seed):
    rng = np.random.default_rng(seed)
    pairs = [(i, j) for i in range(1, L + 1) for j in range(i + 6, L + 1)]
    ecs = pd.DataFrame([
        {"i": i, "A_i": SEQ[i - 1], "j": j, "A_j": SEQ[j - 1],
         "cn": rng.random(), "probability": rng.random()}
        for i, j in pairs
    ]).sort_values("cn", ascending=False)
    path = str(tmp_path / "ecs{}.csv".format(seed))
    ecs.to_csv(path, index=False)
    return path


# the two runs of tests/test_fold_pipeline.py: a secondary-structure file,
# one sub-run, aux kept; psipred, two sub-runs, clustering, aux removed
RUNS = {
    "standard": dict(
        sec_struct_method="file", filter_sec_struct_clashes=True,
        fold_lowest_count=10, fold_highest_count=10, fold_increase=5,
        cleanup=False, seed=0),
    "psipred_and_clustering": dict(
        sec_struct_method="psipred", filter_sec_struct_clashes=False,
        fold_lowest_count=8, fold_highest_count=12, fold_increase=4,
        cleanup=True, seed=1),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_fake_binary_protocol_runs_equal_jax(name, tmp_path, fake_tools):
    run = dict(RUNS[name])
    ec_file = _ec_file(tmp_path, run.pop("seed"))
    sec_struct_file = None
    if run["sec_struct_method"] == "file":
        sec_struct_file = str(tmp_path / "ss.csv")
        pd.DataFrame({"i": np.arange(1, L + 1), "A_i": list(SEQ),
                      "sec_struct_3state": ["H"] * L}).to_csv(
            sec_struct_file, index=False)
    target = str(tmp_path / "target.fa")
    with open(target, "w") as f:
        f.write(">TARGET/1-{}\n{}\n".format(L, SEQ))
    kwargs = dict(
        protocol="standard", engine="cns_dgsa", ec_file=ec_file,
        target_sequence_file=target, segments=None,
        folding_config_file=None, cut_to_alignment_region=False,
        reuse_sec_struct=False, sec_struct_file=sec_struct_file,
        min_sequence_distance=5, fold_probability_cutoffs=None,
        num_models=1, cpu=1, remapped_pdb_files=None,
        cns=fake_tools["cns"], maxcluster=(
            fake_tools["maxcluster"] if name != "standard" else None),
        psipred=(fake_tools["psipred"] if name != "standard" else None),
        **run)
    roots = {tag: str(tmp_path / tag) for tag in ("torch", "jax")}
    got = protocol.run(prefix=os.path.join(roots["torch"], "fold"),
                       **kwargs)
    want = jax_protocol.run(prefix=os.path.join(roots["jax"], "fold"),
                            **kwargs)
    assert set(got) == set(want)
    n_models = 1 if name == "standard" else 2
    assert len(got["folded_structure_files"]) == n_models
    compared = ff.assert_same_fold_artifacts(got, want, roots["torch"],
                                             roots["jax"])
    ranking = pd.read_csv(got["folding_ranking_file"])
    if name == "standard":
        # the aux directory's restraint tables, scripts and .seq file
        assert compared >= 4 + n_models + 3 + 5
    else:
        assert (ranking.cluster_size_average == 2).all()
        assert not os.path.isdir(os.path.join(roots["torch"], "aux"))


def test_the_folding_pool_is_spawned(tmp_path, fake_tools, monkeypatch):
    """The sub-runs go to a process pool whose workers are spawned, never
    forked (a forked child of a process holding a CUDA context must not
    touch it); with cpu: 2, two workers fold the two sub-runs."""
    pools = []
    real = protocol.ProcessPoolExecutor

    def spy(*args, **kwargs):
        pools.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(protocol, "ProcessPoolExecutor", spy)
    target = str(tmp_path / "target.fa")
    with open(target, "w") as f:
        f.write(">TARGET/1-{}\n{}\n".format(L, SEQ))
    out = protocol.run(
        protocol="standard", prefix=str(tmp_path / "out" / "fold"),
        engine="cns_dgsa", ec_file=_ec_file(tmp_path, 2),
        target_sequence_file=target, segments=None,
        folding_config_file=None, cut_to_alignment_region=False,
        sec_struct_method="psipred", reuse_sec_struct=False,
        sec_struct_file=None, filter_sec_struct_clashes=False,
        min_sequence_distance=5, fold_probability_cutoffs=None,
        fold_lowest_count=8, fold_highest_count=12, fold_increase=4,
        num_models=1, cpu=2, remapped_pdb_files=None, cleanup=True,
        cns=fake_tools["cns"], maxcluster=fake_tools["maxcluster"],
        psipred=fake_tools["psipred"])
    (kw,) = pools
    assert kw["max_workers"] == 2
    assert kw["mp_context"].get_start_method() == "spawn"
    assert kw["mp_context"] is multiprocessing.get_context("spawn")
    assert len(out["folded_structure_files"]) == 2


FIVE_STAGES = ["align", "couplings", "compare", "mutate", "fold"]


def _five_stage_config(tmp_path):
    """The small job of tests/test_torch_pipeline.py (the golden
    generator, N=150, L=18, compare against three seeded structures) with
    the fold stage on the fake binaries of tests/fold_fixtures.py: the
    sample config's probability cutoffs, a short count ramp, two models
    per sub-run, cpu: 2, intermediate files kept."""
    config = _config(tmp_path, stages=FIVE_STAGES)
    with open(config["align"]["input_alignment"]) as f:
        f.readline()
        target_seq = f.readline().strip()
    tools = ff.write_fold_tools(str(tmp_path / "fold_tools"), target_seq,
                                first_index=11)
    config["tools"] = dict(config["tools"], cns=tools["cns"],
                           maxcluster=tools["maxcluster"],
                           psipred=tools["runpsipred"])
    config["fold"] = ff.fold_section(num_models=2, cpu=2, cleanup=False)
    return config


@pytest.fixture(scope="module")
def jobs5(tmp_path_factory):
    """The five-stage job through both packages from scratch, and the JAX
    pipeline's fold stage alone on a copy of the port job's tree (so that
    it reads the port's ECs and structures)."""
    out = {}
    for tag, runtime in (("torch", pipeline), ("jax", jax_pipeline)):
        d = tmp_path_factory.mktemp("five_stages_" + tag)
        config = _five_stage_config(d)
        out[tag] = (config, runtime.execute_wrapped(**config))
    config, _ = out["torch"]
    src = os.path.dirname(config["global"]["prefix"])
    dst = str(tmp_path_factory.mktemp("jax_fold_on_torch_job") / "out")
    shutil.copytree(src, dst)
    again = dict(config, stages=["fold"],
                 **{"global": dict(config["global"],
                                   prefix=os.path.join(dst, "job"))})
    out["jax on torch"] = (again, jax_pipeline.execute_wrapped(**again))
    return out


def _fold_outcfg(config):
    return read_config_file(insert_dir(config["global"]["prefix"], "fold")
                            + "_fold.outcfg")


def _root(config):
    return os.path.dirname(config["global"]["prefix"])


def test_five_stage_job_runs_every_stage(jobs5):
    (config, state), (jax_config, want) = jobs5["torch"], jobs5["jax"]
    assert set(state) == set(want)
    runtime = pd.read_csv(state["runtime_file"])
    assert list(runtime.scope) == FIVE_STAGES
    got_fold, want_fold = _fold_outcfg(config), _fold_outcfg(jax_config)
    assert set(got_fold) == set(want_fold)
    assert all(state[k] == v for k, v in got_fold.items())
    assert len(state["folded_structure_files"]) >= 4
    assert state["folding_individual_comparison_files"]
    comparison = pd.read_csv(state["folding_comparison_file"])
    assert comparison.tm.notna().all()


def test_five_stage_fold_artifacts_equal_jax_on_the_port_job(jobs5):
    """The JAX fold stage on the port job's tree writes what the port's
    fold stage wrote: the clash-annotated ECs, the secondary structure and
    its .pml, every sub-run's restraint tables, CNS scripts and .seq file,
    the models, the ranking and the comparison tables, byte for byte."""
    (config, _), (again, _) = jobs5["torch"], jobs5["jax on torch"]
    compared = ff.assert_same_fold_artifacts(
        _fold_outcfg(config), _fold_outcfg(again), _root(config),
        _root(again))
    assert compared >= 20


def test_five_stage_jobs_from_scratch_agree(jobs5):
    """From scratch, what does not depend on the fitted EC values is
    equal byte for byte (the secondary structure, its .pml and the
    secondary-structure restraint tables); the clash-annotated EC tables
    hold the same pairs and flags, and their scores are within the golden
    gate."""
    (config, _), (jax_config, _) = jobs5["torch"], jobs5["jax"]
    got, want = _fold_outcfg(config), _fold_outcfg(jax_config)
    for key in ("sec_struct_file", "secondary_structure_pml_file"):
        with open(got[key]) as a, open(want[key]) as b:
            assert a.read() == b.read(), key
    a, b = ff.fold_artifacts(got), ff.fold_artifacts(want)
    ss_tables = [n for n in a if n.endswith(("_ss_distance.tbl",
                                             "_ss_angle.tbl"))]
    assert ss_tables and set(ss_tables) <= set(b)
    for name in ss_tables:
        with open(a[name]) as x, open(b[name]) as y:
            assert x.read() == y.read(), name
    ecs = [pd.read_csv(o["folding_ec_file"]).sort_values(["i", "j"])
           .reset_index(drop=True) for o in (got, want)]
    assert list(ecs[0].columns) == list(ecs[1].columns)
    assert (ecs[0][["i", "j", "ss_clash"]].values
            == ecs[1][["i", "j", "ss_clash"]].values).all()
    np.testing.assert_allclose(ecs[0].cn, ecs[1].cn, rtol=RTOL, atol=ATOL)


def test_five_stage_job_compares_against_the_seeded_structures(jobs5):
    """The fold stage's comparison reads compare's remapped structures:
    one table per remapped file, named after it."""
    _, state = jobs5["torch"]
    remapped = state["remapped_pdb_files"]
    assert remapped
    tables = state["folding_individual_comparison_files"]
    assert len(tables) == len(remapped)
    assert set(tables.values()) == set(remapped.values())
    for table, remapped_file in zip(sorted(tables), sorted(remapped)):
        assert os.path.basename(table) == os.path.splitext(
            os.path.basename(remapped_file))[0] + ".csv"
