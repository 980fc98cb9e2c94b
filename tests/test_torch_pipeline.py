"""The port's pipeline runtime (evcouplings_torch/utils/pipeline.py)
against the JAX package's: the same job config (stages align and
couplings) through execute_wrapped in both, then the runtime's own
behavior: flag files, the final outcfg, the runtime table, skip/reuse,
the archive, delete_outputs, the stages and protocols that are not
ported yet, and a job that names no device on a machine without a card.
Then the four-stage monomer job (align, couplings, compare, mutate)
against seeded structures (tests/compare_fixtures.py) through both
packages.

Every comparison of the runtime is of keys, file names and flags:
exactly equal. The numbers the stages produce are held to the JAX
package's in tests/test_torch_protocols.py, and the compare stage's
artifacts in tests/test_torch_compare_protocol.py: here they are held
equal where they do not depend on the fitted EC scores, and all of them
where the JAX compare stage runs on the port job's own state.
"""

import os
import shutil
import tarfile

import numpy as np
import pandas as pd
import pytest
import torch

import compare_fixtures as ss
import search_fixtures as sf
from evcouplings_tpu.utils import pipeline as jax_pipeline
from evcouplings_torch.compare import bcif
from evcouplings_torch.utils import pipeline
from evcouplings_torch.utils.config import (
    InvalidParameterError, read_config_file,
)
from evcouplings_torch.utils.system import ResourceError, insert_dir
from test_golden_regression import ATOL, RTOL
from test_pipeline import make_config
from test_torch_compare_protocol import ZERO_ATOL

ARCHIVED = ["alignment_file", "ec_file", "model_file", "frequencies_file"]


def _compare_section(tmp_path):
    """compare `standard` against three seeded structures of
    TARGET_SEQ/11-28 (one a homodimer) in a local SIFTS table; the plot
    settings select no figure."""
    structures, rows = ss.small_structure_set()
    structure_dir = tmp_path / "structures"
    structure_dir.mkdir(exist_ok=True)
    for pdb_id, cats in structures.items():
        bcif.write_bcif(str(structure_dir / (pdb_id + ".bcif")), cats)
    pd.DataFrame(rows).to_csv(tmp_path / "sifts.csv", index=False)
    return {
        "protocol": "standard", "pdb_mmtf_dir": str(structure_dir),
        "sifts_mapping_table": str(tmp_path / "sifts.csv"),
        "sifts_sequence_db": None, "by_alignment": False,
        "pdb_alignment_method": "jackhmmer", "alignment_min_overlap": 20,
        "pdb_ids": None, "max_num_hits": 25, "max_num_structures": 10,
        "use_bitscores": True, "domain_threshold": 0.1,
        "sequence_threshold": 0.1, "region": None,
        "compare_multimer": True, "distance_cutoff": 5,
        "atom_filter": None, "min_sequence_distance": 6,
        "plot_probability_cutoffs": [], "plot_lowest_count": 2,
        "plot_highest_count": 1, "plot_increase": 1,
        "boundaries": "union", "draw_secondary_structure": True,
        "scale_sizes": True,
    }


def _config(tmp_path, stages=("align", "couplings"), management=None,
            device="cpu", iterations=10):
    config = make_config(tmp_path, stages=stages, management=management)
    config["couplings"]["iterations"] = iterations
    config["compare"] = _compare_section(tmp_path)
    if device is not None:
        config["global"]["device"] = device
    return config


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    out = {}
    for tag, runtime in (("torch", pipeline), ("jax", jax_pipeline)):
        d = tmp_path_factory.mktemp("pipeline_" + tag)
        config = _config(d, management={"archive": ARCHIVED})
        out[tag] = (config, runtime.execute_wrapped(**config))
    return out


def test_final_outcfg_matches_jax(jobs):
    (config, state), (_, want) = jobs["torch"], jobs["jax"]
    assert set(state) == set(want)
    prefix = config["global"]["prefix"]
    assert read_config_file(prefix + "_final.outcfg") == state
    for key in state:
        if key.endswith("_file") and state[key] is not None:
            assert os.path.basename(state[key]) == \
                os.path.basename(want[key]), key
            assert os.path.isfile(state[key]), key


def test_flags_and_stage_configs(jobs):
    config, _ = jobs["torch"]
    prefix = config["global"]["prefix"]
    assert os.path.isfile(prefix + ".done")
    for ext in (".failed", ".bailout", ".terminated"):
        assert not os.path.exists(prefix + ext)
    for stage in ("align", "couplings"):
        stage_prefix = insert_dir(prefix, stage)
        for suffix in ("incfg", "outcfg"):
            assert os.path.isfile("{}_{}.{}".format(stage_prefix, stage,
                                                    suffix))
        assert read_config_file("{}_{}.incfg".format(
            stage_prefix, stage))["device"] == "cpu"


def test_runtime_table(jobs):
    (_, state), (_, want) = jobs["torch"], jobs["jax"]
    runtime = pd.read_csv(state["runtime_file"])
    assert list(runtime.columns) == list(pd.read_csv(
        want["runtime_file"]).columns)
    assert list(runtime.scope) == ["align", "couplings"]
    assert (runtime.seconds > 0).all()


def test_archive_matches_jax(jobs):
    names = {}
    for tag, (config, state) in jobs.items():
        prefix = config["global"]["prefix"]
        assert state["archive_file"] == prefix + ".tar.gz"
        with tarfile.open(state["archive_file"]) as bundle:
            names[tag] = sorted(os.path.basename(n)
                                for n in bundle.getnames())
    assert names["torch"] == names["jax"]
    assert len(names["torch"]) == len(ARCHIVED)


def test_skip_reuses_previous_outputs(jobs, tmp_path):
    config, first = jobs["torch"]
    again = dict(config, stages=["couplings"])
    again["couplings"] = dict(config["couplings"], reuse_ecs=True)
    state = pipeline.execute_wrapped(**again)
    assert state["alignment_file"] == first["alignment_file"]
    assert os.path.isfile(state["ec_file"])
    runtime = pd.read_csv(state["runtime_file"])
    assert list(runtime.scope) == ["couplings"]

    with pytest.raises(ResourceError):
        pipeline.execute_wrapped(**_config(tmp_path, stages=["couplings"]))
    prefix = _config(tmp_path)["global"]["prefix"]
    assert os.path.isfile(prefix + ".failed")


def test_delete_outputs(jobs, tmp_path):
    _, state = jobs["torch"]
    victim = tmp_path / "victim.txt"
    victim.write_text("x")
    outcfg = dict(state, victim_file=str(victim))
    kept = pipeline.delete_outputs(
        {"management": {"delete": ["victim_file"]}}, outcfg)
    assert not victim.exists()
    assert "victim_file" not in kept and "ec_file" in kept
    assert pipeline.delete_outputs({"management": None}, outcfg) is outcfg


def _search_config(tmp_path, stages=("align", "couplings", "compare",
                                      "mutate"), device="cpu"):
    """The sample monomer config's align section (protocol standard,
    config/sample_config_monomer.txt) with seqid_filter set, and its
    compare section's by_alignment: True, on fake jackhmmer and hhfilter
    (tests/search_fixtures.py): the uniref90 search returns the synthetic
    focus alignment, the SIFTS sequence-file search the seeded structures'
    chains (3ccc through a homolog), and hhfilter drops every 7th row."""
    config = _config(tmp_path, stages=stages, device=device)
    _, rows = ss.small_structure_set()
    files = sf.search_job_files(str(tmp_path / "search"),
                                config["align"]["input_alignment"], rows)
    config["global"].update(sequence_file=files["sequence_file"],
                            region=None, cpu=None)
    config["tools"] = {"jackhmmer": files["jackhmmer"],
                       "hhfilter": files["hhfilter"], "hmmbuild": None,
                       "hmmsearch": None, "plmc": None}
    config["databases"] = {
        "uniref90": files["uniref90"],
        "sequence_download_url": "http://invalid.example/{}.fasta",
        "sifts_mapping_table": files["sifts_mapping_table"],
        "sifts_sequence_db": files["sifts_sequence_db"]}
    config["align"] = {
        "protocol": "standard", "input_alignment": None, "first_index": 11,
        "iterations": 5, "database": "uniref90", "use_bitscores": True,
        "domain_threshold": 0.5, "sequence_threshold": 0.5,
        "checkpoints_hmm": False, "checkpoints_ali": False, "nobias": False,
        "reuse_alignment": True, "seqid_filter": 95,
        "minimum_sequence_coverage": 50, "minimum_column_coverage": 70,
        "compute_num_effective_seqs": False, "extract_annotation": True}
    compare = dict(config["compare"], by_alignment=True,
                   alignment_min_overlap=10)
    for key in ("sifts_mapping_table", "sifts_sequence_db"):
        compare.pop(key)
    config["compare"] = compare
    return config, files


# the parts of ROADMAP A19 that are ported (A19a), as edits of _config
SEARCH_EDITS = {("compare", "by_alignment", True),
                ("align", "protocol", "standard"),
                ("align", "seqid_filter", 0.9)}


@pytest.mark.parametrize("stages,edit,item", [
    (["align", "couplings", "compare"], ("compare", "by_alignment", True),
     "A19"),
    (["align"], ("align", "protocol", "standard"), "A19"),
    (["align"], ("align", "seqid_filter", 0.9), "A19"),
    (["align"], ("pipeline", None, "protein_complex"), "A19"),
    (["align"], ("management", "tracker_type", "sql"), "A19"),
])
def test_unported_parts_name_their_item(tmp_path, stages, edit, item):
    """ROADMAP A19 was split. The sequence search, the identity filter
    and compare by_alignment (A19a) are ported: with fake binaries the job
    runs, and its outcfg names their outputs. The protein_complex pipeline
    (A19c) and the sql tracker (A19d) still raise naming their item."""
    if edit in SEARCH_EDITS:
        config, files = _search_config(tmp_path, stages=stages)
        section, key, value = edit
        config[section] = dict(config[section], **{key: value})
        state = pipeline.execute_wrapped(**config)
        assert state["focus_sequence"] == "TARGET_SEQ/11-28"
        assert os.path.isfile(state["raw_alignment_file"])
        assert os.path.isfile(state["hittable_file"])
        # hhfilter's drops, then the coverage filter
        assert state["num_sequences"] <= 150 - len(files["dropped"])
        if key == "by_alignment":
            hits = pd.read_csv(state["pdb_structure_hits_file"])
            assert set(hits.pdb_id) == {"1aaa", "2bbb", "3ccc"}
            assert os.path.isfile(state["ec_compared_longrange_file"])
        return
    config = _config(tmp_path, stages=stages)
    if edit is not None:
        section, key, value = edit
        if key is None:
            config[section] = value
        else:
            config[section] = dict(config[section] or {}, **{key: value})
    with pytest.raises(NotImplementedError, match="ROADMAP " + item):
        pipeline.execute_wrapped(**config)


def test_monomer_table_keeps_every_stage():
    """All five stages, each bound to the port's protocol module (fold
    since ROADMAP A19b; its job is in tests/test_torch_fold_pipeline.py)."""
    from evcouplings_torch.align import protocol as align
    from evcouplings_torch.compare import protocol as compare
    from evcouplings_torch.couplings import protocol as couplings
    from evcouplings_torch.fold import protocol as fold
    from evcouplings_torch.mutate import protocol as mutate

    table = pipeline.PIPELINES["protein_monomer"]
    assert [stage for stage, _, _ in table] == [
        stage for stage, _, _ in jax_pipeline.PIPELINES["protein_monomer"]]
    runners = {name: run for name, run, _ in table}
    assert runners == {"align": align.run, "couplings": couplings.run,
                       "compare": compare.run, "mutate": mutate.run,
                       "fold": fold.run}
    assert runners["fold"] is fold.run


def test_invalid_settings_raise(tmp_path):
    with pytest.raises(InvalidParameterError):
        pipeline.execute_wrapped(**_config(tmp_path, stages=["nope"]))
    bad = _config(tmp_path)
    bad["management"] = {"tracker_type": "ledger"}
    with pytest.raises(InvalidParameterError):
        pipeline.execute_wrapped(**bad)


def test_no_device_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = _config(tmp_path, device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.execute_wrapped(**config)
    prefix = config["global"]["prefix"]
    assert os.path.isfile(prefix + ".failed")
    # nothing ran on the CPU: the align stage wrote no alignment
    align_prefix = insert_dir(prefix, "align")
    assert not os.path.exists(align_prefix + ".a2m")
    # a stage section's device is enough
    config["align"]["device"] = "cpu"
    config["couplings"]["device"] = "cpu"
    assert os.path.isfile(pipeline.execute_wrapped(**config)["ec_file"])


def test_trace_dir_gets_one_trace_per_stage(monkeypatch, tmp_path):
    import json

    from evcouplings_torch.utils.tracing import TRACE_DIR_ENV

    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "traces"))
    pipeline.execute_wrapped(**_config(tmp_path, stages=["align"]))
    (trace,) = os.listdir(tmp_path / "traces")
    assert trace.startswith("align_")
    with open(tmp_path / "traces" / trace) as f:
        assert json.load(f)["traceEvents"]


def test_command_line_runs_a_config_file(jobs, tmp_path):
    from click.testing import CliRunner

    from evcouplings_torch.utils.config import write_config_file

    config = _config(tmp_path, stages=["align"])
    cfg_file = str(tmp_path / "job.yml")
    write_config_file(cfg_file, config)
    result = CliRunner().invoke(pipeline.app, [cfg_file])
    assert result.exit_code == 0, result.output
    assert os.path.isfile(config["global"]["prefix"] + ".done")


COMPARE_STAGES = ["align", "couplings", "compare", "mutate"]


@pytest.fixture(scope="module")
def jobs4(tmp_path_factory):
    """[align, couplings, compare, mutate] through both packages, and the
    JAX compare stage alone on a copy of the port job's tree (so that it
    reads the port's alignment and ECs)."""
    out = {}
    for tag, runtime in (("torch", pipeline), ("jax", jax_pipeline)):
        d = tmp_path_factory.mktemp("four_stages_" + tag)
        config = _config(d, stages=COMPARE_STAGES)
        out[tag] = (config, runtime.execute_wrapped(**config))
    config, _ = out["torch"]
    src = os.path.dirname(config["global"]["prefix"])
    dst = str(tmp_path_factory.mktemp("jax_compare_on_torch_job") / "out")
    shutil.copytree(src, dst)
    again = dict(config, stages=["compare"],
                 **{"global": dict(config["global"],
                                   prefix=os.path.join(dst, "job"))})
    out["jax on torch"] = (again, jax_pipeline.execute_wrapped(**again))
    return out


def _compare_outcfg(config):
    stage_prefix = insert_dir(config["global"]["prefix"], "compare")
    return read_config_file(stage_prefix + "_compare.outcfg")


def _root(config):
    return os.path.dirname(config["global"]["prefix"])


def test_four_stage_job_keys_and_compare_outcfg_match_jax(jobs4):
    (config, state), (jax_config, want) = jobs4["torch"], jobs4["jax"]
    assert set(state) == set(want)
    got_cmp, want_cmp = _compare_outcfg(config), _compare_outcfg(jax_config)
    assert set(got_cmp) == set(want_cmp)
    assert all(state[k] == v for k, v in got_cmp.items())
    runtime = pd.read_csv(state["runtime_file"])
    assert list(runtime.scope) == COMPARE_STAGES
    assert os.path.isfile(state["mutation_matrix_file"])
    assert state["contact_map_files"] == []


@pytest.mark.parametrize("key", [
    "pdb_structure_hits_file", "pdb_structure_hits_unfiltered_file",
    "monomer_contacts_file", "multimer_contacts_file",
    "distmap_monomer_residues_file", "remapped_pdb_files",
    "renumbered_pdb_files", "distmap_monomer", "distmap_multimer"])
def test_four_stage_structure_artifacts_equal_jax(jobs4, key):
    """What does not depend on the fitted ECs is equal: hits, contacts,
    distance maps (1e-9 A), remapped and renumbered PDB files."""
    (config, _), (jax_config, _) = jobs4["torch"], jobs4["jax"]
    got, want = _compare_outcfg(config)[key], _compare_outcfg(jax_config)[key]
    if key.startswith("distmap_") and not key.endswith("_file"):
        pairs = [(got + ext, want + ext) for ext in (".csv", ".npy")]
    elif isinstance(got, dict):
        rel = {os.path.relpath(f, _root(config)): v for f, v in got.items()}
        assert rel == {os.path.relpath(f, _root(jax_config)): v
                       for f, v in want.items()}
        pairs = list(zip(sorted(got), sorted(want)))
    else:
        pairs = [(got, want)]
    assert pairs
    for g, w in pairs:
        ss.assert_same_compare_file(g, w, zero_atol=ZERO_ATOL)


def test_four_stage_compared_ecs_match_jax(jobs4):
    """The compared EC tables of the two jobs: the same pairs and
    distances (1e-9 A); the EC scores of the two fits within the golden
    gate, as in tests/test_torch_protocols.py."""
    (config, _), (jax_config, _) = jobs4["torch"], jobs4["jax"]
    for key in ("ec_compared_all_file", "ec_compared_longrange_file"):
        got, want = (pd.read_csv(_compare_outcfg(c)[key]).sort_values(
            ["i", "j"]).reset_index(drop=True) for c in (config, jax_config))
        assert list(got.columns) == list(want.columns)
        assert (got[["i", "j"]].values == want[["i", "j"]].values).all()
        for col in ("dist", "dist_intra", "dist_multimer"):
            np.testing.assert_allclose(got[col], want[col], rtol=0,
                                       atol=1e-9, err_msg=col)
        for col in ("cn", "fn"):
            np.testing.assert_allclose(got[col], want[col], rtol=RTOL,
                                       atol=ATOL, err_msg=col)


def test_jax_compare_stage_on_the_port_job_is_equal(jobs4):
    """The JAX compare stage, run by the JAX pipeline on the port job's
    align and couplings outputs, writes what the port's compare stage
    wrote: every artifact equal (Pymol script and PDB files byte for
    byte, distances within 1e-9 A)."""
    (config, _), (again, _) = jobs4["torch"], jobs4["jax on torch"]
    compared, _ = ss.assert_same_compare_artifacts(
        _compare_outcfg(config), _compare_outcfg(again), _root(config),
        _root(again), zero_atol=ZERO_ATOL)
    assert compared >= 14


def test_sample_config_search_job_from_the_command_line(tmp_path):
    """The sample monomer config's align `standard` (seqid_filter set) and
    compare by_alignment on fake binaries, [align, couplings, compare,
    mutate], through `python -m evcouplings_torch.utils.pipeline` on the
    CPU; the same config through the JAX package's pipeline. Equal: the
    final outcfg's keys, the align stage's artifacts (bytes; the
    statistics CSV without its prefix column), and the compare artifacts
    that do not depend on the fitted ECs (hits, distance maps, remapped
    and renumbered PDB files; distances within 1e-9 A)."""
    import subprocess
    import sys

    from evcouplings_torch.utils.config import write_config_file

    configs = {}
    for tag in ("torch", "jax"):
        (tmp_path / tag).mkdir()
        configs[tag], _ = _search_config(tmp_path / tag)
    cfg_file = str(tmp_path / "job.yml")
    write_config_file(cfg_file, configs["torch"])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "evcouplings_torch.utils.pipeline", cfg_file],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    prefix = configs["torch"]["global"]["prefix"]
    state = read_config_file(prefix + "_final.outcfg")
    want = jax_pipeline.execute_wrapped(**configs["jax"])
    assert set(state) == set(want)
    assert list(pd.read_csv(state["runtime_file"]).scope) == COMPARE_STAGES
    for key in ("alignment_file", "raw_focus_alignment_file",
                "identities_file", "frequencies_file", "annotation_file",
                "target_sequence_file", "sequence_file"):
        with open(state[key]) as a, open(want[key]) as b:
            assert a.read() == b.read(), key
    pd.testing.assert_frame_equal(
        pd.read_csv(state["statistics_file"]).drop(columns="prefix"),
        pd.read_csv(want["statistics_file"]).drop(columns="prefix"),
        check_exact=True)
    for name in ("_filtered.a3m", "_raw_focus_filtered.fasta"):
        got = insert_dir(prefix, "align") + name
        with open(got) as a, open(insert_dir(configs["jax"]["global"][
                "prefix"], "align") + name) as b:
            assert a.read() == b.read(), name
    roots = [_root(configs[tag]) for tag in ("torch", "jax")]
    for key in ("pdb_structure_hits_file",
                "pdb_structure_hits_unfiltered_file",
                "distmap_monomer_residues_file", "remapped_pdb_files",
                "renumbered_pdb_files", "distmap_monomer",
                "distmap_multimer"):
        got, want_files = state[key], want[key]
        if key.startswith("distmap_") and not key.endswith("_file"):
            pairs = [(got + ext, want_files + ext) for ext in (".csv", ".npy")]
        elif isinstance(got, dict):
            assert {os.path.relpath(f, roots[0]): v for f, v in got.items()} \
                == {os.path.relpath(f, roots[1]): v
                    for f, v in want_files.items()}
            pairs = list(zip(sorted(got), sorted(want_files)))
        else:
            pairs = [(got, want_files)]
        for g, w in pairs:
            ss.assert_same_compare_file(g, w, zero_atol=ZERO_ATOL)
    hits = pd.read_csv(state["pdb_structure_hits_file"])
    assert set(hits.pdb_id) == {"1aaa", "2bbb", "3ccc"}
    assert os.path.isfile(state["mutation_matrix_file"])
