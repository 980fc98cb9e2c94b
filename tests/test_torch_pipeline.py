"""The port's pipeline runtime (evcouplings_torch/utils/pipeline.py)
against the JAX package's: the same job config (stages align and
couplings) through execute_wrapped in both, then the runtime's own
behavior: flag files, the final outcfg, the runtime table, skip/reuse,
the archive, delete_outputs, the stages and protocols that are not
ported yet, and a job that names no device on a machine without a card.

Every comparison here is of keys, file names and flags: exactly equal.
The numbers the stages produce are held to the JAX package's in
tests/test_torch_protocols.py.
"""

import os
import tarfile

import pandas as pd
import pytest
import torch

from evcouplings_tpu.utils import pipeline as jax_pipeline
from evcouplings_torch.utils import pipeline
from evcouplings_torch.utils.config import (
    InvalidParameterError, read_config_file,
)
from evcouplings_torch.utils.system import ResourceError, insert_dir
from test_pipeline import make_config

ARCHIVED = ["alignment_file", "ec_file", "model_file", "frequencies_file"]


def _config(tmp_path, stages=("align", "couplings"), management=None,
            device="cpu", iterations=10):
    config = make_config(tmp_path, stages=stages, management=management)
    config["couplings"]["iterations"] = iterations
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


@pytest.mark.parametrize("stages,edit,item", [
    (["align", "couplings", "compare"], None, "A14"),
    (["align"], ("align", "protocol", "standard"), "A19"),
    (["align"], ("align", "seqid_filter", 0.9), "A19"),
    (["align"], ("pipeline", None, "protein_complex"), "A19"),
    (["align"], ("management", "tracker_type", "sql"), "A19"),
])
def test_unported_parts_name_their_item(tmp_path, stages, edit, item):
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
    table = pipeline.PIPELINES["protein_monomer"]
    assert [stage for stage, _, _ in table] == [
        stage for stage, _, _ in jax_pipeline.PIPELINES["protein_monomer"]]
    for stage, item in (("compare", "A14"), ("fold", "A19")):
        runner = dict((name, run) for name, run, _ in table)[stage]
        with pytest.raises(NotImplementedError, match="ROADMAP " + item):
            runner(prefix="unused")


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
