"""
The port's two job configs (examples_torch/monomer_pipeline.yml,
complex_pipeline.yml) through the port's `evcouplings_torch_runcfg`
(`python -m evcouplings_torch.utils.pipeline`) on the host, from a copy
with `device: cpu` under `global:` (the committed configs have no device
key: they run on the CUDA device), against the JAX package's configs
through `evcouplings_runcfg`, both from the directory that holds their
examples directories, as the configs' relative paths assume.

- monomer: align `existing`, couplings `standard` with Adam in production
  mode (60 steps): the CouplingScores table's top 8 pairs in the same
  order, fn and cn within PRODUCTION_REL, J and h within PRODUCTION_REL
  (relative Frobenius distance);
- complex: best_hit concatenation, then couplings `complex` with LBFGS in
  balanced mode (60 iterations, "high" matmuls; on the host the port's
  products are exact float32 and its LBFGS dots the sequential chain,
  the JAX package's XLA-CPU arithmetic at any precision name): the
  concatenated alignment byte for byte, the planted inter pair first in
  both `_CouplingScores_inter.csv`, the top 8 inter and all-EC pairs in
  the same order, fn and cn within BALANCED_REL, J and h within
  BALANCED_REL.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from examples_fixtures import EXAMPLES, EXAMPLES_TORCH, REPO, model_distance

# measured on the host, port against the JAX package (the tests print
# them; pytest -s): J 1.33e-4 and h 3.8e-5 relative (production Adam); J
# 1.65e-4 and h 3.43e-4 (balanced LBFGS)
PRODUCTION_REL = 2e-3
BALANCED_REL = PRODUCTION_REL


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' configs, all four jobs at once; the run's root."""
    import yaml

    root = str(tmp_path_factory.mktemp("example_configs"))
    for src in (EXAMPLES, EXAMPLES_TORCH):
        shutil.copytree(src, os.path.join(root, os.path.basename(src)),
                        ignore=shutil.ignore_patterns("output",
                                                      "__pycache__"))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["EVCOUPLINGS_JAX_PLATFORM"] = "cpu"
    env["MPLBACKEND"] = "Agg"
    # four jobs at once on the test runner's share of the host
    env["OMP_NUM_THREADS"] = "2"
    procs = []
    for name in ("monomer_pipeline.yml", "complex_pipeline.yml"):
        path = os.path.join(root, "examples_torch", name)
        with open(path) as f:
            config = yaml.safe_load(f)
        assert "device" not in config["global"]
        config["global"]["device"] = "cpu"
        cpu_name = "cpu_" + name
        with open(os.path.join(root, "examples_torch", cpu_name), "w") as f:
            yaml.safe_dump(config, f)
        for module, cfg in (
                ("evcouplings_torch.utils.pipeline",
                 os.path.join("examples_torch", cpu_name)),
                ("evcouplings_tpu.utils.pipeline",
                 os.path.join("examples", name))):
            procs.append((cfg, subprocess.Popen(
                [sys.executable, "-m", module, cfg], cwd=root, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for cfg, proc in procs:
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, (
            "{} failed\n--- stdout ---\n{}\n--- stderr ---\n{}".format(
                cfg, stdout[-4000:], stderr[-4000:]))
    return root


def couplings(root, package, job):
    return os.path.join(root, package, "output", job, "demo", "couplings")


def read_both(root, job, name):
    return [pd.read_csv(os.path.join(couplings(root, p, job), name))
            for p in ("examples_torch", "examples")]


def models(root, job):
    from evcouplings_torch.couplings.model import CouplingsModel

    return [CouplingsModel(os.path.join(couplings(root, p, job),
                                        "demo.model"))
            for p in ("examples_torch", "examples")]


def check_scores(got, want, key, rel, top=8):
    """The top pairs in the same order; fn and cn of every pair within
    `rel` relative Frobenius distance over the table."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    cols = list(key)
    assert (got[cols].head(top).values == want[cols].head(top).values).all()
    got, want = (t.sort_values(cols).reset_index(drop=True)
                 for t in (got, want))
    assert (got[cols].values == want[cols].values).all()
    for col in ("fn", "cn"):
        dist = np.linalg.norm(got[col] - want[col]) / np.linalg.norm(
            want[col])
        assert dist <= rel, (col, dist)


def test_monomer_pipeline_config(runs):
    prefix = os.path.join(runs, "examples_torch", "output", "pipeline",
                          "demo")
    assert os.path.isfile(prefix + ".done")
    assert os.path.isfile(prefix + "_final.outcfg")
    got, want = read_both(runs, "pipeline", "demo_CouplingScores.csv")
    check_scores(got, want, ("i", "j"), PRODUCTION_REL)
    dist = model_distance(*models(runs, "pipeline"))
    print("model distance pipeline", dist)
    assert dist["f_i"] <= 1e-6 and dist["f_ij"] <= 1e-6, dist
    assert dist["J_ij"] <= PRODUCTION_REL and dist["h_i"] <= PRODUCTION_REL


def test_complex_pipeline_config(runs):
    prefix = os.path.join(runs, "examples_torch", "output",
                          "pipeline_complex", "demo")
    assert os.path.isfile(prefix + ".done")
    with open(os.path.join(prefix, "concatenate", "demo.a2m")) as a, open(
            os.path.join(runs, "examples", "output", "pipeline_complex",
                         "demo", "concatenate", "demo.a2m")) as b:
        assert a.read() == b.read()
    key = ("i", "j", "segment_i", "segment_j")
    got, want = read_both(runs, "pipeline_complex",
                          "demo_CouplingScores_inter.csv")
    for table in (got, want):
        assert (table.i.iloc[0], table.j.iloc[0]) == (8, 4)
    check_scores(got, want, key, BALANCED_REL)
    got, want = read_both(runs, "pipeline_complex", "demo_CouplingScores.csv")
    check_scores(got, want, key, BALANCED_REL)
    dist = model_distance(*models(runs, "pipeline_complex"))
    print("model distance pipeline_complex", dist)
    assert dist["f_i"] <= 1e-6 and dist["f_ij"] <= 1e-6, dist
    assert dist["J_ij"] <= BALANCED_REL and dist["h_i"] <= BALANCED_REL
