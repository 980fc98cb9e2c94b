"""
The port's notebooks (notebooks_torch/, the twins of notebooks/): the six
committed notebooks are exactly what examples_torch/make_notebooks.py
generates, and every code cell of each runs, in order, in one namespace
per notebook, on the host (EVCOUPLINGS_TORCH_DEVICE=cpu, TUTORIAL_ITERS=15,
MPLBACKEND=Agg), from a copy of notebooks_torch/ and examples_torch/
(tests/test_notebooks.py holds the JAX package's the same way).
"""

import os
import shutil
import subprocess
import sys

import pytest

from examples_fixtures import (
    EXAMPLES_TORCH, NOTEBOOKS, NOTEBOOKS_TORCH, REPO, RUNNER,
)


def test_notebooks_match_generator(tmp_path):
    """The committed notebooks are the generator's output, byte for byte
    (regenerate with python examples_torch/make_notebooks.py)."""
    out = str(tmp_path / "nb")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run(
        [sys.executable, os.path.join(EXAMPLES_TORCH, "make_notebooks.py"),
         out], check=True, capture_output=True, env=env, timeout=120)
    assert sorted(os.listdir(out)) == sorted(NOTEBOOKS)
    for name in NOTEBOOKS:
        with open(os.path.join(out, name), "rb") as new, open(
                os.path.join(NOTEBOOKS_TORCH, name), "rb") as old:
            assert new.read() == old.read(), (
                "{} is stale: regenerate with python "
                "examples_torch/make_notebooks.py".format(name))


def test_notebooks_carry_no_jax():
    """Neither the notebooks nor the generator name the JAX package."""
    for path in [os.path.join(NOTEBOOKS_TORCH, n) for n in NOTEBOOKS] + [
            os.path.join(EXAMPLES_TORCH, "make_notebooks.py")]:
        with open(path) as f:
            text = f.read()
        assert "evcouplings_tpu" not in text and "import jax" not in text


@pytest.fixture(scope="module")
def notebook_tree(tmp_path_factory):
    """A copy of notebooks_torch/ beside examples_torch/ (the cells find
    ../examples_torch), so the cells' outputs land in a temp tree."""
    root = tmp_path_factory.mktemp("nb_torch_run")
    shutil.copytree(EXAMPLES_TORCH, str(root / "examples_torch"),
                    ignore=shutil.ignore_patterns("output", "__pycache__"))
    shutil.copytree(NOTEBOOKS_TORCH, str(root / "notebooks_torch"))
    return str(root / "notebooks_torch")


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_executes(notebook_tree, name):
    env = dict(os.environ)
    env["EVCOUPLINGS_TORCH_DEVICE"] = "cpu"
    env["TUTORIAL_ITERS"] = "15"
    env["MPLBACKEND"] = "Agg"
    env["OMP_NUM_THREADS"] = "2"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", RUNNER, os.path.join(notebook_tree, name)],
        capture_output=True, text=True, env=env, timeout=900)
    assert proc.returncode == 0, (
        "{} failed\n--- stdout ---\n{}\n--- stderr ---\n{}".format(
            name, proc.stdout[-3000:], proc.stderr[-5000:]))
