"""
The port's example scripts (examples_torch/) against the JAX package's
(examples/), each run as a subprocess from a copy in a temp dir, on the
host (EVCOUPLINGS_TORCH_DEVICE=cpu; EVCOUPLINGS_JAX_PLATFORM=cpu for the
twin), TUTORIAL_ITERS=15 (25 for tutorial_distances.py), MPLBACKEND=Agg.
Each port script gets its twin's assertions (tests/test_examples.py); then
both run on the same copied data and are compared (tests/
examples_fixtures.py):

- the printed text equal, with every integer (ranks, counts, positions,
  iterations) and the findings exactly equal;
- printed decimals and the .model files at the golden gate (RTOL 1e-4,
  ATOL 1e-5) for the fits at the tutorials' depth, within DEEP_REL (2e-2
  relative) for the fits at a script's own depth: 60 parity LBFGS
  iterations (library_quickstart.py), 300 FISTA and 300 LBFGS iterations
  (sparse_couplings_quickstart.py), which amplify one-ulp value+grad
  differences past the gate (ROADMAP C3);
- alignment statistics exactly, distances within 1e-9 A (at distance 0
  the JAX GEMM form's cancellation, < 1e-4, against the port's 0).

The complex and sharded scripts are in test_torch_examples_complex.py.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
from test_golden_regression import assert_exact_rank_order

from examples_fixtures import (
    ATOL, DEEP_REL, EXAMPLES, EXAMPLES_TORCH, RTOL, check_models,
    check_output, check_tables, copy_tree, findings, models, output_dir,
    run_scripts,
)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("examples_twins")
    return {"torch": copy_tree(EXAMPLES_TORCH, str(root / "examples_torch")),
            "jax": copy_tree(EXAMPLES, str(root / "examples"))}


def test_generate_data_reproduces_the_demo_data(tmp_path):
    """The port's generator writes exactly the bytes of examples/data/*
    (seed 11), which examples_torch/data/ holds too."""
    tree = str(tmp_path / "examples_torch")
    shutil.copytree(EXAMPLES_TORCH, tree,
                    ignore=shutil.ignore_patterns("output", "data"))
    subprocess.run([sys.executable, os.path.join(tree, "generate_data.py")],
                   check=True, capture_output=True, timeout=120)
    names = sorted(os.listdir(os.path.join(EXAMPLES, "data")))
    assert sorted(os.listdir(os.path.join(tree, "data"))) == names
    for name in names:
        with open(os.path.join(tree, "data", name), "rb") as f:
            got = f.read()
        for src in (EXAMPLES, EXAMPLES_TORCH):
            with open(os.path.join(src, "data", name), "rb") as f:
                assert f.read() == got, (src, name)


def test_tutorial_alignment_analysis(trees):
    out = run_scripts(trees, "tutorial_alignment_analysis.py")
    assert "alignment is of length 30 and has 400 sequences" in out["torch"]
    assert "most gapped sequence" in out["torch"]
    assert os.path.isfile(os.path.join(output_dir(
        trees, "torch", "tutorial_alignment"), "identity_heatmap.png"))
    # frequencies, conservation and identities print alike to the digit
    check_output(out["torch"], out["jax"], trees["torch"], trees["jax"],
                 rtol=0.0, what="tutorial_alignment_analysis")
    for p in ("torch", "jax"):
        with open(os.path.join(output_dir(trees, p, "tutorial_alignment"),
                               "roundtrip.fasta"), "rb") as f:
            if p == "torch":
                got = f.read()
            else:
                assert f.read() == got


def test_tutorial_model_parameters(trees):
    out = run_scripts(trees, "tutorial_model_parameters.py")
    torch_out = out["torch"]
    assert "Part 2: predict mutation effects" in torch_out
    assert "effect_prediction_epistatic" in torch_out
    assert "double mutant" in torch_out
    assert "Part 4: index mapping for complexes" in torch_out
    assert "seq(('B_1', 3))" in torch_out
    assert os.path.isfile(os.path.join(
        output_dir(trees, "torch", "tutorial_model"),
        "mutation_predictions.csv"))
    # 15 parity LBFGS iterations: the golden gate
    check_output(torch_out, out["jax"], trees["torch"], trees["jax"],
                 rtol=RTOL, what="tutorial_model_parameters")
    check_models(*models(trees, "tutorial_model", "demo.model"), deep=False,
                 what="tutorial_model_parameters")
    got, want = (pd.read_csv(os.path.join(
        output_dir(trees, p, "tutorial_model"), "mutation_predictions.csv"))
        for p in ("torch", "jax"))
    # a delta E sums L + 1 parameter differences, each within the gate
    check_tables(got, want, ("effect_prediction_epistatic",
                             "effect_prediction_independent"),
                 rtol=RTOL, atol=31 * ATOL, what="mutation_predictions")


def test_tutorial_distances(trees):
    out = run_scripts(trees, "tutorial_distances.py", iters=25)
    assert ("precision of the top-4 long-range ECs: 1.00"
            in out["torch"])
    outdir = output_dir(trees, "torch", "tutorial_distances")
    for name in ("CouplingScoresCompared.csv", "contact_map.png",
                 "demo_distance_map.csv"):
        assert os.path.isfile(os.path.join(outdir, name)), name
    assert findings("tutorial_distances.py", out["torch"]) == findings(
        "tutorial_distances.py", out["jax"])
    # 25 parity LBFGS iterations: the golden gate
    check_output(out["torch"], out["jax"], trees["torch"], trees["jax"],
                 rtol=RTOL, what="tutorial_distances")
    got, want = (pd.read_csv(os.path.join(
        output_dir(trees, p, "tutorial_distances"),
        "CouplingScoresCompared.csv")) for p in ("torch", "jax"))
    # the golden gate: scores within RTOL/ATOL, pairs whose scores differ
    # by more than that in the same order (precision follows the order).
    # The demo family has 4 planted pairs and noise: one pair of its top-30
    # ECs is a near-tie in the JAX package's own scores, exempt from the
    # order as the gate exempts near-ties below the top L
    assert_exact_rank_order(got, want, max_top_l_exempt=1)
    # (plus one unit in the 6th decimal, where the CSV rounds)
    check_tables(got, want, ("fn", "cn"), rtol=RTOL, atol=ATOL + 1e-6,
                 what="CouplingScoresCompared", key=("i", "j"),
                 skip=("dist_intra", "dist_multimer", "dist", "precision"))
    check_tables(got, want, ("dist_intra", "dist_multimer", "dist"),
                 rtol=0, atol=1e-9, what="CouplingScoresCompared",
                 key=("i", "j"), skip=("fn", "cn", "precision"))
    maps = [pd.read_csv(os.path.join(output_dir(
        trees, p, "tutorial_distances"), "demo_distance_map.csv"))
        for p in ("torch", "jax")]
    pd.testing.assert_frame_equal(*maps)
    mats = [np.load(os.path.join(output_dir(
        trees, p, "tutorial_distances"), "demo_distance_map.npy"))
        for p in ("torch", "jax")]
    # test_torch_compare.py's rule: within 1e-9 A, except at distance 0,
    # where the JAX GEMM form leaves ~sqrt(|x|^2 eps) and the port 0
    got, want = mats
    off = got > 0
    np.testing.assert_allclose(got[off], want[off], rtol=0, atol=1e-9)
    assert np.all(want[~off] < 1e-4)


def test_library_quickstart(trees):
    out = run_scripts(trees, "library_quickstart.py")
    assert "top ECs" in out["torch"]
    mono = output_dir(trees, "torch", "monomer")
    for name in ("demo.model", "single_mutants.csv", "ECs.txt",
                 "contact_map.png"):
        assert os.path.isfile(os.path.join(mono, name)), name
    # the four planted pairs are the top four ECs in both packages
    assert findings("library_quickstart.py", out["torch"]) == [
        ("4", "18"), ("7", "25"), ("11", "22"), ("2", "29")]
    assert findings("library_quickstart.py", out["jax"]) == findings(
        "library_quickstart.py", out["torch"])
    # 60 parity LBFGS iterations, the script's own depth: DEEP_REL
    check_output(out["torch"], out["jax"], trees["torch"], trees["jax"],
                 rtol=DEEP_REL, what="library_quickstart")
    check_models(*models(trees, "monomer", "demo.model"), deep=True,
                 what="library_quickstart")
    got, want = (pd.read_csv(os.path.join(output_dir(
        trees, p, "monomer"), "single_mutants.csv")) for p in ("torch",
                                                              "jax"))
    check_tables(got, want, ("prediction_epistatic", "frequency",
                             "column_conservation"),
                 rtol=DEEP_REL, atol=DEEP_REL, what="single_mutants")


def test_sparse_couplings_quickstart(trees):
    out = run_scripts(trees, "sparse_couplings_quickstart.py")
    torch_out = out["torch"]
    # exact group-L1 must actually zero pair blocks
    assert "exactly-zero pair blocks" in torch_out
    sparse_line = next(
        ln for ln in torch_out.splitlines() if "% sparse" in ln)
    assert int(sparse_line.split("(")[1].split("%")[0]) >= 50
    # the zero-block counts and the sparsity exactly as the JAX package's
    assert findings("sparse_couplings_quickstart.py", torch_out) == findings(
        "sparse_couplings_quickstart.py", out["jax"])
    # 300 FISTA and 300 LBFGS iterations: DEEP_REL
    check_output(torch_out, out["jax"], trees["torch"], trees["jax"],
                 rtol=DEEP_REL, what="sparse_couplings_quickstart")
    for tag in ("sparse", "dense"):
        got, want = models(trees, "sparse", tag + ".model")
        check_models(got, want, deep=True, what=tag)
        norms = [np.sqrt((m.J_ij ** 2).sum(axis=(2, 3))) for m in
                 (got, want)]
        assert np.array_equal(norms[0] == 0.0, norms[1] == 0.0), tag
