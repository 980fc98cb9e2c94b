"""
The port's complex and sharded example scripts (examples_torch/
complex_quickstart.py, scaling_quickstart.py) against the JAX package's,
as tests/test_torch_examples.py holds the others: each runs as a
subprocess from a copy on the host with its twin's assertions
(tests/test_examples.py), then both run on the same data and the printed
text, the findings and the artifacts are compared. complex_quickstart.py
fits 60 parity LBFGS iterations and scaling_quickstart.py 60 LBFGS and
300 Adam steps: both are held within DEEP_REL (ROADMAP C3).
scaling_quickstart.py starts its 8 ranks itself (gloo, one thread each);
the JAX twin fakes 8 CPU devices in one process.
"""

import os

import pandas as pd
import pytest

from examples_fixtures import (
    DEEP_REL, EXAMPLES, EXAMPLES_TORCH, check_models, check_output,
    check_tables, copy_tree, findings, models, output_dir, run_scripts,
)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("examples_complex_twins")
    return {"torch": copy_tree(EXAMPLES_TORCH, str(root / "examples_torch")),
            "jax": copy_tree(EXAMPLES, str(root / "examples"))}


def test_complex_quickstart(trees):
    out = run_scripts(trees, "complex_quickstart.py")
    assert "inter" in out["torch"].lower()
    assert ("planted inter-chain pair (A:8 <-> B:4) recovered as top hit"
            in out["torch"])
    # the pairing, the top five inter ECs and their segments exactly
    assert findings("complex_quickstart.py", out["torch"]) == findings(
        "complex_quickstart.py", out["jax"])
    check_output(out["torch"], out["jax"], trees["torch"], trees["jax"],
                 rtol=DEEP_REL, what="complex_quickstart")
    check_models(*models(trees, "complex", "demo.model"), deep=True,
                 what="complex_quickstart")
    # the concatenated alignment byte for byte
    got, want = (open(os.path.join(output_dir(trees, p, "complex"),
                                   "demo.a2m")).read()
                 for p in ("torch", "jax"))
    assert got == want
    got, want = (pd.read_csv(os.path.join(output_dir(
        trees, p, "complex"), "demo_CouplingScores.csv")) for p in ("torch",
                                                                    "jax"))
    key = ("i", "j", "segment_i", "segment_j")
    check_tables(got, want, ("fn", "cn"), rtol=DEEP_REL, atol=DEEP_REL,
                 what="demo_CouplingScores", key=key, skip=("probability",))


def test_scaling_quickstart(trees):
    out = run_scripts(trees, "scaling_quickstart.py")
    assert "data" in out["torch"]
    assert out["torch"].startswith("ranks: 8 over gloo, each on cpu")
    # the iterations and both meshes' top-4 pairs exactly as the JAX
    # package's; the losses within DEEP_REL
    got, want = (findings("scaling_quickstart.py", out[p])
                 for p in ("torch", "jax"))
    assert got == want and len(got) == 4
    torch_text = out["torch"].split("\n", 1)[1]
    jax_text = out["jax"].split("\n", 1)[1]
    check_output(torch_text, jax_text, trees["torch"], trees["jax"],
                 rtol=DEEP_REL, what="scaling_quickstart")
