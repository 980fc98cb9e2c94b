"""
What the port's examples (examples_torch/, notebooks_torch/) print and
write, held against another run of the same examples: the JAX package's
twins (tests/test_torch_examples*.py, tests/test_torch_example_configs.py)
or the port on the host against the port on the card (chip_smoke.py,
phase 14). numpy and pandas only: chip_smoke.py imports it on a machine
without JAX.

A script's stdout is split into its text, with every decimal number
replaced by a placeholder and the run's own directory by "<root>", which
must be equal, and the decimal numbers, held to a tolerance plus one unit
in their last printed place. Integers (ranks, counts, positions,
iterations) are text, so they are held exactly.
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
EXAMPLES = os.path.join(REPO, "examples")
EXAMPLES_TORCH = os.path.join(REPO, "examples_torch")
NOTEBOOKS_TORCH = os.path.join(REPO, "notebooks_torch")

# the scripts of examples_torch/ that drive the port, in the order a
# reader meets them (generate_data.py and make_notebooks.py aside)
SCRIPTS = (
    "tutorial_alignment_analysis.py",
    "library_quickstart.py",
    "tutorial_model_parameters.py",
    "sparse_couplings_quickstart.py",
    "tutorial_distances.py",
    "complex_quickstart.py",
    "scaling_quickstart.py",
)
CONFIGS = ("monomer_pipeline.yml", "complex_pipeline.yml")
NOTEBOOKS = (
    "alignment_analysis.ipynb",
    "model_parameters_mutation_effects.ipynb",
    "distance_calculations.ipynb",
    "output_files_tutorial.ipynb",
    "running_jobs.ipynb",
    "running_jobs_complexes.ipynb",
)

# the golden gate of the repository (tests/test_golden_regression.py),
# for fits of up to 25 iterations
RTOL, ATOL = 1e-4, 1e-5
# fits at a script's own depth (60 LBFGS iterations, 300 FISTA or Adam
# steps) amplify one-ulp differences of the value+grad past the gate
# (ROADMAP C3); they are held to this relative Frobenius distance in J and
# h, and their printed numbers to this relative tolerance. The port on the
# host against the JAX package on the host measured at most 1.56e-3 in J
# and 8.8e-3 in h (the 300-iteration dense LBFGS fit of
# sparse_couplings_quickstart.py; check_models prints each distance:
# pytest -s tests/test_torch_examples*.py).
DEEP_REL = 2e-2

_DECIMAL = re.compile(r"[-+]?\d+\.\d+(?:[eE][-+]?\d+)?")

# runs of the notebooks' code cells, in order, in one namespace, from the
# notebook's directory (tests/test_notebooks.py's runner)
RUNNER = """
import json, os, sys
nb_path = os.path.abspath(sys.argv[1])
os.chdir(os.path.dirname(nb_path))
cells = json.load(open(nb_path))["cells"]
ns = {}
for i, c in enumerate(c for c in cells if c["cell_type"] == "code"):
    src = "".join(c["source"])
    try:
        exec(compile(src, "cell %d" % i, "exec"), ns)
    except Exception:
        sys.stderr.write("FAILED cell %d:\\n%s\\n" % (i, src))
        raise
"""


def split_output(text, root):
    """(text with decimals replaced by '<f>' and root by '<root>', the
    decimals as (value, unit in the last printed place))."""
    text = text.replace(os.path.realpath(root), "<root>").replace(
        root, "<root>")
    numbers = []
    for m in _DECIMAL.finditer(text):
        s = m.group(0)
        mantissa, _, exponent = s.lower().partition("e")
        unit = 10.0 ** -len(mantissa.split(".")[1])
        if exponent:
            unit *= 10.0 ** int(exponent)
        numbers.append((float(s), unit))
    return _DECIMAL.sub("<f>", text), numbers


def check_output(got, want, got_root, want_root, rtol, what="", atol=0.0):
    """got's stdout against want's: the text equal, the decimals within
    atol, rtol and one unit in their last printed place (rtol None: the
    text only). Returns the largest relative difference of a decimal."""
    got_text, got_nums = split_output(got, got_root)
    want_text, want_nums = split_output(want, want_root)
    if got_text != want_text:
        import difflib

        raise AssertionError("{}: the printed text differs\n{}".format(
            what, "\n".join(difflib.unified_diff(
                want_text.splitlines(), got_text.splitlines(),
                "want", "got", lineterm=""))))
    worst = 0.0
    if rtol is None:
        return worst
    for (g, unit), (w, _) in zip(got_nums, want_nums):
        err = abs(g - w)
        assert err <= atol + unit + rtol * abs(w), (what, g, w, rtol, atol)
        if w:
            worst = max(worst, err / abs(w))
    return worst


def findings(name, stdout):
    """The findings of one script that must be exactly equal between any
    two runs: the planted pairs it recovers and the counts it prints."""
    lines = stdout.splitlines()
    if name == "library_quickstart.py":
        top = lines.index("top ECs:")
        return [tuple(lines[top + k].split()[0:4:2]) for k in (2, 3, 4, 5)]
    if name == "sparse_couplings_quickstart.py":
        return [ln for ln in lines if "exactly-zero pair blocks" in ln
                or "pairs:" in ln]
    if name == "tutorial_distances.py":
        return [ln for ln in lines if ln.startswith("precision of the top")]
    if name == "complex_quickstart.py":
        top = lines.index("top inter-chain ECs:")
        return ([tuple(lines[top + k].split()[0:6]) for k in range(2, 7)]
                + [ln for ln in lines if ln.startswith("paired sequences")])
    if name == "scaling_quickstart.py":
        return [ln.split(", loss")[0] for ln in lines
                if "top-4" in ln or "iters" in ln]
    return []


def model_distance(got, want):
    """{array: relative Frobenius distance} of two CouplingsModel's J_ij and
    h_i; f_i and f_ij (from the alignment alone) by their largest absolute
    difference."""
    out = {}
    for attr in ("J_ij", "h_i"):
        a, b = getattr(got, attr), getattr(want, attr)
        out[attr] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    for attr in ("f_i", "f_ij"):
        out[attr] = float(np.abs(getattr(got, attr)
                                 - getattr(want, attr)).max())
    return out


def check_models(got, want, deep, what=""):
    """Two .model files of the same fit: the alignment's statistics within
    1e-6 (float32), J and h at the golden gate, or within DEEP_REL of each
    other for a fit at a script's own depth. Returns model_distance."""
    assert got.L == want.L and got.num_symbols == want.num_symbols, what
    assert list(got.index_list) == list(want.index_list), what
    assert "".join(got.target_seq) == "".join(want.target_seq), what
    dist = model_distance(got, want)
    print("model distance", what, dist)
    assert dist["f_i"] <= 1e-6 and dist["f_ij"] <= 1e-6, (what, dist)
    if deep:
        assert dist["J_ij"] <= DEEP_REL and dist["h_i"] <= DEEP_REL, (
            what, dist)
    else:
        for attr in ("J_ij", "h_i"):
            np.testing.assert_allclose(
                getattr(got, attr), getattr(want, attr), rtol=RTOL,
                atol=ATOL, err_msg="{} {}".format(what, attr))
    return dist


def check_tables(got, want, columns, rtol, atol, what="", key=None,
                 skip=()):
    """Two CSV tables (pandas frames) of the same rows: every column not in
    `columns` or `skip` equal, each of `columns` within rtol and atol.
    With `key` (columns), rows are matched by it, not by their order (an
    EC table's order is held by the golden gate's rank-order check)."""
    assert list(got.columns) == list(want.columns), what
    assert len(got) == len(want), what
    if key is not None:
        got, want = (t.sort_values(list(key)).reset_index(drop=True)
                     for t in (got, want))
    for col in got.columns:
        if col in skip:
            continue
        if col in columns:
            np.testing.assert_allclose(
                got[col].values.astype(float),
                want[col].values.astype(float), rtol=rtol, atol=atol,
                err_msg="{} {}".format(what, col))
        else:
            import pandas as pd

            pd.testing.assert_series_equal(got[col], want[col],
                                           check_exact=True, obj=what)


# running both packages' example scripts on the host (the CPU tests)

def copy_tree(src, dst):
    """A copy of an examples directory for one test run; both packages
    read the port's demo data (the same bytes as examples/data/,
    test_generate_data_reproduces_the_demo_data)."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "output", "__pycache__"))
    shutil.rmtree(os.path.join(dst, "data"))
    shutil.copytree(os.path.join(EXAMPLES_TORCH, "data"),
                    os.path.join(dst, "data"))
    return dst


def env_for(package, iters):
    env = dict(os.environ)
    # two intra-op threads: the test runners share the host's cores, and
    # each test runs two packages at once
    env["OMP_NUM_THREADS"] = "2"
    env["TUTORIAL_ITERS"] = str(iters)
    env["MPLBACKEND"] = "Agg"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if package == "torch":
        env["EVCOUPLINGS_TORCH_DEVICE"] = "cpu"
    else:
        env["EVCOUPLINGS_JAX_PLATFORM"] = "cpu"
    return env


def run_scripts(trees, name, iters=15, packages=("torch", "jax")):
    """Start the script of each package at once; {package: stdout}."""
    procs = {p: subprocess.Popen(
        [sys.executable, os.path.join(trees[p], name)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env_for(p, iters)) for p in packages}
    out = {}
    for p, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, (
            "{} ({}) failed\n--- stdout ---\n{}\n--- stderr ---\n{}".format(
                name, p, stdout[-4000:], stderr[-4000:]))
        out[p] = stdout
    return out


def output_dir(trees, package, *parts):
    return os.path.join(trees[package], "output", *parts)


def models(trees, *parts):
    """The port's and the JAX package's .model files of one script, as
    the port's CouplingsModel reads them."""
    from evcouplings_torch.couplings.model import CouplingsModel

    return [CouplingsModel(os.path.join(output_dir(trees, p, *parts)))
            for p in ("torch", "jax")]
