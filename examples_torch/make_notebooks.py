"""
Generate the Jupyter notebooks in notebooks_torch/ for the PyTorch port
(evcouplings_torch) — the counterpart of the reference's notebooks/*.ipynb
walkthrough set (reference
notebooks/alignment_analysis.ipynb, model_parameters_mutation_effects
.ipynb, distance_calculations.ipynb, output_files_tutorial.ipynb,
running_jobs.ipynb, running_jobs_complexes.ipynb).

Three notebooks are CONVERTED from the executable tutorial scripts in
examples_torch/ (single source of truth: the scripts, which run in CI);
the other three are authored here as cell lists. Every generated
notebook's code cells execute end to end in CI
(tests/test_torch_notebooks.py), which is more than the reference does
for its notebooks. Their numeric work runs on the CUDA device, or on the
host when EVCOUPLINGS_TORCH_DEVICE=cpu is set for the kernel.

    python examples_torch/make_notebooks.py [output_dir]
"""

import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

# runtime preamble injected into every notebook: resolve the bundled
# examples_torch/ directory whether the kernel runs in notebooks_torch/ or
# at the repository root
LOCATE_EXAMPLES = '''\
import os

# locate the bundled examples_torch/ directory (works from
# notebooks_torch/ or from the repository root)
_candidates = [p for p in ("examples_torch",
                           os.path.join("..", "examples_torch"))
               if os.path.isdir(os.path.join(p, "data"))]
EXAMPLES = os.path.abspath(_candidates[0])
HERE = EXAMPLES
DATA = os.path.join(EXAMPLES, "data")\
'''


def md_cell(text):
    return {
        "cell_type": "markdown",
        "metadata": {},
        "source": text.splitlines(keepends=True),
    }


def code_cell(text):
    return {
        "cell_type": "code",
        "execution_count": None,
        "metadata": {},
        "outputs": [],
        "source": text.splitlines(keepends=True),
    }


def notebook(cells):
    return {
        "cells": cells,
        "metadata": {
            "kernelspec": {
                "display_name": "Python 3",
                "language": "python",
                "name": "python3",
            },
            "language_info": {"name": "python", "version": "3"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def _strip_usage(doc):
    """Drop the indented CLI-usage block at the end of a tutorial
    docstring (notebooks are not run that way)."""
    lines = doc.rstrip().splitlines()
    while lines and (not lines[-1].strip()
                     or lines[-1].startswith("    ")):
        lines.pop()
    return "\n".join(lines).strip()


def convert_tutorial(script_name, title):
    """Convert an examples_torch/tutorial_*.py script into notebook cells.

    Layout contract of the tutorial scripts: module docstring; top-level
    imports/constants/helpers; a `section(title)` helper; `main(out=None)`
    whose body is divided by `section("...")` calls; an
    `if __name__ == "__main__"` tail. See tutorial_alignment_analysis.py.
    """
    path = os.path.join(HERE, script_name)
    with open(path) as f:
        src = f.read()

    m = re.match(r'\s*"""(.*?)"""\s*\n', src, re.S)
    doc, rest = m.group(1), src[m.end():]

    cells = [md_cell("# {}\n\n{}\n\n*Generated from "
                     "`examples_torch/{}` by "
                     "`examples_torch/make_notebooks.py`; "
                     "the script is the executable source of "
                     "truth.*".format(title, _strip_usage(doc),
                                      script_name))]

    # preamble: top-level code up to `def section`, plus any helper
    # functions between section() and main(); rewrite the
    # __file__-based path setup for kernel execution
    pre, _, tail = rest.partition("def section(title):")
    helper_src = tail.partition("\n\n\n")[2]
    helpers, _, tail = helper_src.partition("def main(")
    pre = pre.replace(
        'HERE = os.path.dirname(os.path.abspath(__file__))\n'
        'DATA = os.path.join(HERE, "data")',
        LOCATE_EXAMPLES,
    )
    pre = pre.replace("import os\nimport sys\n", "")
    preamble = (pre.strip() + "\n\n\n" + helpers.strip()).strip()
    cells.append(code_cell(preamble))

    # body of main(): dedent, rewrite the `out` default, split into a
    # cell per section("...") marker
    body = tail.partition(":\n")[2]
    body = body.partition('\nif __name__ ==')[0]
    lines = []
    for line in body.splitlines():
        if line.startswith("    "):
            line = line[4:]
        if line.startswith("return ") or line == "return":
            continue
        lines.append(line)
    body = "\n".join(lines)
    body = re.sub(r"out = out or ", "out = ", body, count=1)

    # split at section() calls; the comment ruler preceding each is
    # dropped with it
    parts = re.split(r'(?:# -{10,}\n)?section\("(.*?)"\)\n', body)
    intro = parts[0].strip()
    if intro:
        cells.append(code_cell(intro))
    for i in range(1, len(parts), 2):
        cells.append(md_cell("## " + parts[i]))
        chunk = parts[i + 1].strip()
        if chunk:
            cells.append(code_cell(chunk))
    return cells


# ---------------------------------------------------------------------
# authored notebooks (no script counterpart: these walk artifacts and
# configs rather than library APIs)

RUNNING_JOBS_CELLS = [
    md_cell("""\
# Running pipeline jobs

Counterpart of the reference's `notebooks/running_jobs.ipynb`
(how to configure and launch `protein_monomer` pipeline runs).

A job is described by ONE YAML configuration file with the same
sections and keys as the reference
(`config/sample_config_monomer.txt`): `pipeline`, `stages`, `global`,
`batch`, `management`, `environment`, `databases`, `tools`, plus one
section per stage. Configuration rules (identical to the reference):

* all settings are explicit in the file — no hidden defaults in code;
* keys in `global` override the same key in any stage section;
* each stage's outputs are merged into the global state and become
  available to later stages (the `.outcfg` chain on disk);
* a `batch` section turns one file into a parameter sweep of sub-jobs.

Two command-line entry points mirror the reference:

* `evcouplings_torch_runcfg <config.yml>` — run ONE job exactly as
  configured;
* `evcouplings_torch <config.yml> [flags]` — the application layer:
  substitutes CLI flags into the config, unrolls `batch` sweeps, and
  submits every sub-job through the configured engine (`local`,
  `lsf`, `slurm`, `sge`), with tracking and a run-level summary.

Both also work without installed console scripts:
`python -m evcouplings_torch.utils.pipeline` / `python -m
evcouplings_torch.utils.app`."""),
    code_cell(LOCATE_EXAMPLES),
    md_cell("""\
## Reading and modifying a configuration from Python

`read_config_file` / `write_config_file` round-trip the YAML job
configuration; this is the supported way to generate many related
configs programmatically (the reference does the same in its
notebook)."""),
    code_cell('''\
from evcouplings_torch.utils import read_config_file, write_config_file

config = read_config_file(
    os.path.join(EXAMPLES, "monomer_pipeline.yml"))
print("pipeline:", config["pipeline"])
print("stages:  ", config["stages"])
print("couplings settings:", config["couplings"])'''),
    code_cell('''\
import tempfile

workdir = tempfile.mkdtemp(prefix="running_jobs_")

# point the job somewhere else and tighten the fit for the demo
config["global"]["prefix"] = os.path.join(workdir, "demo")
config["couplings"]["iterations"] = int(
    os.environ.get("TUTORIAL_ITERS", 60))

# paths in the bundled config are relative to the repository root
config["align"]["input_alignment"] = os.path.join(
    DATA, "demo_monomer.a2m")

# the job runs on the CUDA device (a config without a `device:` key);
# EVCOUPLINGS_TORCH_DEVICE=cpu puts it on the host
DEVICE = os.environ.get("EVCOUPLINGS_TORCH_DEVICE") or None
if DEVICE:
    config["global"]["device"] = DEVICE

job_config = os.path.join(workdir, "job.yml")
write_config_file(job_config, config)
print("wrote", job_config)'''),
    md_cell("""\
## Running the pipeline from within Python

`evcouplings_torch_runcfg job.yml` does exactly this: the pipeline runtime
executes each configured stage, writes the per-stage
`.incfg`/`.outcfg` chain plus `.done`/`.failed` flag files, and
returns the merged global state (a dict of result-file paths and
statistics)."""),
    code_cell('''\
from evcouplings_torch.utils import pipeline

outcfg = pipeline.execute_wrapped(**read_config_file(job_config))

print("N_eff:", outcfg["effective_sequences"])
print("EC file:", outcfg["ec_file"])
print("done flag exists:",
      os.path.isfile(config["global"]["prefix"] + ".done"))'''),
    md_cell("""\
## Specifying stages and re-starting jobs

`stages` selects which parts of the pipeline run. A re-run with the
same prefix SKIPS completed stages whose outputs still verify (the
saved `.outcfg` is reused), so a job can be resumed or extended — for
example running `align` first and adding `couplings` later, or
re-starting an interrupted run at the failed stage. Delete a stage's
output files to force recomputation."""),
    code_cell('''\
# re-running the identical job reuses both finished stages
outcfg2 = pipeline.execute_wrapped(**read_config_file(job_config))
import pandas as pd

runtimes = pd.read_csv(outcfg2["runtime_file"])
print(runtimes.to_string(index=False))  # reused stages take ~0 s'''),
    md_cell("""\
## Batch jobs

A `batch` section maps job suffixes to config overrides; the
`evcouplings_torch` application unrolls it into one sub-job per entry (used
for the reference's bitscore-threshold sweeps). Each sub-job is an
independent pipeline run submitted through the configured engine —
see `examples_torch/README.md` and `docs/configuration.md` for the
engine/submitter matrix and `utils/batch.py` for LSF/Slurm/SGE."""),
    code_cell('''\
from evcouplings_torch.utils.app import unroll_config

config["batch"] = {
    "_run1": {"global": {"theta": 0.8}},
    "_run2": {"global": {"theta": 0.9}},
}
# one config per sub-job, keyed by the sub-job prefix
subjobs = unroll_config(config)
for sub_prefix, sub_config in sorted(subjobs.items()):
    print(os.path.basename(sub_prefix), "theta =",
          sub_config["global"]["theta"])'''),
]

RUNNING_JOBS_COMPLEXES_CELLS = [
    md_cell("""\
# Running complex pipeline jobs

Counterpart of the reference's
`notebooks/running_jobs_complexes.ipynb`.

The `protein_complex` pipeline predicts INTER-protein contacts from
paired alignments. Stages (vs. the monomer pipeline): `align_1` and
`align_2` generate one alignment per interaction partner (any
monomer-align protocol; their config sections are `align_1`/`align_2`
and outputs get `first_`/`second_` key prefixes), `concatenate` pairs
sequences across the two alignments into one concatenated alignment,
then `couplings`, `compare`, `mutate`, `fold` run complex-aware
protocols.

Parameters that differ from the monomer pipeline:

* two `global` sequence ids (`sequence_id` per align section);
* `concatenate.protocol`: `genome_distance` (pair by genomic
  proximity of the coding sequences) or `best_hit` (pair each
  species' best hit to the target, optionally reciprocal);
* `couplings.protocol: complex` adds segment-aware EC output
  (`segment_i`/`segment_j` columns, inter/intra EC split, EVcomplex
  scores)."""),
    code_cell(LOCATE_EXAMPLES),
    code_cell('''\
from evcouplings_torch.utils import read_config_file, write_config_file

config = read_config_file(
    os.path.join(EXAMPLES, "complex_pipeline.yml"))
print("pipeline:", config["pipeline"])
print("stages:  ", config["stages"])
print("concatenation protocol:", config["concatenate"]["protocol"])'''),
    md_cell("""\
## Modifying the config file from within Python

Same mechanics as the monomer pipeline — batch sweeps included."""),
    code_cell('''\
import tempfile

workdir = tempfile.mkdtemp(prefix="running_complexes_")
config["global"]["prefix"] = os.path.join(workdir, "demo_complex")
config["couplings"]["iterations"] = int(
    os.environ.get("TUTORIAL_ITERS", 60))
config["align_1"]["input_alignment"] = os.path.join(
    DATA, "demo_chain_a.a2m")
config["align_2"]["input_alignment"] = os.path.join(
    DATA, "demo_chain_b.a2m")
# species annotations per chain (a database-search align stage would
# produce these; the hermetic existing-alignment protocol takes them
# as inputs to the concatenate stage)
config["concatenate"]["first_annotation_file"] = os.path.join(
    DATA, "demo_chain_a_annotation.csv")
config["concatenate"]["second_annotation_file"] = os.path.join(
    DATA, "demo_chain_b_annotation.csv")

# the job runs on the CUDA device (a config without a `device:` key);
# EVCOUPLINGS_TORCH_DEVICE=cpu puts it on the host
DEVICE = os.environ.get("EVCOUPLINGS_TORCH_DEVICE") or None
if DEVICE:
    config["global"]["device"] = DEVICE

job_config = os.path.join(workdir, "job.yml")
write_config_file(job_config, config)'''),
    md_cell("""\
## Running the pipeline

`evcouplings_torch_runcfg job.yml` on the command line, or directly from
Python:"""),
    code_cell('''\
from evcouplings_torch.utils import pipeline

outcfg = pipeline.execute_wrapped(**read_config_file(job_config))

import pandas as pd

inter = pd.read_csv(outcfg["inter_ec_file"])
print("top inter-protein ECs:")
print(inter.head(5).to_string(index=False))'''),
]

OUTPUT_FILES_INTRO = md_cell("""\
# Standard outputs of a pipeline run

Counterpart of the reference's `notebooks/output_files_tutorial.ipynb`
— a walk through the artifacts a `protein_monomer` run leaves on disk
and how to load each one (the full format contract is in
`docs/file_formats.md`). This notebook first produces a real run
directory from the bundled demo alignment, then inspects it.""")

OUTPUT_FILES_CELLS = [
    OUTPUT_FILES_INTRO,
    code_cell(LOCATE_EXAMPLES + '''


import tempfile

import pandas as pd

from evcouplings_torch.utils import pipeline, read_config_file

config = read_config_file(
    os.path.join(EXAMPLES, "monomer_pipeline.yml"))
workdir = tempfile.mkdtemp(prefix="output_files_")
prefix = os.path.join(workdir, "demo")
config["global"]["prefix"] = prefix
config["align"]["input_alignment"] = os.path.join(
    DATA, "demo_monomer.a2m")
config["couplings"]["iterations"] = int(
    os.environ.get("TUTORIAL_ITERS", 60))

# the job runs on the CUDA device (a config without a `device:` key);
# EVCOUPLINGS_TORCH_DEVICE=cpu puts it on the host
DEVICE = os.environ.get("EVCOUPLINGS_TORCH_DEVICE") or None
if DEVICE:
    config["global"]["device"] = DEVICE

outcfg = pipeline.execute_wrapped(**config)
sorted(f for f in os.listdir(os.path.join(workdir, "demo", "align")))'''),
    md_cell("""\
## Part 1: alignment and alignment statistics

**Final alignment (`_raw_focus.fasta` / `.a2m`)** — the processed
focus-mode alignment the model is fit on; load it with the
`Alignment` class."""),
    code_cell('''\
from evcouplings_torch.align import Alignment

with open(outcfg["alignment_file"]) as f:
    aln = Alignment.from_file(f, format="fasta")
print("{} sequences x {} positions".format(aln.N, aln.L))'''),
    md_cell("""\
**Alignment statistics (`_alignment_statistics.csv`)** — per-run
summary (sequence counts, coverage, N_eff); **frequencies
(`_frequencies.csv`)** — per-position symbol frequencies;
**identities (`_identities.csv`)** — per-sequence identity to the
target."""),
    code_cell('''\
print(pd.read_csv(outcfg["statistics_file"]).to_string(index=False))
pd.read_csv(outcfg["frequencies_file"]).head()'''),
    code_cell('''\
pd.read_csv(outcfg["identities_file"]).head()'''),
    md_cell("""\
## Part 2: coupling scores

**Raw EC file (`_ECs.txt`)** — space-separated `i A_i j A_j fn cn`
rows straight from the fitter (the plmc format);
**`_CouplingScores.csv`** — the ranked EC table with `probability`
and `score` columns (and `segment_i`/`segment_j` for complexes);
`_CouplingScores_longrange.csv` keeps only pairs |i−j| ≥ 6."""),
    code_cell('''\
from evcouplings_torch.couplings import read_raw_ec_file

ecs_raw = read_raw_ec_file(outcfg["raw_ec_file"])
ecs = pd.read_csv(outcfg["ec_file"])
ecs.head()'''),
    md_cell("""\
**Enrichment (`_enrichment.csv`)** — per-residue cumulative coupling
strength (Hopf 2012); written when the couplings stage runs with
scoring enabled. The EC table is also exported for the EVzoom web
viewer as `_evzoom.json`."""),
    code_cell('''\
from evcouplings_torch.couplings.pairs import enrichment

enrichment(ecs).head()'''),
    md_cell("""\
## Part 3: model parameters (`.model`)

The fitted Potts model in the plmc_v2 binary format — fields h_i,
couplings J_ij, frequencies, weights, and fit metadata. The
`CouplingsModel` class gives indexed access in target numbering and
computes mutation effects (see the model-parameters notebook)."""),
    code_cell('''\
from evcouplings_torch.couplings import CouplingsModel

c = CouplingsModel(outcfg["model_file"])
print("L = {}, q = {}, N_eff = {:.1f}".format(
    c.L, c.num_symbols, c.N_eff))
print("theta = {}, lambda_J = {}".format(c.theta, c.lambda_J))'''),
    md_cell("""\
## Part 4: structure-stage outputs

With a `compare` stage configured, the run additionally contains
`_CouplingScoresCompared.csv` / `_longrange` (ECs annotated with
experimental distances + precision), `_distance_map.csv`/`.npy`
(aggregated residue distance maps), `_structure_hits.csv` (the PDB
chains used), remapped PDB files, and contact-map PDFs; a `fold`
stage adds folded models (`.pdb`), `_ranking.csv`,
`_secondary_structure.csv`, and EC files filtered for secondary-
structure clashes; a `mutate` stage adds
`_single_mutant_matrix.csv` and prediction tables for user datasets.
The distance-calculations notebook builds these objects directly."""),
    md_cell("""\
## Part 5: configuration chain and flag files

Every stage writes `<prefix>_<stage>.incfg` (its effective input
configuration) and `.outcfg` (its outputs); the merged global state
lands in `<prefix>_final.outcfg`. Flag files signal job state:
`.done`, `.failed`, `.terminated`, `.bailout` (deliberate early
exit, e.g. no significant couplings). `_runtime.csv` records
per-stage wall time."""),
    code_cell('''\
from evcouplings_torch.utils import read_config_file as read_cfg

final = read_cfg(prefix + "_final.outcfg")
print("final.outcfg keys:", len(final))
print("flag files:", [s for s in (".done", ".failed", ".bailout")
                      if os.path.isfile(prefix + s)])
pd.read_csv(final["runtime_file"])'''),
]


NOTEBOOKS = {
    "alignment_analysis.ipynb": lambda: convert_tutorial(
        "tutorial_alignment_analysis.py",
        "Alignment handling and analysis"),
    "model_parameters_mutation_effects.ipynb": lambda: convert_tutorial(
        "tutorial_model_parameters.py",
        "Model parameters and mutation effects"),
    "distance_calculations.ipynb": lambda: convert_tutorial(
        "tutorial_distances.py",
        "Distance calculations and contact maps"),
    "running_jobs.ipynb": lambda: RUNNING_JOBS_CELLS,
    "running_jobs_complexes.ipynb": lambda: RUNNING_JOBS_COMPLEXES_CELLS,
    "output_files_tutorial.ipynb": lambda: OUTPUT_FILES_CELLS,
}


def generate(out_dir):
    os.makedirs(out_dir, exist_ok=True)
    for name, build in sorted(NOTEBOOKS.items()):
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            json.dump(notebook(build()), f, indent=1, sort_keys=True)
            f.write("\n")
        print("wrote", path)


if __name__ == "__main__":
    generate(sys.argv[1] if len(sys.argv) > 1
             else os.path.join(REPO, "notebooks_torch"))
