"""
Fixtures of the fold stage, made with numpy alone: fake CNS, PSIPRED and
maxcluster binaries and the model they hand out. chip_smoke.py imports
this file too, so it imports neither package.

Neither this machine nor the card machine has CNSsolve, PSIPRED or
maxcluster. The fakes keep the command-line contract of the fold stage's
wrappers (evcouplings_*/fold/tools.py):

- cns (python3, three directory levels below its "install root" as a
  real install is) reads the rendered protocol script on stdin and
  writes every file the script names: `write structure output=` (a
  topology stub), `write coordinates output=` and the dg_sa trial loop's
  runtime-assembled `$filename` (copies of one model PDB);
- runpsipred (bash) writes <query>.ss2 and <query>.horiz into its working
  directory, the states a fixed function of the position;
- maxcluster (bash) answers clustering (-C, assignment lines between
  "Clusters @ Threshold" and a "Centroids" section that must not be
  read) and comparison against an experiment (-e, one "vs." line per
  listed model), with numbers that depend only on the list position and
  the experiment's CA count, so two runs on the same inputs print the
  same.
"""

import os

import numpy as np

AA1_TO_AA3 = {
    "A": "ALA", "R": "ARG", "N": "ASN", "D": "ASP", "C": "CYS",
    "Q": "GLN", "E": "GLU", "G": "GLY", "H": "HIS", "I": "ILE",
    "L": "LEU", "K": "LYS", "M": "MET", "F": "PHE", "P": "PRO",
    "S": "SER", "T": "THR", "W": "TRP", "Y": "TYR", "V": "VAL",
}

# psipred's 3-state prediction at 1-based position k: SS_PATTERN[(k-1) %
# len(SS_PATTERN)] (helices, strands and coil, so that every restraint
# family and both dihedral rankings have work)
SS_PATTERN = "CCHHHHHHHHCCCEEEEECCCEEEEECC"

FAKE_CNS = """#!/usr/bin/env python3
# fake CNSsolve: reads the rendered protocol script from stdin (the way
# run_cns drives the real binary) and writes every file it names
import re, shutil, sys

SRC = {src!r}
script = sys.stdin.read()

# write structure output="<file>" end -> molecular topology file
for m in re.finditer(r'write\\s+structure\\s+output="([^"]+)"', script):
    with open(m.group(1), "w") as f:
        f.write("fake mtf\\n")

# write coordinates [format=X] output="<file>" end -> a copy of the model
for m in re.finditer(
        r'write\\s+coordinates\\s+(?:format=\\w+\\s+)?output="([^"]+)"',
        script):
    shutil.copy(SRC, m.group(1))

# dg_sa trial loop: the file name is assembled at CNS runtime from
#   evaluate ($filename = "<base>_" + encode($count) + ".pdb")
# inside  while ($count < N) loop dgsa
fm = re.search(
    r'\\$filename\\s*=\\s*"([^"]+)"\\s*\\+\\s*'
    r'encode\\(\\$count\\)\\s*\\+\\s*"\\.pdb"',
    script, re.S)
cm = re.search(r'while\\s+\\(\\$count\\s*<\\s*(\\d+)\\)\\s+loop\\s+dgsa',
               script)
if fm and cm:
    for k in range(1, int(cm.group(1)) + 1):
        shutil.copy(SRC, fm.group(1) + str(k) + ".pdb")
"""

FAKE_PSIPRED = r"""#!/bin/bash
# fake runpsipred: writes ss2/horiz predictions for the input FASTA into
# the current working directory (as the real driver script does)
set -e
FASTA="$1"
ROOT=$(basename "$FASTA")
ROOT="${ROOT%.*}"
python3 - "$FASTA" "$ROOT" <<'PYEOF'
import sys
fasta, root = sys.argv[1], sys.argv[2]
pattern = "@PATTERN@"
seq = "".join(
    l.strip() for l in open(fasta) if not l.startswith(">")
)
states = "".join(pattern[k % len(pattern)] for k in range(len(seq)))
with open(root + ".ss2", "w") as f:
    f.write("# PSIPRED VFORMAT (fake)\n\n")
    for k, (aa, s) in enumerate(zip(seq, states), start=1):
        f.write("{:4d} {} {}   0.100  0.800  0.100\n".format(k, aa, s))
with open(root + ".horiz", "w") as f:
    f.write("# PSIPRED HFORMAT (fake)\n")
    f.write("Conf: " + "9" * len(seq) + "\n")
    f.write("Pred: " + states + "\n")
    f.write("  AA: " + seq + "\n")
PYEOF
"""

FAKE_MAXCLUSTER = r"""#!/bin/bash
# fake maxcluster: clustering (-C) in the real layout, assignment lines
# "INFO : <item> : <cluster>  <file>" inside the "Clusters @ Threshold"
# section and a Centroids section after it; comparison (-e) one
# "vs." line per listed model
set -e
LIST=
EXP=
args=("$@")
for ((k=0; k<$#; k++)); do
  [ "${args[k]}" = "-l" ] && LIST="${args[k+1]}"
  [ "${args[k]}" = "-e" ] && EXP="${args[k+1]}"
done
n=0
if [ -n "$EXP" ]; then
  pairs=$(grep -c ' CA ' "$EXP" || true)
  while read -r f; do
    n=$((n+1))
    printf "INFO  : %d. vs. %s  Pairs=%4d, RMSD=%2d.%03d, MaxSub=0.%03d, TM=0.%03d, MSI=0.%03d\n" \
      "$n" "$f" "$pairs" $((n % 7)) $(((n * 113) % 1000)) \
      $(((n * 71) % 1000)) $(((n * 37) % 900 + 100)) $(((n * 53) % 1000))
  done < "$LIST"
  exit 0
fi
echo "INFO  : Clusters @ Threshold  5.000 (size)"
while read -r f; do
  n=$((n+1))
  echo "INFO  :   $n : $(( (n - 1) % 3 + 1 ))  $f"
done < "$LIST"
echo "INFO  : Centroids"
echo "INFO  :   1 : 99  ignored_centroid.pdb"
"""


def helix_pdb(sequence, first_index=1):
    """CA trace of an ideal alpha helix over `sequence`, residues numbered
    from first_index: parseable by the PDB readers, with geometry for the
    dihedral ranking."""
    lines = []
    for k, aa in enumerate(sequence):
        theta = np.deg2rad(100.0 * k)
        x, y, z = 2.3 * np.cos(theta), 2.3 * np.sin(theta), 1.5 * k
        lines.append(
            "ATOM  {:>5}  CA  {} A{:>4}    "
            "{:8.3f}{:8.3f}{:8.3f}  1.00  0.00           C".format(
                k + 1, AA1_TO_AA3.get(aa.upper(), "ALA"),
                first_index + k, x, y, z))
    return "\n".join(lines) + "\nEND\n"


def _executable(path, text):
    with open(path, "w") as f:
        f.write(text)
    os.chmod(path, 0o755)
    return path


def write_fold_tools(directory, sequence, first_index=1):
    """The three fake binaries and the model PDB the fake cns hands out
    (a helix over `sequence`) under `directory`; returns {"cns",
    "runpsipred", "maxcluster", "model"} paths. Write them inside a
    checkout or a test's temporary directory, where files may be
    executed."""
    directory = os.path.abspath(directory)
    bin_dir = os.path.join(directory, "cnsroot", "intel", "bin")
    os.makedirs(bin_dir, exist_ok=True)
    model = os.path.join(directory, "model_src.pdb")
    with open(model, "w") as f:
        f.write(helix_pdb(sequence, first_index))
    return {
        "cns": _executable(os.path.join(bin_dir, "cns"),
                           FAKE_CNS.format(src=model)),
        "runpsipred": _executable(
            os.path.join(directory, "runpsipred"),
            FAKE_PSIPRED.replace("@PATTERN@", SS_PATTERN)),
        "maxcluster": _executable(os.path.join(directory, "maxcluster"),
                                  FAKE_MAXCLUSTER),
        "model": model,
    }


def fold_section(num_models=2, cpu=1, sample=False, cleanup=True):
    """A fold `standard` config section (config/sample_config_monomer.txt's
    settings where sample=True: probability cutoffs [0.90, 0.99], the
    count ramp 0.5-1.3 by 0.05; otherwise the cutoffs and a short integer
    ramp), secondary structure from psipred. cleanup=False keeps the
    sub-runs' restraint tables and CNS scripts."""
    ramp = ((0.5, 1.3, 0.05) if sample else (8, 12, 4))
    return {
        "protocol": "standard", "engine": "cns_dgsa",
        "folding_config_file": None, "sec_struct_method": "psipred",
        "sec_struct_file": None, "reuse_sec_struct": True,
        "filter_sec_struct_clashes": True, "min_sequence_distance": 6,
        "cut_to_alignment_region": True,
        "fold_probability_cutoffs": [0.90, 0.99],
        "fold_lowest_count": ramp[0], "fold_highest_count": ramp[1],
        "fold_increase": ramp[2], "num_models": num_models, "cpu": cpu,
        "cleanup": cleanup,
    }


# the fold stage's artifacts, by outcfg key
FOLD_FILE_KEYS = ("folding_ec_file", "sec_struct_file",
                  "secondary_structure_pml_file", "folding_ranking_file",
                  "folding_comparison_file")


def fold_artifacts(outcfg):
    """{name relative to the stage directory: path} of every artifact of a
    fold outcfg: the tables and the .pml, the sub-runs' restraint tables,
    CNS scripts and .seq files (kept when cleanup is off), the models,
    and the per-experiment comparison tables."""
    stage_dir = os.path.dirname(outcfg["folding_ec_file"])
    paths = [outcfg[k] for k in FOLD_FILE_KEYS if outcfg.get(k)]
    paths += list(outcfg.get("folded_structure_files") or [])
    paths += list(outcfg.get("folding_individual_comparison_files") or {})
    for root, _, names in os.walk(stage_dir):
        paths += [os.path.join(root, n) for n in names
                  if n.endswith((".tbl", ".inp", ".seq"))]
    return {os.path.relpath(p, stage_dir): p for p in paths}


def assert_same_fold_artifacts(got, want, got_root, want_root):
    """Every fold artifact of two outcfgs equal byte for byte, each
    file's text with the runs' root directories replaced (tables name
    model paths). Returns the number of files compared."""
    a, b = fold_artifacts(got), fold_artifacts(want)
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    # either run's tables may name the other's files (a run on a copy of
    # a job's tree reads the structures of the original)
    roots = sorted({got_root, want_root}, key=len, reverse=True)

    def text(path):
        with open(path) as f:
            out = f.read()
        for root in roots:
            out = out.replace(root, "<root>")
        return out

    for name in a:
        assert text(a[name]) == text(b[name]), name
    return len(a)
