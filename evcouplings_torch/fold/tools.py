"""
Wrappers for external folding tools: CNSsolve, PSIPRED, maxcluster
(port of evcouplings_tpu/fold/tools.py): run_cns, run_cns_13,
run_psipred, the psipred readers, and maxcluster comparison and
clustering with their output parsers.
"""

import re
from collections import defaultdict
from copy import deepcopy
from os import environ, path

import pandas as pd

from evcouplings_torch.utils.config import InvalidParameterError
from evcouplings_torch.utils.system import (
    makedirs,
    run,
    temp,
    verify_resources,
)

# CNS 1.21 environment layout relative to the installation root: each
# entry is (variable, root key, subdirectory), where the root key picks
# the base directory the subdirectory hangs off of
_CNS_ENV_LAYOUT = (
    ("CNS_HELPLIB", "main", "helplib"),
    ("CNS_TOPPAR", "lib", "toppar"),
    ("CNS_CONFDB", "lib", "confdb"),
    ("CNS_XTALLIB", "lib", "xtal"),
    ("CNS_NMRLIB", "lib", "nmr"),
    ("CNS_XRAYLIB", "lib", "xray"),
    ("CNS_XTALMODULE", "mod", "xtal"),
    ("CNS_NMRMODULE", "mod", "nmr"),
)


def _script_text(inp_script, inp_file):
    """The CNS .inp script body to feed via stdin: the file's content
    when a path is given (overriding any inline script), else the
    inline script; at least one must be present."""
    if inp_file is not None:
        with open(inp_file) as handle:
            return handle.read()
    if inp_script is None:
        raise InvalidParameterError(
            "Must specify either input_script or input_file"
        )
    return inp_script


def _capture_log(log_file, stdout):
    if log_file is not None:
        with open(log_file, "w") as handle:
            handle.write(stdout)


def _cns_121_environment(install_root):
    """CNS_* variables for a CNSsolve 1.21 installation rooted at
    install_root (reference sets the same variables but never hands
    them to the subprocess; here they are actually applied). The
    reference's literal value for CNS_HELPLIB contains a typo
    ("helplip"); this writes the correct directory name."""
    roots = {
        "main": install_root,
        "lib": path.join(install_root, "libraries"),
        "mod": path.join(install_root, "modules"),
    }
    env = deepcopy(environ)
    env["CNS_SOLVE"] = roots["main"]
    env["CNS_LIB"] = roots["lib"]
    env["CNS_MODULE"] = roots["mod"]
    for var, root_key, subdir in _CNS_ENV_LAYOUT:
        env[var] = path.join(roots[root_key], subdir)
    return env


def run_cns(inp_script=None, inp_file=None, log_file=None, binary="cns"):
    """Run CNSsolve 1.21, feeding the .inp script via stdin and setting
    up the CNS_* environment from the binary's installation layout.

    The caller is responsible for verifying the output products (their
    paths are determined inside the .inp scripts).
    """
    script = _script_text(inp_script, inp_file)

    binary = path.abspath(binary)
    # installation root sits three directory levels above the binary
    install_root = path.dirname(path.dirname(path.dirname(binary)))

    _, stdout, _ = run(
        binary, stdin=script, env=_cns_121_environment(install_root)
    )
    _capture_log(log_file, stdout)


def run_cns_13(inp_script=None, inp_file=None, log_file=None,
               source_script=None, binary="cns"):
    """Run CNSsolve 1.3 (environment set up by sourcing
    .cns_solve_env_sh from the installation)."""
    script = _script_text(inp_script, inp_file)

    prelude = "" if source_script is None else (
        "source {};".format(source_script)
    )
    _, stdout, _ = run(prelude + binary, stdin=script, shell=True)
    _capture_log(log_file, stdout)


def run_psipred(fasta_file, output_dir, binary="runpsipred"):
    """Run PSIPRED secondary-structure prediction; returns the paths
    of the .ss2 (VFORMAT) and .horiz (HFORMAT) result files."""
    fasta_file = path.abspath(fasta_file)
    verify_resources("Input FASTA file is invalid", fasta_file)

    output_dir = path.abspath(output_dir)
    makedirs(output_dir)

    # runpsipred drops its outputs into the current working directory,
    # named after the query file's root name
    run([path.abspath(binary), fasta_file], working_dir=output_dir)

    stem = path.join(
        output_dir, path.splitext(path.basename(fasta_file))[0]
    )
    results = (stem + ".ss2", stem + ".horiz")
    verify_resources("psipred output is invalid", *results)
    return results


# columns of a VFORMAT (.ss2) prediction, in file order
_VFORMAT_COLUMNS = (
    "i", "A_i", "sec_struct_3state",
    "score_coil", "score_helix", "score_strand",
)


def _detect_psipred_format(filename):
    """"hformat"/"vformat" from the file's format marker comments
    (the last marker wins, matching the reference's scan)."""
    detected = None
    with open(filename) as handle:
        for line in handle:
            if line.startswith("# PSIPRED HFORMAT"):
                detected = "hformat"
            elif line.startswith("# PSIPRED VFORMAT"):
                detected = "vformat"
    return detected


def _read_horizontal_prediction(filename):
    """HFORMAT: Conf/Pred/AA rows come in wrapped blocks of
    "Key: chunk" lines; concatenate each key's chunks (whitespace
    dropped), then explode the three strings into per-residue rows."""
    tracks = defaultdict(str)
    with open(filename) as handle:
        for line in handle:
            packed = "".join(line.split())
            if ":" in packed:
                key, _, chunk = packed.partition(":")
                tracks[key] += chunk

    residues = pd.DataFrame({
        "A_i": list(tracks["AA"]),
        "sec_struct_3state": list(tracks["Pred"]),
        "sec_struct_conf": [int(c) for c in tracks["Conf"]],
    })
    residues["i"] = range(1, len(residues) + 1)
    return residues


def read_psipred_prediction(filename, first_index=1):
    """Parse a PSIPRED prediction (auto-detecting horizontal/vertical
    format) into a DataFrame with columns i, A_i, sec_struct_3state
    (+ per-state scores or confidence)."""
    layout = _detect_psipred_format(filename)

    if layout == "vformat":
        prediction = pd.read_csv(
            filename, sep=r"\s+", comment="#",
            skip_blank_lines=True, names=_VFORMAT_COLUMNS,
        )
    elif layout == "hformat":
        prediction = _read_horizontal_prediction(filename)
    else:
        raise InvalidParameterError(
            "Input file is not a valid psipred prediction file"
        )

    prediction.loc[:, "i"] += first_index - 1
    return prediction


def _structure_list_file(structure_files):
    """Write the structure paths to a temp list file (maxcluster -l
    input) and return its path."""
    listing = temp()
    with open(listing, "w") as handle:
        handle.write("".join(p + "\n" for p in structure_files))
    return listing


# one comparison result line of maxcluster stdout
_COMPARISON_LINE = re.compile(
    r"vs\. (.+?)\s+Pairs=\s*(\d+), RMSD=\s*(\d+\.\d+), "
    r"MaxSub=\s*(\d+\.\d+), TM=\s*(\d+\.\d+), MSI=\s*(\d+\.\d+)"
)
_COMPARISON_COLUMNS = ("filename", "num_pairs", "rmsd", "maxsub", "tm",
                       "msi")


def parse_maxcluster_comparison(comparison_output):
    """Parse maxcluster comparison stdout into a DataFrame (filename,
    num_pairs, rmsd, maxsub, tm, msi)."""
    rows = [
        hit.groups()
        for hit in map(_COMPARISON_LINE.search,
                       comparison_output.splitlines())
        if hit
    ]
    table = pd.DataFrame(rows, columns=_COMPARISON_COLUMNS)
    for column in _COMPARISON_COLUMNS[1:]:
        table[column] = pd.to_numeric(table[column])
    if len(table):
        table["num_pairs"] = table.num_pairs.astype(int)
    return table


def run_maxcluster_compare(predictions, experiment,
                           normalization_length=None,
                           distance_cutoff=None, binary="maxcluster"):
    """Compare predicted structures to an experimental structure with
    maxcluster; returns the parsed comparison table."""
    invocation = [
        binary, "-l", _structure_list_file(predictions),
        "-e", experiment,
    ]
    if normalization_length is not None:
        invocation += ["-N", str(normalization_length)]
    if distance_cutoff is not None:
        invocation += ["-d", str(distance_cutoff)]

    _, stdout, _ = run(invocation)
    return parse_maxcluster_comparison(stdout)


# one cluster-assignment line: "INFO : <item> : <cluster>  <file>"
_ASSIGNMENT_LINE = re.compile(r"INFO\s*:\s*(\d+)\s*:\s*(\d+)\s+(.+)")


def parse_maxcluster_clustering(clustering_output):
    """Parse maxcluster clustering stdout into a DataFrame (filename,
    cluster, cluster_size).

    Assignment lines only appear between the "Clusters @ Threshold"
    header and the "Centroids" section (which repeats INFO lines in a
    different layout and must not be ingested) — reference
    fold/tools.py:422-464.
    """
    assignments = []
    in_assignment_block = False
    for line in clustering_output.splitlines():
        if "Clusters @ Threshold" in line:
            in_assignment_block = True
        if "Centroids" in line:
            in_assignment_block = False
        if not in_assignment_block:
            continue
        hit = _ASSIGNMENT_LINE.search(line)
        if hit:
            _, cluster_id, structure = hit.groups()
            assignments.append((structure.strip(), int(cluster_id)))

    table = pd.DataFrame(assignments, columns=["filename", "cluster"])
    table["cluster_size"] = table.cluster.map(
        table.cluster.value_counts()
    )
    return table


# maxcluster -C argument per clustering method name
_CLUSTER_METHOD_IDS = {
    "single": 1,
    "average": 2,
    "maximum": 3,
    "pairs_min": 4,
    "pairs_abs": 5,
}


def run_maxcluster_cluster(predictions, method="average", rmsd=True,
                           clustering_threshold=None,
                           binary="maxcluster"):
    """Cluster predicted structures with maxcluster; returns the
    parsed clustering table."""
    try:
        method_id = _CLUSTER_METHOD_IDS[method]
    except KeyError:
        raise InvalidParameterError(
            "Method must be one of the following: "
            + ", ".join(_CLUSTER_METHOD_IDS)
        ) from None

    invocation = [
        binary, "-l", _structure_list_file(predictions),
        "-C", str(method_id),
    ]
    if rmsd:
        invocation.append("-rmsd")
    if clustering_threshold is not None:
        invocation += ["-T", str(clustering_threshold)]

    _, stdout, _ = run(invocation)
    return parse_maxcluster_clustering(stdout)
