"""
Wrappers for external alignment-generation tools (HMMER suite, HHsuite);
port of evcouplings_tpu/align/tools.py.

run_hmmbuild, run_hmmsearch, run_jackhmmer, run_hmmscan, the tbl/domtbl
parsers and run_hhfilter. Profile-HMM database search runs on the host:
these are subprocess calls through the single utils.system.run
chokepoint, with the JAX package's flag construction and output-file
contracts (.sto/.tblout/.domtblout naming), so downstream protocols are
interchangeable.
"""

import io
from collections import namedtuple

import pandas as pd

from evcouplings_torch.utils.system import (
    create_prefix_folders,
    run,
    verify_resources,
)

HmmbuildResult = namedtuple(
    "HmmbuildResult", ["prefix", "hmmfile", "output"]
)

HmmsearchResult = namedtuple(
    "HmmsearchResult",
    ["prefix", "alignment", "output", "tblout", "domtblout"],
)

JackhmmerResult = namedtuple(
    "JackhmmerResult",
    ["prefix", "alignment", "output", "tblout", "domtblout"],
)

HmmscanResult = namedtuple(
    "HmmscanResult",
    ["prefix", "output", "tblout", "domtblout", "pfamtblout"],
)


def _prepare(prefix, *input_files):
    """Shared pre-flight of every tool wrapper: inputs must exist and
    be non-empty, and the prefix directory must exist."""
    verify_resources(
        "Input file does not exist or is empty", *input_files
    )
    create_prefix_folders(prefix)


def _stdout_target(prefix, stdout_redirect):
    """Where the tool's -o stdout goes: an explicit redirect if the
    caller gave one, else <prefix>.output."""
    return stdout_redirect if stdout_redirect is not None \
        else prefix + ".output"


def _expect_output(tool, kind, stdout, stderr, filename):
    """Fail with the tool's stdout/stderr attached when an expected
    output file came back missing or empty."""
    verify_resources(
        "{} returned empty {}: stdout={} stderr={} file={}".format(
            tool, kind, stdout, stderr, filename
        ),
        filename,
    )


def _threshold_flags(use_bitscores, seq_threshold, domain_threshold):
    """Reporting + inclusion threshold flags shared by the HMMER search
    tools (reporting thresholds track inclusion thresholds to bound
    output size)."""
    seq_report, dom_report, seq_inc, dom_inc = (
        ("-T", "--domT", "--incT", "--incdomT") if use_bitscores
        else ("-E", "--domE", "--incE", "--incdomE")
    )
    return [
        seq_report, str(seq_threshold),
        dom_report, str(domain_threshold),
        seq_inc, str(seq_threshold),
        dom_inc, str(domain_threshold),
    ]


def _performance_flags(cpu, nobias):
    flags = [] if cpu is None else ["--cpu", str(cpu)]
    return flags + (["--nobias"] if nobias else [])


def run_jackhmmer(query, database, prefix, use_bitscores, domain_threshold,
                  seq_threshold, iterations=5, nobias=False, cpu=None,
                  stdout_redirect=None, checkpoints_hmm=False,
                  checkpoints_ali=False, binary="jackhmmer"):
    """Iterative jackhmmer search of query against sequence database.

    Returns a JackhmmerResult namedtuple of output file paths
    (alignment = Stockholm .sto). Parity: reference tools.py:241-367.
    """
    _prepare(prefix, query, database)

    result = JackhmmerResult(
        prefix,
        alignment=prefix + ".sto",
        output=_stdout_target(prefix, stdout_redirect),
        tblout=prefix + ".tblout",
        domtblout=prefix + ".domtblout",
    )

    checkpoint_flags = []
    if checkpoints_ali:
        checkpoint_flags += ["--chkali", prefix]
    if checkpoints_hmm:
        checkpoint_flags += ["--chkhmm", prefix]

    _, stdout, stderr = run(
        [binary, "-N", str(iterations),
         "-o", result.output,
         "-A", result.alignment,
         "--tblout", result.tblout,
         "--domtblout", result.domtblout,
         "--noali", "--notextw"]
        + _threshold_flags(use_bitscores, seq_threshold,
                           domain_threshold)
        + _performance_flags(cpu, nobias)
        + checkpoint_flags
        + [query, database]
    )

    _expect_output("jackhmmer", "alignment", stdout, stderr,
                   result.alignment)
    return result


def run_hmmbuild(alignment_file, prefix, cpu=None, stdout_redirect=None,
                 symfrac=None, binary="hmmbuild"):
    """Build a profile HMM from a multiple sequence alignment.

    Parity: reference tools.py:26-117.
    """
    _prepare(prefix, alignment_file)

    result = HmmbuildResult(
        prefix,
        hmmfile=prefix + ".hmm",
        output=_stdout_target(prefix, stdout_redirect),
    )

    symfrac_flags = (
        [] if symfrac is None else ["--symfrac", str(symfrac)]
    )
    _, stdout, stderr = run(
        [binary, "-o", result.output]
        + _performance_flags(cpu, nobias=False)
        + symfrac_flags
        + [result.hmmfile, alignment_file]
    )

    _expect_output("hmmbuild", "HMM profile", stdout, stderr,
                   result.hmmfile)
    return result


def run_hmmsearch(hmmfile, database, prefix, use_bitscores,
                  domain_threshold, seq_threshold, nobias=False, cpu=None,
                  stdout_redirect=None, binary="hmmsearch"):
    """Search a profile HMM against a sequence database.

    Parity: reference tools.py:125-233.
    """
    _prepare(prefix, hmmfile, database)

    result = HmmsearchResult(
        prefix,
        alignment=prefix + ".sto",
        output=_stdout_target(prefix, stdout_redirect),
        tblout=prefix + ".tblout",
        domtblout=prefix + ".domtblout",
    )

    run(
        [binary,
         "-o", result.output,
         "-A", result.alignment,
         "--tblout", result.tblout,
         "--domtblout", result.domtblout,
         "--noali", "--notextw"]
        + _threshold_flags(use_bitscores, seq_threshold,
                           domain_threshold)
        + _performance_flags(cpu, nobias)
        + [hmmfile, database]
    )
    return result


# model-stored cutoff sets hmmscan understands (gathering / noise /
# trusted, in Pfam terminology)
_MODEL_CUTOFFS = ("cut_ga", "cut_nc", "cut_tc")


def _hmmscan_threshold_flags(use_model_threshold, threshold_type,
                             use_bitscores, seq_threshold,
                             domain_threshold):
    """hmmscan threshold selection. Reference parity
    (tools.py:478-493): with explicit thresholds only REPORTING flags
    are passed — hmmscan keeps its default inclusion thresholds,
    unlike the search tools' shared flag builder."""
    if use_model_threshold:
        if threshold_type not in _MODEL_CUTOFFS:
            raise ValueError(
                "Invalid model threshold, valid choices are: "
                + ", ".join(_MODEL_CUTOFFS)
            )
        return ["--" + threshold_type]

    if domain_threshold is None or seq_threshold is None:
        raise ValueError(
            "Must define sequence- and domain-level reporting "
            "thresholds (domain_threshold / seq_threshold) when "
            "not using the model-specific cutoffs"
        )
    seq_flag, dom_flag = ("-T", "--domT") if use_bitscores \
        else ("-E", "--domE")
    return [seq_flag, str(seq_threshold),
            dom_flag, str(domain_threshold)]


def run_hmmscan(query, database, prefix, use_model_threshold=True,
                threshold_type="cut_ga", use_bitscores=True,
                domain_threshold=None, seq_threshold=None, nobias=False,
                cpu=None, stdout_redirect=None, binary="hmmscan"):
    """Scan query sequence(s) against a profile HMM database (e.g. Pfam).

    Parity: reference tools.py:376-508. By default uses the model-
    specific gathering/noise/trusted cutoffs stored in the HMM database
    (threshold_type in {cut_ga, cut_nc, cut_tc}).
    """
    _prepare(prefix, query, database)

    result = HmmscanResult(
        prefix,
        output=_stdout_target(prefix, stdout_redirect),
        tblout=prefix + ".tblout",
        domtblout=prefix + ".domtblout",
        pfamtblout=prefix + ".pfamtblout",
    )

    _, stdout, stderr = run(
        [binary,
         "-o", result.output,
         "--tblout", result.tblout,
         "--domtblout", result.domtblout,
         "--pfamtblout", result.pfamtblout,
         "--notextw", "--acc"]
        + _hmmscan_threshold_flags(
            use_model_threshold, threshold_type, use_bitscores,
            seq_threshold, domain_threshold,
        )
        + _performance_flags(cpu, nobias)
        + [database, query]
    )

    # the domain table is what pfam_hits consumes
    _expect_output("hmmscan", "results", stdout, stderr,
                   result.domtblout)
    return result


def _read_hmmer_table(filename, column_names):
    """Parse a HMMER tbl/domtbl file into a DataFrame.

    Whitespace-split with a bounded number of splits so the free-text
    description column survives; types inferred via a CSV round-trip
    in memory.
    """
    num_splits = len(column_names) - 1
    rows = []
    with open(filename) as f:
        for line in f:
            if line.startswith("#"):
                continue
            fields = line.rstrip().split(maxsplit=num_splits)
            if len(fields) == num_splits:
                # HMMER may print an EMPTY description (not "-");
                # pad so the frame build cannot fail on short rows
                fields.append("")
            rows.append(fields)

    buf = io.StringIO()
    pd.DataFrame(rows, columns=column_names).to_csv(buf, index=False)
    buf.seek(0)
    # identifiers literally named "NA"/"None" must stay strings,
    # and empty descriptions stay empty strings
    return pd.read_csv(buf, keep_default_na=False)


# column schemas of HMMER's per-sequence (tblout) and per-domain
# (domtblout) hit tables — the names downstream protocols key on
TBL_COLUMNS = (
    "target_name target_accession query_name query_accession "
    "full_Evalue full_score full_bias "
    "best_domain_Evalue best_domain_score best_domain_bias "
    "domain_exp domain_reg domain_clu domain_ov domain_env "
    "domain_dom domain_rep domain_inc description"
).split()

DOMTBL_COLUMNS = (
    "target_name target_accession target_len "
    "query_name query_accession query_len "
    "full_Evalue full_score full_bias "
    "hit_number total_hit_number "
    "domain_c_Evalue domain_i_Evalue domain_score domain_bias "
    "hmm_from hmm_to ali_from ali_to env_from env_to "
    "acc description"
).split()


def read_hmmer_tbl(filename):
    """HMMER per-sequence hit table (tblout) as DataFrame."""
    return _read_hmmer_table(filename, TBL_COLUMNS)


def read_hmmer_domtbl(filename):
    """HMMER per-domain hit table (domtblout) as DataFrame."""
    return _read_hmmer_table(filename, DOMTBL_COLUMNS)


def run_hhfilter(input_file, output_file, threshold=95, columns="a2m",
                 binary="hhfilter"):
    """Redundancy-filter an alignment with HHsuite hhfilter (output A3M).

    Parity: reference tools.py:616-680.
    """
    if columns not in ("first", "a2m"):
        raise ValueError("Invalid column selection: {}".format(columns))

    verify_resources(
        "Alignment file does not exist or is empty", input_file
    )
    create_prefix_folders(output_file)

    _, stdout, stderr = run([
        binary,
        "-i", input_file,
        "-o", output_file,
        "-id", str(threshold),
        "-M", columns,
        "-v", "2",
    ])

    _expect_output("hhfilter", "alignment", stdout, stderr, output_file)
    return output_file
