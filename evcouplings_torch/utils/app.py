"""
`evcouplings_torch` command-line application (port of
evcouplings_tpu/utils/app.py): config substitution from CLI flags, batch
unrolling into sub-jobs, and job submission. Each sub-job runs the
port's pipeline (`evcouplings_torch_runcfg`, or
`python -m evcouplings_torch.utils.pipeline`) and then the port's
summarizer, never a script or module of the JAX package.

Parity target of the JAX module: reference evcouplings/utils/app.py —
substitute_config (:41-184), unroll_config (:186-245), run_jobs
(:248-450), run (:453-486), click CLI (:492-563).
"""

import os
import re
import shlex
import shutil
import sys
from collections.abc import Mapping
from copy import deepcopy
from os import environ, path

import click

from evcouplings_torch import utils
from evcouplings_torch.utils import pipeline
from evcouplings_torch.utils.config import (
    InvalidParameterError,
    check_required,
    read_config_file,
    write_config_file,
)
from evcouplings_torch.utils.system import (
    ResourceError,
    create_prefix_folders,
    valid_file,
)
from evcouplings_torch.utils.tracker import EStatus, get_result_tracker

# individual job config files are stored under this name
CONFIG_NAME = "{}_config.txt"


def resolve_app_commands():
    """Resolve the (runcfg, summarize) command strings for sub-jobs.

    Explicit EVCOUPLINGS_RUNCFG_APP / EVCOUPLINGS_SUMMARIZE_APP env
    vars win; otherwise the port's console scripts
    (evcouplings_torch_runcfg, evcouplings_torch_summarize) when they
    live beside this interpreter, else `python -m` execution of the
    port's modules, so batch runs also work from a plain source
    checkout. The JAX package's scripts (evcouplings_runcfg,
    evcouplings_summarize) are never looked up: a sub-job that ran them
    would succeed without touching the card.
    """
    python = shlex.quote(sys.executable)

    def _own_script(name):
        # only trust a console script living next to THIS interpreter:
        # a foreign environment earlier on PATH could carry another
        # version of the port
        found = shutil.which(name)
        if found and os.path.dirname(os.path.abspath(found)) == \
                os.path.dirname(os.path.abspath(sys.executable)):
            return name
        return None

    cmd_base = environ.get("EVCOUPLINGS_RUNCFG_APP") or (
        _own_script("evcouplings_torch_runcfg")
        or "{} -m evcouplings_torch.utils.pipeline".format(python)
    )
    summ_base = environ.get("EVCOUPLINGS_SUMMARIZE_APP") or (
        _own_script("evcouplings_torch_summarize")
        or "{} -m evcouplings_torch.utils.summarize".format(python)
    )
    if ("-m evcouplings_torch" in cmd_base
            or "-m evcouplings_torch" in summ_base):
        # `python -m` sub-jobs run via shell with cwd=workdir, so the
        # package must be importable in the child even from a plain
        # source checkout launched elsewhere — export the package's
        # parent directory on PYTHONPATH for everything we submit
        import evcouplings_torch
        pkg_parent = os.path.dirname(
            os.path.dirname(os.path.abspath(evcouplings_torch.__file__))
        )
        current = environ.get("PYTHONPATH", "")
        if pkg_parent not in current.split(os.pathsep):
            environ["PYTHONPATH"] = (
                pkg_parent + (os.pathsep + current if current else "")
            )
    return cmd_base, summ_base


# one-to-one CLI flag -> (config section, option) substitutions
_FLAG_TO_CONFIG = (
    ("prefix", "global", "prefix"),
    ("protein", "global", "sequence_id"),
    ("seqfile", "global", "sequence_file"),
    ("theta", "global", "theta"),
    ("alignment", "align", "input_alignment"),
    ("iterations", "align", "iterations"),
    ("id", "align", "seqid_filter"),
    ("seqcov", "align", "minimum_sequence_coverage"),
    ("colcov", "align", "minimum_column_coverage"),
    ("plmiter", "couplings", "iterations"),
    ("queue", "environment", "queue"),
    ("time", "environment", "time"),
    ("cores", "environment", "cores"),
    ("memory", "environment", "memory"),
)


def _numeric_list(raw, what):
    """Comma-separated number list; entries without a '.' stay int."""
    out = []
    for token in raw.replace(" ", "").split(","):
        try:
            out.append(float(token) if "." in token else int(token))
        except ValueError:
            raise InvalidParameterError(
                "{} threshold(s) must be numeric: {}".format(what, raw)
            )
    return out


def substitute_config(**kwargs):
    """Substitute command-line flags into the run configuration."""
    config_file = kwargs["config"]
    if not valid_file(config_file):
        raise ResourceError(
            "Config file does not exist or is empty: {}".format(
                config_file
            )
        )

    config = read_config_file(config_file, preserve_order=True)

    def _section(name):
        # absent or empty YAML sections (parse as None) become dicts
        # so flag substitution cannot crash with KeyError/TypeError
        if config.get(name) is None:
            config[name] = {}
        return config[name]

    for flag, section, option in _FLAG_TO_CONFIG:
        if kwargs.get(flag) is not None:
            _section(section)[option] = kwargs[flag]

    # per-job CPU budget tracks the environment core request
    if _section("environment").get("cores") is not None:
        _section("global")["cpu"] = config["environment"]["cores"]

    # a user-supplied alignment implies the "existing" align protocol
    if kwargs.get("alignment") is not None:
        config["align"]["protocol"] = "existing"

    # subregion of the protein, as a "start-end" string
    region = kwargs.get("region")
    if region is not None:
        bounds = re.fullmatch(r"(\d+)-(\d+)", region.strip())
        if bounds is None:
            raise InvalidParameterError(
                "Region string does not have format "
                "start-end (e.g. 5-123): {}".format(region)
            )
        start, end = int(bounds.group(1)), int(bounds.group(2))
        if start > end:
            raise InvalidParameterError(
                "Region start must not exceed end: {}".format(region)
            )
        config["global"]["region"] = [start, end]

    # pipeline stages to run
    if kwargs.get("stages") is not None:
        config["stages"] = kwargs["stages"].replace(" ", "").split(",")

    # sequence search database: a predefined name, or a path that
    # registers as the "custom" database
    db = kwargs.get("database")
    if db is not None:
        if db in config["databases"]:
            config["align"]["database"] = db
        else:
            config["databases"]["custom"] = db
            config["align"]["database"] = "custom"

    # alignment search depth: bitscore XOR E-value threshold(s); more
    # than one value expands into a batch sweep over the thresholds
    if (kwargs.get("bitscores") is not None
            and kwargs.get("evalues") is not None):
        raise InvalidParameterError(
            "Can not specify bitscore and E-value threshold at the "
            "same time."
        )

    for flag, is_bitscore in (("bitscores", True), ("evalues", False)):
        raw = kwargs.get(flag)
        if raw is None:
            continue
        values = _numeric_list(raw, "Bitscore/E-value")
        config["align"]["use_bitscores"] = is_bitscore

        if len(values) == 1:
            config["align"]["domain_threshold"] = values[0]
            config["align"]["sequence_threshold"] = values[0]
        else:
            tag = "_b" if is_bitscore else "_e"
            config["batch"] = {
                tag + str(v): {
                    "align": {
                        "domain_threshold": v,
                        "sequence_threshold": v,
                    },
                }
                for v in values
            }

    return config


def unroll_config(config):
    """Expand the batch section into individual job configurations.

    Returns {sub-prefix: config}; without a batch section, a single
    entry for the master run.
    """
    prefix = config["global"]["prefix"]
    if config.get("batch", None) is None:
        return {prefix: config}

    configs = {}
    for sub_id, delta_config in config["batch"].items():
        sub_config = deepcopy(config)
        sub_config["batch"] = None
        sub_config["global"]["prefix"] = prefix + sub_id

        # each sub-job needs its OWN tracker identity: a shared
        # job_id would collapse the whole sweep onto one DB row
        # (sql.py declares job_id UNIQUE), last writer winning
        mgmt = sub_config.get("management")
        if isinstance(mgmt, Mapping) and mgmt.get("job_id"):
            mgmt["job_id"] = "{}{}".format(mgmt["job_id"], sub_id)

        # apply the per-subjob config delta (two nesting levels:
        # mapping sections merge per-key, scalars replace wholesale)
        for section, delta in delta_config.items():
            if isinstance(delta, Mapping):
                current = sub_config.get(section)
                if current is None:
                    # absent / empty-YAML section
                    sub_config[section] = dict(delta)
                elif isinstance(current, Mapping):
                    current.update(delta)
                else:
                    raise InvalidParameterError(
                        "Batch delta for section {!r} is a mapping "
                        "but the config value is {!r}".format(
                            section, current
                        )
                    )
            else:
                sub_config[section] = delta

        configs[prefix + sub_id] = sub_config

    return configs


def run_jobs(configs, global_config, overwrite=False, workdir=None,
             abort_on_error=True, environment=None):
    """Write job config files and submit each sub-job (runcfg +
    summarizer) via the configured engine; returns {prefix: job id}."""
    cmd_base, summ_base = resolve_app_commands()

    prefix = global_config["global"]["prefix"]

    out_prefix = (
        path.join(workdir, prefix) if workdir is not None else prefix
    )

    # overwrite protection: a previous config file means results exist
    cfg_filename = CONFIG_NAME.format(out_prefix)
    if not overwrite and valid_file(cfg_filename):
        raise InvalidParameterError(
            "Existing configuration file {} ".format(cfg_filename)
            + "indicates current prefix {} ".format(prefix)
            + "would overwrite existing results. Use --yolo "
            + "flag to deactivate overwrite protection (e.g. for "
            "restarting a job or running a different stage)."
        )

    create_prefix_folders(cfg_filename)
    write_config_file(cfg_filename, global_config)

    # write sub-job configs up front (the summarizer needs all paths)
    for subjob_prefix, subjob_cfg in configs.items():
        subjob_out_prefix = (
            path.join(workdir, subjob_prefix)
            if workdir is not None else subjob_prefix
        )
        subcfg_filename = CONFIG_NAME.format(subjob_out_prefix)
        create_prefix_folders(subcfg_filename)
        write_config_file(subcfg_filename, subjob_cfg)

    config_files = [
        CONFIG_NAME.format(subjob_prefix) for subjob_prefix in configs
    ]

    # all interpolated paths are shell-quoted: prefixes with spaces
    # or shell metacharacters must survive the shell=True submitters
    summ_cmd = "{} {} {} {}".format(
        summ_base,
        shlex.quote(str(global_config["pipeline"])),
        shlex.quote(global_config["global"]["prefix"]),
        " ".join(shlex.quote(c) for c in config_files),
    )

    submitter_cfg = global_config["environment"]
    submitter_engine = submitter_cfg["engine"]
    submitter_cores = submitter_cfg.get("cores")

    # local engine: bound the number of concurrently running sub-jobs
    submitter_kws = {}
    if submitter_engine == "local" and submitter_cores is not None:
        max_parallel_workers = submitter_cfg.get("parallel_workers")
        if max_parallel_workers is None:
            max_cores = os.cpu_count() or 1
            max_parallel_workers = max(
                1, int(max_cores / submitter_cores)
            )
        submitter_kws = {
            "ncpu": min(len(configs), max_parallel_workers)
        }
    if (submitter_engine == "local"
            and submitter_cfg.get("max_retries")):
        # automatic resubmission of failed sub-jobs (beyond-reference)
        submitter_kws["max_retries"] = int(
            submitter_cfg["max_retries"])

    submitter = utils.SubmitterFactory(
        submitter_engine,
        db_path=out_prefix + "_job_database.txt",
        **submitter_kws,
    )

    job_ids = {}
    submitted = {}

    for job, job_cfg in configs.items():
        job_prefix = job_cfg["global"]["prefix"]
        job_cfg_file = CONFIG_NAME.format(job)

        env = job_cfg["environment"]
        cmd = utils.batch.Command(
            [
                "{} {}".format(cmd_base, shlex.quote(job_cfg_file)),
                summ_cmd,
            ],
            name=job_prefix,
            environment=(
                env["configuration"] if environment is None
                else environment
            ),
            workdir=workdir,
            resources={
                utils.batch.EResource.queue: env["queue"],
                utils.batch.EResource.time: env["time"],
                utils.batch.EResource.mem: env["memory"],
                utils.batch.EResource.nodes: env["cores"],
                utils.batch.EResource.out: job_prefix + "_stdout.log",
                utils.batch.EResource.error: job_prefix + "_stderr.log",
            },
        )

        tracker = get_result_tracker(job_cfg)

        # PEND is written BEFORE submit: a fast local job may write
        # RUN/DONE/FAIL immediately, and a late parent PEND would
        # regress the record
        tracker.update(status=EStatus.PEND)
        try:
            job_ids[job] = submitter.submit(cmd)
            submitted[job] = cmd
        except RuntimeError as e:
            tracker.update(status=EStatus.FAIL, message=str(e))
            if abort_on_error:
                raise

    # wait for all runs to finish (blocking submitters only)
    submitter.join()

    if submitter.isBlocking and submitted:
        # surface failed sub-jobs: a batch sweep with crashed members
        # must not report success (exit code 0) to wrapping scripts
        failed = [
            job for job, cmd in submitted.items()
            if submitter.monitor(cmd) == utils.batch.EStatus.EXIT
        ]
        if failed:
            message = "{} of {} sub-job(s) failed: {}".format(
                len(failed), len(submitted), ", ".join(failed)
            )
            if abort_on_error:
                raise RuntimeError(message)
            import warnings

            warnings.warn(message, RuntimeWarning)

    return job_ids


def run(**kwargs):
    """Python entry point of the CLI (flags as keyword arguments)."""
    config = substitute_config(**kwargs)

    check_required(config, ["pipeline", "stages", "global"])
    pipeline.verify_prefix(verify_subdir=False, **config)

    # convenience: compute N_eff when alignment runs without couplings
    if ("align" in config["stages"]
            and "couplings" not in config["stages"]):
        config["align"]["compute_num_effective_seqs"] = True

    sub_configs = unroll_config(config)

    run_jobs(
        sub_configs, config, kwargs.get("yolo", False),
        kwargs.get("workdir", None),
    )


CONTEXT_SETTINGS = dict(help_option_names=["-h", "--help"])


@click.command(context_settings=CONTEXT_SETTINGS)
@click.argument("config")
@click.option("-P", "--prefix", default=None, help="Job prefix")
@click.option(
    "-S", "--stages", default=None,
    help="Stages of pipeline to run (comma-separated)",
)
@click.option(
    "-p", "--protein", default=None,
    help="Sequence identifier of query protein",
)
@click.option(
    "-s", "--seqfile", default=None,
    help="FASTA file with query sequence",
)
@click.option(
    "-a", "--alignment", default=None,
    help="Existing sequence alignment to start from (aligned "
         "FASTA/Stockholm). Use -p to select target sequence.",
)
@click.option(
    "-r", "--region", default=None,
    help="Region of query sequence (e.g 25-341)",
)
@click.option(
    "-b", "--bitscores", default=None,
    help="List of alignment bitscores (comma-separated, "
         "length-normalized (float) or absolute score (int))",
)
@click.option(
    "-e", "--evalues", default=None,
    help="List of alignment E-values (negative exponent, "
         "comma-separated)",
)
@click.option(
    "-n", "--iterations", default=None,
    help="Number of alignment iterations", type=int,
)
@click.option(
    "-d", "--database", default=None,
    help="Path or name of sequence database",
)
@click.option(
    "-i", "--id", default=None,
    help="Filter alignment at x% sequence identity", type=int,
)
@click.option(
    "-f", "--seqcov", default=None,
    help="Minimum % aligned positions per sequence", type=int,
)
@click.option(
    "-m", "--colcov", default=None,
    help="Minimum % aligned positions per column", type=int,
)
@click.option(
    "-t", "--theta", default=None,
    help="Downweight sequences above this identity cutoff during "
         "inference (e.g. 0.8 for 80% identity cutoff)",
    type=float,
)
@click.option(
    "--plmiter", default=None,
    help="Maximum number of iterations during inference", type=int,
)
@click.option(
    "-Q", "--queue", default=None, help="Grid queue to run job(s)"
)
@click.option(
    "-T", "--time", default=None,
    help="Time requirement (hours) for batch jobs", type=int,
)
@click.option(
    "-N", "--cores", default=None,
    help="Number of cores for batch jobs", type=int,
)
@click.option(
    "-M", "--memory", default=None,
    help="Memory requirement for batch jobs (MB or 'auto')",
)
@click.option(
    "-y", "--yolo", default=False, is_flag=True,
    help="Disable overwrite protection",
)
def app(**kwargs):
    """EVcouplings command line interface.

    Command line options overwrite the corresponding config settings;
    a list of bitscores or E-values creates one job per threshold.
    """
    run(**kwargs)


if __name__ == "__main__":
    app()
