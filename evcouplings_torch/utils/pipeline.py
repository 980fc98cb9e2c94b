"""
Pipeline runtime (port of evcouplings_tpu/utils/pipeline.py): stage
sequencing, state chaining, skip/resume, archiving, flag files, and the
command-line entry point

    python -m evcouplings_torch.utils.pipeline <config.yml>

Stage semantics are the JAX package's: each stage's incfg is {tools,
databases, stage config, global state}; stage outputs merge into the
global state; stages absent from the `stages` list reuse a verified
previous outcfg. The optional `device` key (global or stage section;
absent: the CUDA device, "cpu": the host) reaches every numeric call.
With EVCOUPLINGS_TRACE_DIR set, each stage also writes a torch.profiler
trace there (utils/tracing.device_trace).

The monomer table runs all five stages through the port's protocols:
align, couplings, compare, mutate and fold (as in the JAX package, the
mutate stage follows compare and reuses compare's outcfg when compare is
skipped). The protein_complex pipeline raises NotImplementedError naming
ROADMAP A19c.
"""

import os
import signal
import sys
import tarfile
import traceback
import zipfile
from copy import deepcopy
from os import path

import click

from evcouplings_torch import BailoutException
from evcouplings_torch.utils.config import (
    InvalidParameterError,
    check_required,
    iterate_files,
    read_config_file,
    write_config_file,
)
from evcouplings_torch.utils.constants import FINAL_CONFIG_SUFFIX
from evcouplings_torch.utils.system import (
    create_prefix_folders,
    insert_dir,
    valid_file,
    verify_resources,
)
from evcouplings_torch.utils.tracker import EStatus, get_result_tracker
from evcouplings_torch.utils.tracing import (
    clear_spans, device_trace, stage_timer, write_span_table
)

import evcouplings_torch.align.protocol as ap
import evcouplings_torch.compare.protocol as cm
import evcouplings_torch.couplings.protocol as cp
import evcouplings_torch.fold.protocol as fd
import evcouplings_torch.mutate.protocol as mt


# supported pipelines: list of (stage name, runner, output key prefix)
_MONOMER_STAGES = [
    ("align", ap.run, None),
    ("couplings", cp.run, None),
    ("compare", cm.run, None),
    ("mutate", mt.run, None),
    ("fold", fd.run, None),
]

PIPELINES = {
    "protein_monomer": _MONOMER_STAGES,
}


# flag files documenting how the run ended
EXTENSION_TERMINATED = ".terminated"
EXTENSION_FAILED = ".failed"
EXTENSION_BAILOUT = ".bailout"
EXTENSION_DONE = ".done"


def _resolve_pipeline(config):
    """The (stage, runner, key_prefix) list for config["pipeline"],
    rejecting unknown pipeline names."""
    if config["pipeline"] == "protein_complex":
        raise NotImplementedError(
            "the protein_complex pipeline is not ported yet (ROADMAP A19c)")
    try:
        return PIPELINES[config["pipeline"]]
    except KeyError:
        raise InvalidParameterError(
            "Not a valid pipeline selection. "
            "Valid choices are:\n{}".format(", ".join(PIPELINES.keys()))
        ) from None


def _requested_stages(config, pipeline):
    """The validated list of stage names this run should execute."""
    stages = config["stages"]
    if stages is None:
        raise InvalidParameterError("No stages defined, need at least one.")
    if isinstance(stages, str):
        # a bare YAML scalar (stages: align) would otherwise do
        # substring membership and count characters as stages
        stages = [stages]

    known = [name for name, _, _ in pipeline]
    unknown = [s for s in stages if s not in known]
    if unknown:
        raise InvalidParameterError(
            "Unknown stage(s) {} for pipeline '{}'. Valid stages "
            "are: {}".format(
                ", ".join(unknown), config["pipeline"], ", ".join(known)
            )
        )
    return stages


def _require_prefix(global_section):
    prefix = (global_section or {}).get("prefix")
    # an empty `global:` YAML section parses as None — surface the
    # missing prefix as the configuration error it is
    if prefix is None:
        raise InvalidParameterError(
            "Configuration does not include 'prefix' setting in "
            "'global' section"
        )
    return prefix


def _execute_stage(config, stage, runner, key_prefix, global_state,
                   stage_prefix, incfg_file, outcfg_file):
    """Run one stage fresh: compose its input config (global state
    last — it overrides stage settings), persist incfg/outcfg, and
    return the stage's (possibly key-prefixed) outputs."""
    # empty YAML sections parse as None — treat them as {} instead of
    # crashing the unpack with a TypeError
    incfg = {
        **(config["tools"] or {}),
        **(config["databases"] or {}),
        **(config[stage] or {}),
        **global_state,
        "prefix": stage_prefix,
    }
    write_config_file(incfg_file, incfg)

    with stage_timer(stage), device_trace(name=stage):
        outcfg = runner(**incfg)

    # avoid key collisions when a stage runs twice (complexes)
    if key_prefix is not None:
        outcfg = {key_prefix + k: v for k, v in outcfg.items()}

    write_config_file(outcfg_file, outcfg)
    return outcfg


def _reuse_stage(stage, outcfg_file):
    """Skipped stage: load its previous outputs, verifying the outcfg
    and every *_file product still exist."""
    verify_resources(
        "Trying to skip, but output configuration "
        "for stage '{}' does not exist. Has it already "
        "been run?".format(stage),
        outcfg_file,
    )
    outcfg = read_config_file(outcfg_file)

    products = [
        location for key, location in outcfg.items()
        if key.endswith("_file") and location is not None
    ]
    verify_resources(
        "Output files from stage '{}' missing".format(stage),
        *products,
    )
    return outcfg


def execute(**config):
    """Execute a pipeline configuration; returns the final global
    output state."""
    check_required(config, ["pipeline", "stages", "global"])

    pipeline = _resolve_pipeline(config)
    stages = _requested_stages(config, pipeline)

    prefix = _require_prefix(config["global"])
    create_prefix_folders(prefix)

    # fresh span registry per job (several jobs may share a process)
    clear_spans()

    # results accumulated while moving through the stages
    global_state = config["global"] or {}
    remaining = len(stages)

    tracker = get_result_tracker(config)
    tracker.update(status=EStatus.RUN, results=global_state)

    for stage, runner, key_prefix in pipeline:
        # everything requested has run; trailing stages are skipped
        if remaining == 0:
            break

        check_required(config, [stage])

        # each stage writes into its own subdirectory
        stage_prefix = insert_dir(prefix, stage)
        create_prefix_folders(stage_prefix)
        incfg_file = "{}_{}.incfg".format(stage_prefix, stage)
        outcfg_file = "{}_{}.outcfg".format(stage_prefix, stage)

        tracker.update(stage=stage)

        if stage in stages:
            outcfg = _execute_stage(
                config, stage, runner, key_prefix, global_state,
                stage_prefix, incfg_file, outcfg_file,
            )
            remaining -= 1
        else:
            outcfg = _reuse_stage(stage, outcfg_file)

        global_state = {**global_state, **outcfg}
        tracker.update(results=outcfg)

    archive_file = create_archive(config, global_state, prefix)
    if archive_file is not None:
        global_state["archive_file"] = archive_file

    global_state = delete_outputs(config, global_state)

    # per-stage wall-clock table (spans collected by
    # utils.tracing.stage_timer around each runner)
    runtime_file = write_span_table(prefix + "_runtime.csv")
    if runtime_file is not None:
        global_state["runtime_file"] = runtime_file

    write_config_file(prefix + FINAL_CONFIG_SUFFIX, global_state)

    # DONE is recorded LAST (reference ordering): a tracker consumer
    # observing DONE can rely on the final outcfg existing and the
    # archive/delete cleanup having completed; the late-added keys
    # ride along so the tracker's results match the final outcfg
    late_keys = {
        k: global_state[k]
        for k in ("archive_file", "runtime_file") if k in global_state
    }
    tracker.update(status=EStatus.DONE, results=late_keys or None)
    return global_state


def _write_targz(archive_file, members):
    with tarfile.open(archive_file, "w:gz") as bundle:
        for member in members:
            bundle.add(member)


def _write_zip(archive_file, members):
    with zipfile.ZipFile(
        archive_file, "w", zipfile.ZIP_DEFLATED
    ) as bundle:
        for member in members:
            bundle.write(member)


# archive_format -> (file suffix, writer)
_ARCHIVE_FORMATS = {
    "targz": (".tar.gz", _write_targz),
    "zip": (".zip", _write_zip),
}


def create_archive(config, outcfg, prefix):
    """Archive the output files selected by management.archive into
    prefix.tar.gz (default) or prefix.zip."""
    management = config.get("management") or {}
    archive_keys = management.get("archive", None)
    if archive_keys is None:
        return None

    archive_format = management.get("archive_format", "targz")
    if archive_format not in _ARCHIVE_FORMATS:
        raise InvalidParameterError(
            "Invalid format for output archive: {}. ".format(archive_format)
            + "Valid options are: " + ", ".join(_ARCHIVE_FORMATS)
        )

    members = [
        location
        for location, _, _ in iterate_files(outcfg, subset=archive_keys)
        if valid_file(location)
    ]
    if not members:
        return None

    suffix, writer = _ARCHIVE_FORMATS[archive_format]
    archive_file = prefix + suffix
    writer(archive_file, members)
    return archive_file


def delete_outputs(config, outcfg):
    """Delete output files selected by management.delete; returns the
    cleaned output state."""
    delete_keys = (config.get("management") or {}).get("delete", None)
    if delete_keys is None:
        return outcfg

    survivors = deepcopy(outcfg)
    for location, key, _ in iterate_files(outcfg, subset=delete_keys):
        try:
            os.remove(location)
        except OSError:
            pass
        survivors.pop(key, None)

    return survivors


def verify_prefix(verify_subdir=True, **config):
    """Check that the configured prefix is present and writable."""
    try:
        prefix = config["global"]["prefix"]
    except (KeyError, TypeError):
        # TypeError: an empty `global:` YAML section parses as None
        raise InvalidParameterError(
            "Configuration does not include 'prefix' setting in "
            "'global' section"
        )

    if prefix is None:
        raise InvalidParameterError(
            "'prefix' must be specified and cannot be None"
        )

    try:
        create_prefix_folders(prefix)

        # probe writability of the prefix directory itself...
        probe = prefix + ".test__"
        with open(probe, "w"):
            pass
        os.remove(probe)

        # ...and, for pipelines, of a freshly created stage subdirectory
        if verify_subdir:
            sub_prefix = insert_dir(prefix, "test__")
            create_prefix_folders(sub_prefix)
            os.rmdir(path.dirname(sub_prefix))
    except OSError as e:
        raise InvalidParameterError(
            "Not a valid prefix: {}".format(prefix)
        ) from e

    return prefix


def _clear_flag_files(prefix):
    """Remove flag files left behind by previous executions."""
    for ext in (
        EXTENSION_FAILED, EXTENSION_TERMINATED,
        EXTENSION_DONE, EXTENSION_BAILOUT,
    ):
        try:
            os.remove(prefix + ext)
        except OSError:
            pass


def _write_flag(prefix, extension, content):
    with open(prefix + extension, "w") as handle:
        handle.write(content)


def execute_wrapped(**config):
    """Execute a pipeline with signal/exception handling documented via
    flag files (.done/.failed/.terminated/.bailout) and the tracker."""
    tracker = get_result_tracker(config)

    try:
        prefix = verify_prefix(**config)
    except Exception:
        tracker.update(
            status=EStatus.FAIL,
            message="Invalid prefix: {}".format(traceback.format_exc()),
        )
        raise

    _clear_flag_files(prefix)

    def _handler(signal_, frame):
        _write_flag(
            prefix, EXTENSION_TERMINATED,
            "SIGNAL: {}\n".format(signal_),
        )
        tracker.update(
            status=EStatus.TERM,
            message="Terminated with signal: {}\n".format(signal_),
        )
        sys.exit(1)

    # handlers are restored on the way out: several jobs may share one
    # process, and a signal arriving BETWEEN jobs must not write this
    # (finished) job's .terminated flag or flip its tracker row
    handled = [
        signal.SIGINT, signal.SIGTERM, signal.SIGUSR1, signal.SIGUSR2
    ]
    previous = {sig: signal.getsignal(sig) for sig in handled}
    for sig in handled:
        signal.signal(sig, _handler)

    try:
        outcfg = execute(**config)
        _write_flag(prefix, EXTENSION_DONE, repr(outcfg))
        return outcfg

    except Exception as e:
        trace_text = traceback.format_exc()

        # a deliberate pipeline bailout gets its own flag file and
        # tracker status; everything else is a crash
        bailed = isinstance(e, BailoutException)
        extension, status, what = (
            (EXTENSION_BAILOUT, EStatus.BAILOUT,
             "Pipeline bailed out of execution")
            if bailed else
            (EXTENSION_FAILED, EStatus.FAIL,
             "Crashed during job execution")
        )

        _write_flag(prefix, extension, trace_text)
        tracker.update(
            status=status,
            message="{}: {}".format(what, trace_text),
        )
        raise
    finally:
        for sig, old in previous.items():
            signal.signal(sig, old)


def run(**kwargs):
    """Run a pipeline from a configuration file (single process)."""
    config_file = kwargs["config"]
    verify_resources(
        "Config file does not exist or is empty.", config_file
    )

    config = read_config_file(config_file)
    return execute_wrapped(**config)


CONTEXT_SETTINGS = dict(help_option_names=["-h", "--help"])


@click.command(context_settings=CONTEXT_SETTINGS)
@click.argument("config")
def app(**kwargs):
    """Execute a pipeline job configuration file with the port
    (python -m evcouplings_torch.utils.pipeline <config>)."""
    outcfg = run(**kwargs)
    print(outcfg)


if __name__ == "__main__":
    app()
