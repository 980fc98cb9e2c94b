"""
Job submission engines: local thread-pool execution with dependency
tracking, and LSF / Slurm / SGE cluster submitters.

Port of evcouplings_tpu/utils/batch.py; its parity target: reference
evcouplings/utils/batch.py — Command (:56),
APluginRegister (:108), ASubmitter (:134), AClusterSubmitter (:227),
LSFSubmitter (:456), SlurmSubmitter (:580), SGESubmitter (:703),
LocalSubmitter (:1147). The cluster command templates (bsub/sbatch/
qsub etc.) match the reference; the local engine replaces the
reference's billiard broker/worker process pool with a dependency-
aware thread pool over subprocesses (same public API, no extra
dependencies, and statuses map correctly).
"""

import abc
import inspect
import os
import re
import signal
import subprocess
import threading
import uuid
from tempfile import NamedTemporaryFile

import yaml

from evcouplings_torch.utils.helpers import PersistentDict


class EStatus:
    """Job status values used by submitters."""
    RUN = "run"
    PEND = "pend"
    SUSP = "susp"
    EXIT = "exit"
    DONE = "done"


class EJob:
    """Internal job-control message types (reference utils/batch.py:
    47-53). The local engine here is thread-pool based rather than a
    broker/worker message loop, so these are provided for API
    compatibility with code written against the reference."""
    SUBMIT = 0
    MONITOR = 1
    CANCEL = 2
    STOP = 3
    UPDATE = 4
    PID = 5


class EResource:
    """Resource keys understood by cluster submitters."""
    time = "time"
    mem = "mem"
    nodes = "nodes"
    queue = "queue"
    error = "error"
    out = "done"


class Command:
    """A shell command (plus environment setup, workdir, resources) to
    be executed by a submitter."""

    def __init__(self, command, name=None, environment=None,
                 workdir=None, resources=None):
        self.command_id = "c" + str(uuid.uuid4())
        self.name = name

        self.command = [command] if isinstance(command, str) else command
        if environment is None:
            self.environment = []
        else:
            self.environment = (
                [environment] if isinstance(environment, str)
                else environment
            )
        self.workdir = workdir
        self.resources = resources

    def __eq__(self, other):
        if not isinstance(other, Command):
            return False
        return self.command_id == other.command_id

    def __str__(self):
        return "Command:{id}:\n\t{commands}".format(
            id=self.command_id, commands="&".join(self.command)[:16]
        )

    def __repr__(self):
        return "Command({id})".format(id=self.command_id)

    def __hash__(self):
        return hash(self.command_id)

    def full_command_string(self):
        """Environment setup + commands joined into one shell line."""
        combine = " && " if self.environment else ""
        return (
            " && ".join(self.environment) + combine
            + " && ".join(self.command)
        )


class APluginRegister(abc.ABCMeta):
    """Metaclass auto-registering concrete submitter plugins by name."""

    def __init__(cls, name, bases, nmspc):
        super().__init__(name, bases, nmspc)
        if not hasattr(cls, "registry"):
            cls.registry = dict()
        if not inspect.isabstract(cls):
            # use the class-level registry name rather than
            # instantiating the class (the reference's cls().name
            # creates side effects like temp job-db files at import)
            registry_name = nmspc.get("_registry_name")
            if registry_name is None:
                registry_name = str(cls().name)
            cls.registry[registry_name.lower()] = cls

    def __getitem__(cls, name):
        return cls.registry[name]

    def __iter__(cls):
        return iter(cls.registry.values())

    def __str__(cls):
        if cls in cls.registry:
            return cls.__name__
        return cls.__name__ + ": " + ", ".join(
            sc.__name__ for sc in cls
        )


class ASubmitter(metaclass=APluginRegister):
    """Interface all submitters implement."""

    @property
    @abc.abstractmethod
    def isBlocking(self):
        """Whether join() blocks until all jobs finished."""
        raise NotImplementedError

    @property
    @abc.abstractmethod
    def name(self):
        """Registry name of the submitter."""
        raise NotImplementedError

    @abc.abstractmethod
    def submit(self, command, dependent=None):
        """Submit a Command (optionally after dependencies); returns a
        job id."""
        raise NotImplementedError

    @abc.abstractmethod
    def cancel(self, command):
        """Cancel a previously submitted command."""
        raise NotImplementedError

    @abc.abstractmethod
    def monitor(self, command):
        """Return the EStatus of a previously submitted command."""
        raise NotImplementedError

    @abc.abstractmethod
    def join(self):
        """Block until all submitted jobs finished (if blocking)."""
        raise NotImplementedError


def _run_shell(cmd, workdir=None):
    """Run a shell command, returning (returncode, stdout, stderr).

    OS-level launch failures (missing workdir, unlaunchable shell)
    surface as RuntimeError — the same contract callers already handle
    for non-zero scheduler exits — instead of leaking raw OSErrors
    past app.py's per-job error handling."""
    try:
        p = subprocess.Popen(
            cmd, shell=True,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, universal_newlines=True,
            cwd=workdir,
        )
        stdo, stde = p.communicate()
    except OSError as e:
        raise RuntimeError(
            "Could not launch {!r} (workdir={!r}): {}".format(
                cmd, workdir, e
            )
        ) from e
    return p.returncode, stdo, stde


def _open_job_db(db_path):
    """(PersistentDict, path, is_temp) for a submitter job database;
    a None path creates a throwaway file in the working directory."""
    if db_path is None:
        tmp_db = NamedTemporaryFile(
            delete=False, dir=os.getcwd(), suffix=".db"
        )
        tmp_db.close()
        return PersistentDict(tmp_db.name), tmp_db.name, True
    return PersistentDict(db_path), db_path, False


def _close_job_db(db, db_path, is_temp):
    try:
        db.close()
        if is_temp:
            os.remove(db_path)
    except (AttributeError, OSError, TypeError):
        # TypeError: module globals (os/tempfile helpers inside
        # PersistentDict.sync) may already be torn down when the
        # interpreter exits and __del__ fires during shutdown
        pass


class AClusterSubmitter(ASubmitter):
    """Shared logic for schedulers driven by shell commands (bsub /
    sbatch / qsub): submit/monitor/cancel templates + a persistent
    job database."""

    @property
    @abc.abstractmethod
    def submit_command(self):
        """Shell template that enqueues a job (e.g. "bsub ...")."""

    @property
    @abc.abstractmethod
    def monitor_command(self):
        """Shell template that queries a job's scheduler status."""

    @property
    @abc.abstractmethod
    def cancel_command(self):
        """Shell template that removes a job from the queue."""

    @property
    @abc.abstractmethod
    def resource_flags(self):
        """EResource -> scheduler flag mapping for _prepare_resources."""

    @property
    @abc.abstractmethod
    def db(self):
        """Persistent command_id -> submission-record store (shelve)."""

    @property
    @abc.abstractmethod
    def job_id_pattern(self):
        """Compiled regex capturing the job id in submit output."""

    def _get_job_id(self, output):
        m = self.job_id_pattern.search(output)
        if m is None:
            raise RuntimeError(
                "Could not parse job id from scheduler output: "
                "{}".format(output)
            )
        return m.group(1)

    @abc.abstractmethod
    def _get_status(self, stdo):
        """Parse monitor_command output into an EStatus value."""

    @abc.abstractmethod
    def _prepare_resources(self, resources):
        """Render a resource dict into scheduler CLI flags."""

    @abc.abstractmethod
    def _prepare_dependencies(self, dependent):
        """Render prerequisite job ids into dependency CLI flags."""

    # -- job database ----------------------------------------------------

    def _db_get(self, command_id):
        return yaml.safe_load(self.db[command_id])

    def _db_set(self, command_id, entry):
        self.db[command_id] = yaml.safe_dump(entry)
        self.db.sync()

    def _record_submission(self, command, job_id):
        try:
            entry = self._db_get(command.command_id)
            entry["tries"] += 1
        except KeyError:
            entry = {"tries": 1}

        entry.update({
            "name": command.name,
            "job_id": job_id,
            "status": EStatus.PEND,
            "command": command.command,
            "resources": command.resources,
            "workdir": command.workdir,
            "environment": command.environment,
        })
        self._db_set(command.command_id, entry)
        # join() polls only this session's submissions (the shared
        # persistent db may hold prior runs' entries)
        if not hasattr(self, "_session_ids"):
            self._session_ids = []
        if command.command_id not in self._session_ids:
            self._session_ids.append(command.command_id)

    # -- operations ------------------------------------------------------

    def submit(self, command, dependent=None):
        dep = self._prepare_dependencies(dependent)
        resources = self._prepare_resources(command.resources or {})

        # every template single-quotes {cmd}; escape embedded single
        # quotes so an apostrophe in a path or environment line cannot
        # terminate the quoting early (shell=True interpolation)
        safe_cmd = command.full_command_string().replace(
            "'", "'\"'\"'"
        )
        submit = self.submit_command.format(
            cmd=safe_cmd,
            resources=resources,
            dependent=dep,
            name=command.command_id,
        )

        returncode, stdo, stde = _run_shell(submit, command.workdir)
        if returncode != 0:
            raise RuntimeError(
                "Unsuccessful execution of " + repr(command)
                + " (EXIT!=0) with error: " + stde
            )

        job_id = self._get_job_id(stdo)
        self._record_submission(command, job_id)
        return job_id

    def monitor(self, command):
        return self._internal_monitor(command.command_id)

    # scheduler replies meaning "the job is no longer known" — LSF
    # purges finished jobs after CLEAN_PERIOD, Slurm after MinJobAge —
    # which is completion, not a monitoring failure
    _GONE_MARKERS = (
        "is not found", "not found", "invalid job id",
        "has already finished", "unknown job", "no unfinished job",
    )

    def _internal_monitor(self, command_id):
        try:
            entry = self._db_get(command_id)
        except KeyError:
            raise ValueError(
                "Command " + repr(command_id)
                + " has not been submitted yet."
            )
        job_id = entry["job_id"]

        cmd = self.monitor_command.format(job_id=job_id)
        returncode, stdo, stde = _run_shell(cmd)
        if returncode != 0:
            reply = (stdo + stde).lower()
            if any(tok in reply for tok in self._GONE_MARKERS):
                # a completed job aged out of the scheduler's view:
                # same semantics as the SGE monitor's missing row
                status = EStatus.DONE
            else:
                raise RuntimeError(
                    "Unsuccessful monitoring of " + repr(command_id)
                    + " (EXIT!=0) with error: " + stde
                )
        else:
            status = self._get_status(stdo)

        entry["status"] = status
        self._db_set(command_id, entry)
        return status

    def cancel(self, command):
        try:
            self._db_get(command.command_id)
        except KeyError:
            raise ValueError(
                "Command " + repr(command)
                + " has not been submitted yet."
            )

        # refresh first: the stored status may be stale (the job can
        # have finished since the last monitor), and cancelling a
        # finished job would raise on the scheduler error
        status = self._internal_monitor(command.command_id)
        if status in (EStatus.DONE, EStatus.EXIT):
            return True

        entry = self._db_get(command.command_id)
        cmd = self.cancel_command.format(job_id=entry["job_id"])
        returncode, stdo, stde = _run_shell(cmd)
        if returncode != 0:
            reply = (stdo + stde).lower()
            if not any(tok in reply for tok in self._GONE_MARKERS):
                raise RuntimeError(
                    "Unsuccessful cancellation of " + repr(command)
                    + " (EXIT!=0) with error: " + stde
                )

        entry["status"] = EStatus.EXIT
        self._db_set(command.command_id, entry)
        return True

    def join(self):
        import time

        if not self.isBlocking:
            return

        # only jobs submitted through THIS submitter instance: the
        # persistent db may carry entries from previous runs sharing
        # the same db_path, whose purged job ids must not be polled
        # (rerunning a prefix would crash or wait on recycled ids)
        unfinished = list(getattr(self, "_session_ids", []) or [])
        while unfinished:
            unfinished = [
                k for k in unfinished
                if self._internal_monitor(k)
                in (EStatus.PEND, EStatus.RUN, EStatus.SUSP)
            ]
            if unfinished:
                time.sleep(1)


class _ClusterSubmitterBase(AClusterSubmitter):
    """Shared constructor/state for the concrete cluster submitters;
    the template/regex accessors read the per-class attributes, so a
    concrete submitter only declares _registry_name, _submit,
    _monitor, _cancel, _resources_flag, and _job_id_re."""

    def __init__(self, blocking=False, db_path=None):
        self._blocking = blocking
        self._db, self._db_path, self._is_temp_db = _open_job_db(
            db_path
        )
        self._session_ids = []

    def __del__(self):
        _close_job_db(
            getattr(self, "_db", None),
            getattr(self, "_db_path", None),
            getattr(self, "_is_temp_db", False),
        )

    @property
    def isBlocking(self):
        return self._blocking

    @property
    def db(self):
        return self._db

    @property
    def name(self):
        return self._registry_name

    @property
    def submit_command(self):
        return self._submit

    @property
    def monitor_command(self):
        return self._monitor

    @property
    def cancel_command(self):
        return self._cancel

    @property
    def resource_flags(self):
        return self._resources_flag

    @property
    def job_id_pattern(self):
        return self._job_id_re


class LSFSubmitter(_ClusterSubmitterBase):
    """IBM LSF (bsub/bjobs/bkill)."""

    _registry_name = "lsf"

    _submit = "bsub -J {name} {dependent} {resources} '{cmd}'"
    _monitor = "bjobs {job_id}"
    _cancel = "bkill {job_id}"
    _resources_flag = {
        EResource.queue: "-q",
        EResource.time: "-W",
        EResource.mem: "-R",
        EResource.nodes: "-n",
        EResource.error: "-e",
        EResource.out: "-o",
    }
    _job_id_re = re.compile(r"Job <([0-9]*)>")

    def _get_status(self, stdo):
        lines = [ln for ln in stdo.split("\n") if ln.split()]
        if len(lines) < 2:
            # finished jobs age out of bjobs view (CLEAN_PERIOD):
            # an empty listing means completed, like the SGE monitor
            return EStatus.DONE
        st = lines[1].split()[2].strip()
        return {
            "PEND": EStatus.PEND,
            "RUN": EStatus.RUN,
            "DONE": EStatus.DONE,
            "EXIT": EStatus.EXIT,
        }.get(st, EStatus.SUSP)

    def _prepare_dependencies(self, dependent):
        if dependent is None:
            return ""
        try:
            if isinstance(dependent, Command):
                job_id = self._db_get(dependent.command_id)["job_id"]
                return "-w {}".format(job_id)
            dep_jobs = [
                self._db_get(d.command_id)["job_id"] for d in dependent
            ]
            # the expression is interpolated into a shell=True command
            # string: unquoted, /bin/sh would eat the parentheses and
            # split the line at && (any multi-dependency bsub failed —
            # the reference inherits the same defect); single-quote so
            # bsub receives the whole dependency expression
            return "-w '{}'".format(
                " && ".join("ended({})".format(d) for d in dep_jobs)
            )
        except KeyError:
            raise ValueError(
                "Specified dependent jobs have not been submitted yet."
            )

    def _prepare_resources(self, resources):
        return " ".join(
            "{} 'rusage[mem={}]'".format(self.resource_flags[k], v)
            if k == EResource.mem
            else "{} {}".format(self.resource_flags[k], v)
            for k, v in resources.items()
        )


class SlurmSubmitter(_ClusterSubmitterBase):
    """Slurm (sbatch --wrap 'srun ...' / squeue / scancel)."""

    _registry_name = "slurm"

    _submit = (
        "sbatch --job-name={name} {dependent} {resources} "
        "--wrap 'srun {cmd}'"
    )
    _monitor = "squeue -t all -j {job_id}"
    _cancel = "scancel {job_id}"
    _resources_flag = {
        EResource.queue: "-p",
        EResource.time: "-t",
        EResource.mem: "--mem-per-cpu",
        EResource.nodes: "-c",
        EResource.error: "-e",
        EResource.out: "-o",
    }
    _job_id_re = re.compile(r"Submitted batch job ([0-9]*)")

    def _get_status(self, stdo):
        lines = [ln for ln in stdo.split("\n") if ln.split()]
        if len(lines) < 2:
            # finished jobs age out of squeue view (MinJobAge): an
            # empty listing means completed, like the SGE monitor
            return EStatus.DONE
        st = lines[1].split()[4].strip()
        if st in ("PD", "CF"):
            return EStatus.PEND
        if st in ("R", "CG"):
            return EStatus.RUN
        if st == "CD":
            return EStatus.DONE
        if st in ("BF", "PR", "TO", "NF", "F", "CA"):
            return EStatus.EXIT
        return EStatus.SUSP

    def _prepare_dependencies(self, dependent):
        if dependent is None:
            return ""
        try:
            if isinstance(dependent, Command):
                dep_ids = [self._db_get(dependent.command_id)["job_id"]]
            else:
                dep_ids = [
                    self._db_get(d.command_id)["job_id"]
                    for d in dependent
                ]
            return (
                "--kill-on-invalid-dep=yes "
                "--dependency=afterok:{}".format(":".join(dep_ids))
            )
        except KeyError:
            raise ValueError(
                "Specified dependent jobs have not been submitted yet."
            )

    def _prepare_resources(self, resources):
        return " ".join(
            "{} {}".format(self.resource_flags[k], v)
            for k, v in resources.items()
        )


class SGESubmitter(_ClusterSubmitterBase):
    """Sun Grid Engine (qsub/qstat/qdel)."""

    _registry_name = "sge"

    _submit = "echo '{cmd}' | qsub -N {name} {dependent} {resources}"
    _monitor = "qstat"
    _cancel = "qdel {job_id}"
    _resources_flag = {
        EResource.queue: "-q",
        EResource.time: "-l h_rt=",
        EResource.mem: "-l h_vmem=",
        EResource.nodes: "-pe smp",
        EResource.error: "-e",
        EResource.out: "-o",
    }
    _job_id_re = re.compile(r"Your job ([0-9]+) ")

    @staticmethod
    def _map_state(st):
        """Map one exact qstat state code to an EStatus.

        EXACT matching is load-bearing: substring checks classified the
        error state "Eqw" as pending ("qw" in "Eqw"), so a job that
        errored before starting (bad cwd, permissions) reported PEND
        forever and a blocking join() spun indefinitely."""
        if st in ("r", "t", "Rr", "Rt"):
            return EStatus.RUN
        if st in ("qw", "hqw", "hRwq"):
            return EStatus.PEND
        if st in ("s", "ts", "S", "tS", "T", "tT",
                  "Rs", "RS", "RT", "Rts", "RtS", "RtT"):
            return EStatus.SUSP
        # error/deletion states (Eqw, EhRqw, dr, dt, ...) and anything
        # unrecognized: terminal
        return EStatus.EXIT

    def _get_status(self, stdo, job_id=None):
        # qstat lists all jobs; find the row for the monitored job id
        # (or, without one, the first job row)
        for line in stdo.split("\n")[2:]:
            fields = line.split()
            if len(fields) <= 4 or not fields[0].isdigit():
                continue
            if job_id is not None and fields[0] != str(job_id):
                continue
            return self._map_state(fields[4])
        # job disappeared from qstat: finished
        return EStatus.DONE

    def _internal_monitor(self, command_id):
        # SGE's qstat shows all user jobs; a missing job means DONE.
        try:
            job_id = self._db_get(command_id)["job_id"]
        except KeyError:
            raise ValueError(
                "Command " + repr(command_id)
                + " has not been submitted yet."
            )

        returncode, stdo, stde = _run_shell(self.monitor_command)
        if returncode != 0:
            raise RuntimeError(
                "Unsuccessful monitoring of " + repr(command_id)
                + " (EXIT!=0) with error: " + stde
            )

        status = self._get_status(stdo, job_id=job_id)

        entry = self._db_get(command_id)
        entry["status"] = status
        self._db_set(command_id, entry)
        return status

    def _prepare_dependencies(self, dependent):
        if dependent is None:
            return ""
        try:
            if isinstance(dependent, Command):
                dep_ids = [self._db_get(dependent.command_id)["job_id"]]
            else:
                dep_ids = [
                    self._db_get(d.command_id)["job_id"]
                    for d in dependent
                ]
            return "-hold_jid {}".format(",".join(map(str, dep_ids)))
        except KeyError:
            raise ValueError(
                "Specified dependent jobs have not been submitted yet."
            )

    def _prepare_resources(self, resources):
        parts = []
        for k, v in resources.items():
            flag = self.resource_flags[k]
            if flag.endswith("="):
                parts.append("{}{}".format(flag, v))
            else:
                parts.append("{} {}".format(flag, v))
        return " ".join(parts)


class LocalSubmitter(ASubmitter):
    """Run commands locally with a dependency-aware thread pool.

    Each job runs as a subprocess in its own process group (so cancel
    kills the whole tree); jobs with dependencies start only after all
    dependencies finished successfully, and inherit EXIT status if a
    dependency failed. Job metadata is persisted in a PersistentDict.
    """

    _registry_name = "local"

    def __init__(self, blocking=True, db_path=None, ncpu=1,
                 max_retries=0):
        self._blocking = blocking
        self._ncpu = max(1, int(ncpu))
        # automatic resubmission of FAILED jobs (0 = reference
        # behavior: no retry; the reference has no resubmission at
        # all, SURVEY.md §5). Cancelled jobs are never retried.
        self._max_retries = max(0, int(max_retries))
        self._cancelled = set()

        self._db, self._db_path, self._is_temp_db = _open_job_db(
            db_path
        )

        self._lock = threading.RLock()
        self._semaphore = threading.Semaphore(self._ncpu)
        self._threads = {}
        self._events = {}       # command_id -> Event set on completion
        self._processes = {}    # command_id -> Popen
        self._status = {}       # command_id -> EStatus
        self._dependencies = {}  # command_id -> list of command_ids

    def __del__(self):
        try:
            # terminate whatever is still running
            with self._lock:
                procs = list(self._processes.values())
            for p in procs:
                if p.poll() is None:
                    try:
                        os.killpg(os.getpgid(p.pid), signal.SIGKILL)
                    except (ProcessLookupError, PermissionError):
                        pass
        except (AttributeError, TypeError):
            pass
        _close_job_db(
            getattr(self, "_db", None),
            getattr(self, "_db_path", None),
            getattr(self, "_is_temp_db", False),
        )

    @property
    def isBlocking(self):
        return self._blocking

    @property
    def name(self):
        return "local"

    def _db_set(self, command, status, pid=None):
        entry = {
            "name": command.name,
            "job_id": pid,
            "status": status,
            "command": command.command,
            "resources": command.resources,
            "workdir": command.workdir,
            "environment": command.environment,
        }
        self._db[command.command_id] = yaml.safe_dump(entry)
        self._db.sync()

    def _set_status(self, command, status, pid=None):
        with self._lock:
            self._status[command.command_id] = status
            self._db_set(command, status, pid)

    def _run_job(self, command, dependency_ids):
        # wait for all dependencies; inherit failure
        for dep_id in dependency_ids:
            self._events[dep_id].wait()
            if self._status.get(dep_id) != EStatus.DONE:
                self._set_status(command, EStatus.EXIT)
                self._events[command.command_id].set()
                return

        cid = command.command_id
        with self._semaphore:
            try:
                for _attempt in range(1 + self._max_retries):
                    # cancelled while pending / between retries:
                    # never (re)start the process
                    with self._lock:
                        if cid in self._cancelled:
                            return
                    try:
                        p = subprocess.Popen(
                            command.full_command_string(), shell=True,
                            stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE,
                            universal_newlines=True,
                            cwd=command.workdir, preexec_fn=os.setsid,
                        )
                        with self._lock:
                            self._processes[cid] = p
                            # cancel() may have fired between the
                            # pre-Popen check and process registration
                            # (it found no process to kill then) —
                            # re-check under the same lock so the
                            # freshly started process dies instead of
                            # running to completion after a
                            # "successful" cancellation
                            cancelled_now = cid in self._cancelled
                        if cancelled_now:
                            try:
                                os.killpg(os.getpgid(p.pid),
                                          signal.SIGKILL)
                            except (ProcessLookupError,
                                    PermissionError):
                                pass
                            p.communicate()
                            return
                        self._set_status(command, EStatus.RUN, p.pid)

                        p.communicate()
                        if p.returncode == 0:
                            self._set_status(command, EStatus.DONE,
                                             p.pid)
                            return
                        self._set_status(command, EStatus.EXIT, p.pid)
                    except Exception:
                        self._set_status(command, EStatus.EXIT)
            finally:
                self._events[cid].set()

    def submit(self, command, dependent=None):
        if dependent is None:
            dependency_ids = []
        elif isinstance(dependent, Command):
            dependency_ids = [dependent.command_id]
        else:
            dependency_ids = [d.command_id for d in dependent]

        for dep_id in dependency_ids:
            if dep_id not in self._events:
                raise ValueError(
                    "Specified dependent jobs have not been "
                    "submitted yet."
                )

        with self._lock:
            self._events[command.command_id] = threading.Event()
            self._dependencies[command.command_id] = dependency_ids
            self._set_status(command, EStatus.PEND)

        thread = threading.Thread(
            target=self._run_job, args=(command, dependency_ids),
            daemon=True,
        )
        self._threads[command.command_id] = thread
        thread.start()
        return command.command_id

    def monitor(self, command):
        with self._lock:
            if command.command_id not in self._status:
                raise ValueError(
                    "Command " + repr(command)
                    + " has not been submitted yet."
                )
            return self._status[command.command_id]

    def cancel(self, command):
        cid = command.command_id
        with self._lock:
            if cid not in self._status:
                raise ValueError(
                    "Command " + repr(command)
                    + " has not been submitted yet."
                )
            status = self._status[cid]
            # mark BEFORE the terminal-status early return: a job
            # observed as EXIT may merely be between retry attempts
            # (environment max_retries); without the mark the next
            # attempt would launch after a "successful" cancellation
            self._cancelled.add(cid)
            p = self._processes.get(cid)

        if status == EStatus.DONE:
            return True

        if p is not None and p.poll() is None:
            try:
                os.killpg(os.getpgid(p.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass

        with self._lock:
            # don't overwrite a completion that landed while
            # cancelling
            if self._status.get(cid) != EStatus.DONE:
                self._set_status(command, EStatus.EXIT)
        self._events[cid].set()
        return True

    def join(self):
        if not self.isBlocking:
            return
        for event in list(self._events.values()):
            event.wait()
