"""The benchmark's harness: finds a cell's configuration, traffic, runner,
limits and per-layer readers by name, runs it, and assembles the
result line.

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by the name that BENCHMARK.json gives:

    configs/<config>.json      sizes, precision, fit parameters, control
    traffic/<traffic>.json     the mix's parameters and its runner's name
    runners/<runner>.py        run(cell) -> Outcome; one per kind of work
    limits/<workload>.json     each compared number's limit and readings
    metrics/<metric>.py        read(ctx) -> value or None

A metric's name before its first dot names the quantity a runner reports;
what follows names the cells it is bounded over, where one quantity spreads
so differently between cells that one bound cannot serve both (the
device-bound parity fit and the host-bound balanced fit). Since each
per-layer metric moves one end-to-end metric, its readers split alike.
"""

import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

# modules that may not be loaded in the process that prints a result,
# compared by their whole top-level name
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "evcouplings_tpu")

HERE = Path(__file__).resolve().parent


def forbidden_loaded(modules=None):
    """Sorted top-level names of FORBIDDEN_MODULES found in sys.modules."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names.intersection(FORBIDDEN_MODULES))


class ForbiddenModule(RuntimeError):
    pass


def check_no_jax(when):
    found = forbidden_loaded()
    if found:
        raise ForbiddenModule("{} loaded {}: the benchmark runs the PyTorch "
                              "port alone".format(when, ", ".join(found)))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    """Import a file of the benchmark by path (its name may hold dots)."""
    name = "bench_port_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Registry:
    """The benchmark's entries and files under one directory."""

    def __init__(self, benchmark, base=HERE):
        self.benchmark = benchmark
        self.base = Path(base)

    def workload(self, name):
        for w in self.benchmark["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError("no workload {!r} in BENCHMARK.json".format(name))

    def config(self, name):
        return load_json(self.base / "configs" / (name + ".json"))

    def traffic(self, name):
        return load_json(self.base / "traffic" / (name + ".json"))

    def runner(self, name):
        return load_module(self.base / "runners" / (name + ".py"))

    def limits(self, workload):
        return load_json(self.base / "limits" / (workload + ".json"))["limits"]

    def reader(self, metric):
        return load_module(self.base / "metrics" / (metric + ".py"))

    def end_to_end(self, workload):
        return [m for m in self.benchmark["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload):
        """The cell's per-layer metrics: those that list it, and those that
        list no cells and move an end-to-end metric the cell reports."""
        reported = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.benchmark["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]


@dataclass
class Checks:
    """The numbers compared, each with its limit; a number passes at or
    below its limit. The cell's limits file names the numbers it compares:
    a runner may offer more, and those are not compared."""
    limits: dict
    rows: list = field(default_factory=list)

    def add(self, name, value):
        if name in self.limits:
            limit = self.limits[name]
            self.rows.append((name, float(value), limit, value <= limit))

    @property
    def ok(self):
        return all(r[3] for r in self.rows)

    def as_dict(self):
        return {n: {"value": v, "limit": lim} for n, v, lim, _ in self.rows}


@dataclass
class Cell:
    """What a runner is given: the cell's entries, its run's arguments and
    the device, and the checks to fill. With `control`, the configuration's
    control takes the program's place."""
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    checks: Checks
    t_start: float
    control: bool = False


@dataclass
class Outcome:
    """What a runner returns. `e2e` holds its end-to-end values by name;
    `counters` what its per-layer readers read; `trace` the reduced device
    trace of a traced run."""
    e2e: dict
    counters: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: dict = None


@dataclass
class ReaderContext:
    cell: Cell
    outcome: Outcome
    peaks: dict


def run_cell(registry, name, seed, seconds, trace, device, t_start=None,
             peaks=None, control=False):
    """Run one cell once: (result dict, Checks)."""
    t_start = time.perf_counter() if t_start is None else t_start
    w = registry.workload(name)
    traffic = registry.traffic(w["traffic"])
    cell = Cell(w, registry.config(w["config"]), traffic, int(seed),
                float(seconds), bool(trace), device,
                Checks(registry.limits(name)), t_start, control)
    outcome = registry.runner(traffic["runner"]).run(cell)
    check_no_jax("after the window,")
    print("counters: {}".format(json.dumps(outcome.counters)),
          file=sys.stderr)
    if trace:
        ctx = ReaderContext(cell, outcome, peaks)
        metrics = {}
        for m in registry.per_layer(name):
            value = registry.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": outcome.e2e[m["name"].split(".")[0]],
                               "unit": m["unit"]}
                   for m in registry.end_to_end(name)}
    result = {
        "correct": cell.checks.ok,
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": metrics,
        "device": {"memory_peak_bytes": outcome.memory_peak_bytes},
    }
    if trace and outcome.trace is not None:
        result["device"].update(busy_s=outcome.trace["busy_s"],
                                window_s=outcome.trace["window_s"])
        result["breakdown"] = {k: outcome.trace[k]
                               for k in ("device_ops", "idle_gaps")}
    result["checks"] = cell.checks.as_dict()
    return result, cell.checks
