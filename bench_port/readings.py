#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, in one
process: the program's numbers over a dozen seeds or more, and the
configuration's control's over three or more, each through the cell's own
run (its sizes, its window of `--seconds`) and the same comparison. Every
number a runner offers is read, whether or not the cell compares it.

    python3 bench_port/readings.py --workload <cell> --seconds <s> \
        [--control-seconds <s>] [--seeds 12] [--control-seeds 3] \
        [--first-seed N] [--also-seeds N,N,...] [--fault NAME]

--control-seconds gives the control's runs a window of their own, where
the control (a reference fit, which no deadline interrupts) takes longer
than the program. --also-seeds adds seeds on record (a run that failed
elsewhere) to the program's.

--fault plants one of bench_port/tests/faults.py's faults in the program
for the program's runs. Prints one JSON line per run ({"seed", "control",
"checks"}) and then, per number, the largest program reading and the
smallest control reading (and the smallest program reading, which is a
planted fault's), each run's number the largest over its parts.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench_port import harness, run  # noqa: E402  (sets the cache dirs)


class ReadAll(dict):
    """Limits under which every number is read and none fails."""

    def __contains__(self, name):
        return True

    def __missing__(self, name):
        return float("inf")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control-seconds", type=float)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 1000)
    p.add_argument("--also-seeds", default="")
    p.add_argument("--fault")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    registry = harness.Registry(harness.load_json(ROOT / "BENCHMARK.json"))
    registry.limits = lambda workload: ReadAll()
    if args.fault:
        import pytest

        from bench_port.tests import faults

        faults.FAULTS[args.fault](pytest.MonkeyPatch())
    device = torch.device("cuda", 0)
    print("card: {}".format(run.card_identity()), flush=True)
    worst, fewest, least = {}, {}, {}
    also = [int(s) for s in args.also_seeds.split(",") if s]
    runs = ([(args.first_seed + k, False) for k in range(args.seeds)]
            + [(seed, False) for seed in also]
            + [(args.first_seed + k, True) for k in range(args.control_seeds)])
    for seed, control in runs:
        t = time.perf_counter()
        try:
            seconds = (args.control_seconds or args.seconds if control
                       else args.seconds)
            _, checks = harness.run_cell(registry, args.workload, seed,
                                         seconds, False, device,
                                         control=control)
            rows = {n: v for n, v, _, _ in checks.rows}
        except Exception as e:  # a control that crashes has failed
            rows = {"error": "{}: {}".format(type(e).__name__, e)}
        print(json.dumps({"seed": seed, "control": control, "checks": rows,
                          "s": time.perf_counter() - t}), flush=True)
        per_run = {}
        for name, v in rows.items():
            if name != "error":
                base = name.split(".")[-1]
                per_run[base] = max(per_run.get(base, v), v)
        books = ([(least, min)] if control
                 else [(worst, max), (fewest, min)])
        for book, pick in books:
            for base, v in per_run.items():
                book[base] = pick(book.get(base, v), v)
    print(json.dumps({"program_largest": worst, "program_smallest": fewest,
                      "control_smallest": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
