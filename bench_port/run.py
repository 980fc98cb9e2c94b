#!/usr/bin/env python3
"""Run one cell of the benchmark of evcouplings_torch once, on one card.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds BENCHMARK.json and the port. Prints,
as the last line of standard output, one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), device, breakdown (--trace 1), and
checks: each number compared with its limit, also the last lines of
standard error. Exits non-zero, printing no result, without enough CUDA
devices, when a module of JAX or of the JAX package is loaded, or when any
step fails.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the program at a fixed place inside the
# checkout, so that only a checkout's first run builds
CACHE = ROOT / "build" / "bench_port"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def card_identity():
    """'name, power limit' as nvidia-smi reports the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return "nvidia-smi failed: {}".format(e)
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi: none"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from bench_port import accounting, harness

    registry = harness.Registry(
        harness.load_json(ROOT / "BENCHMARK.json"))
    chips = registry.workload(args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("bench_port: the cell needs {} CUDA device(s); found {}".format(
            chips, torch.cuda.device_count() if torch.cuda.is_available()
            else 0), file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(device)
    result, checks = harness.run_cell(
        registry, args.workload, args.seed, args.seconds, bool(args.trace),
        device, T_START, accounting.device_peaks(kind))
    result["device"] = {"platform": "gpu", "kind": kind, "count": chips,
                        **result["device"]}
    result["checks"] = result.pop("checks")   # the last key
    print("card: {}".format(card_identity()), file=sys.stderr)
    for name, value, limit, ok in checks.rows:
        print("check {}: {!r} limit {!r} {}".format(
            name, value, limit, "ok" if ok else "FAILED"), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # the run's boundary: no result line
        import traceback

        traceback.print_exc()
        print("bench_port: {}: {}".format(type(e).__name__, e),
              file=sys.stderr)
        sys.exit(1)
