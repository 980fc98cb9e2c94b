#!/usr/bin/env python3
"""
Benchmark of the PyTorch/CUDA port (evcouplings_torch) on one NVIDIA GPU:
the twin of bench.py, the JAX package's benchmark entry point.

    python3 bench_torch.py [--all] [--device cpu] [--small]

Prints what bench.py prints: one JSON line from main() (the headline
record: production PLM throughput in seq*site/s at N=262144, L=160,
q=21, with the parity-mode, parity-LBFGS and large-L records, the MFU and
roofline accounting against the card's published peaks, the four
family-config records, the hermetic four-stage pipeline's wall clock, the
real-family fit and the 524288-row reweighting record), and with --all
one line each for the secondaries bench_reweighting, bench_lbfgs,
bench_asym and bench_asym_lbfgs. Every record goes through the port's
public entry points at bench.py's shapes, and every line carries the
card's name and power limit as nvidia-smi reports them.

Differences from bench.py's records:
- No record turns its error into a `*_error` key: any failure raises.
  The only skip is `family_fit_skipped`, while the reference cadherin
  alignment is not in the repository (REAL_FAMILY_A2M).
- The reweighting record names its routes `kernel` (K1, the hand-written
  CUDA kernel) and `library` (row blocks of a torch._int_mm identity
  GEMM, the twin of the XLA one-hot path); both give exact integer
  counts, and the record asserts that they are equal. Its `*_hbm_bytes`
  are the allocator's peak during each route, not a count of arrays.
- The parity-mode MFU divides by the peak of the units its products run
  on: "highest" is IEEE SGEMM on the SIMT cores (fp32 peak, one pass),
  "high" and "default" are 2 and 1 bf16 limb passes on the tensor cores
  (bf16 peak); `parity_peak_basis`, `parity_passes` and `parity_duty`
  take the place of bench.py's TPU pass model.
- `vs_measured_cpu` is null: benchmarks/cpu_baseline.json was measured on
  another machine's host (`vs_measured_cpu_note`).
- `pipeline_e2e_warm_s` is a second run in a fresh working directory in
  the same process, with the kernels already built and loaded (there is
  no compile cache to warm). The job draws no figure: compare plots
  nothing, and the mutate stage's matrix is written after the job
  (mutate_matrix_only), on every machine alike.
- Times end at torch.cuda.synchronize(); `production_peak_*_bytes` are
  the caching allocator's peaks over the production run, above what the
  process held before it.

--device cpu runs every record on the host (kernels' plain versions; no
device metric is reported: MFU is skipped, byte peaks are null). Without
a CUDA device and without --device cpu it raises. --small runs every
record at a reduced size (SMALL), a smoke run for the tests.
"""

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

PLMC_32T_BASELINE = 5.0e6  # seq*site/s, bench.py's analytic bound

# The reference's bundled cadherin alignment (EVcouplings
# notebooks/example/example_aln.a2m, 53 sequences); the real-family record
# runs once it is committed here.
REAL_FAMILY_A2M = os.path.join(HERE, "examples_torch", "data",
                               "example_aln.a2m")

# ---------------------------------------------------------------------
# MFU / roofline accounting
# ---------------------------------------------------------------------
# Published dense peaks per card, keyed on torch.cuda.get_device_name():
# NVIDIA H100 SXM5 data sheet (the 700 W part), rates without sparsity.
# fp32 is the rate outside the tensor cores (IEEE SGEMM on the SIMT
# cores, the parity mode's "highest").
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_peak_flops": 989.4e12,
        "fp32_peak_flops": 66.9e12,
        "int8_peak_ops": 1979e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def device_peak(kind):
    """{device_kind, bf16_peak_flops, fp32_peak_flops, int8_peak_ops,
    hbm_bytes_per_s} for a device name, None for a card (or host) not in
    DEVICE_PEAKS. Longest-prefix match, as bench.py's."""
    best = None
    for k in DEVICE_PEAKS:
        if kind.startswith(k) and (best is None or len(k) > len(best)):
            best = k
    if best is None:
        return None
    return {"device_kind": kind, **DEVICE_PEAKS[best]}


def plm_flops_per_seq_site(l, q):
    """Model FLOPs per sequence-site of one value+gradient pass (bench.py's
    count: the logits, Z, 1/Z and dJh GEMMs, 4 Lq Lq_aug + 4 L Lq per row,
    divided by L; elementwise work and the optimizer are excluded, and no
    precision's extra passes are multiplied in)."""
    from evcouplings_torch.ops.plm import _augmented_width

    lq = l * q
    lq_aug = _augmented_width(lq)
    return 4 * q * lq_aug + 4 * lq


def plm_hbm_bytes_per_row(l, q, block_size, elt_bytes=2):
    """Dominant bytes moved per MSA row by one two-phase value+gradient
    step (bench.py's count): the augmented one-hot read twice, the
    residual written and read, the int8 codes, and the (Lq_aug, Lq)
    parameter matrix once per row block."""
    from evcouplings_torch.ops.plm import _augmented_width

    lq = l * q
    lq_aug = _augmented_width(lq)
    return (
        2 * lq_aug * elt_bytes        # one-hot read, phases 1 and 2
        + 2 * lq * elt_bytes          # residual write + read
        + l                           # int8 codes
        + lq_aug * lq * elt_bytes / block_size  # J_aug per block
    )


def gemm_pass_model(precision):
    """(peak basis, passes) of the fits' one-hot products at a precision
    name (_device.precision_limbs): "highest" is IEEE SGEMM on the SIMT
    cores, one pass against the fp32 peak; "high" and "default" are 2 and
    1 bf16 limb passes on the tensor cores, against the bf16 peak."""
    from evcouplings_torch._device import precision_limbs

    limbs = precision_limbs(precision)
    return ("fp32_simt", 1) if limbs is None else ("bf16_tensor", limbs)


_BASIS_PEAK = {"fp32_simt": "fp32_peak_flops",
               "bf16_tensor": "bf16_peak_flops"}
# the parity mode's precision name (plmc's numerics: IEEE float32 products)
PARITY_PRECISION = "highest"


@dataclass(frozen=True)
class Shapes:
    """Every record's size. BENCH is bench.py's; SMALL a smoke size."""
    n: int = 262144                 # headline rows (bench.py N)
    l: int = 160                    # sites (bench.py L)
    q: int = 21
    block: int = 8192               # production block (two-phase layout)
    steps_per_call: int = 60
    warmup_calls: int = 2
    bench_calls: int = 3
    n_parity: int = 65536           # parity_mode_value rows
    parity_block: int = 512
    lbfgs_iter: int = 60            # parity LBFGS record, at n rows
    lbfgs_steps: int = 15
    l_big: int = 512                # large-L record
    n_big: int = 32768
    big_block: int = 1024
    big_iter: int = 120
    big_steps: int = 30
    mi_apc_n: int = 4096
    mi_apc_l: int = 96
    evcomplex_l: int = 150          # per segment
    fold_l: int = 160
    pipeline_rows: int = 2048
    pipeline_cols: int = 96
    family_cols: int = 200
    family_iter: int = 150
    reweight_big_n: int = 524288
    reweight_n: int = 131072        # bench_reweighting
    library_block: int = 2048       # rows per torch._int_mm identity GEMM
    secondary_n: int = 16384        # bench_lbfgs, bench_asym(_lbfgs)
    sec_lbfgs_iter: int = 40
    sec_lbfgs_steps: int = 10
    sec_asym_iter: int = 120
    sec_asym_steps: int = 30
    sec_asym_lbfgs_iter: int = 40
    sec_asym_lbfgs_steps: int = 5


BENCH = Shapes()
SMALL = Shapes(
    n=2048, l=40, block=2048, steps_per_call=3, warmup_calls=1,
    bench_calls=2, n_parity=512, parity_block=128, lbfgs_iter=9,
    lbfgs_steps=3, l_big=64, n_big=512, big_block=256, big_iter=6,
    big_steps=2, mi_apc_n=1024, pipeline_rows=300, pipeline_cols=48,
    family_cols=18, family_iter=10, reweight_big_n=2048, reweight_n=1024,
    library_block=512, secondary_n=512, sec_lbfgs_iter=6,
    sec_lbfgs_steps=2, sec_asym_iter=6, sec_asym_steps=2,
    sec_asym_lbfgs_iter=6, sec_asym_lbfgs_steps=2,
)

# covarying column pairs (a, b, concordance) of the parity LBFGS record's
# MSA at L=160; scaled to other L by parity_lbfgs_case
_PARITY_PAIRS = ((3, 50, 0.9), (10, 77, 0.8), (20, 31, 0.7),
                 (40, 90, 0.85), (60, 120, 0.75), (5, 140, 0.8))


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_identity(device):
    """{"device_name", "device_power_limit_w"}: the card's name and power
    limit as `nvidia-smi --query-gpu=name,power.limit` reports them, or
    ("cpu", None) on the host."""
    if device.type != "cuda":
        return {"device_name": "cpu", "device_power_limit_w": None}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(device.index or 0)],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"device_name": name,
            "device_power_limit_w": float(limit.split()[0])}


def _mfu_records(throughput, parity_throughput, large_l=None, peak=None,
                 shapes=BENCH):
    """Roofline record of the headline numbers against a peak dict
    (device_peak; None: mfu_skipped): model FLOP/s, their share of the
    peak of the units the products run on (gemm_pass_model), the
    production mode's arithmetic intensity against the HBM ridge point.
    Pure arithmetic given the measured throughputs."""
    if peak is None:
        return {"mfu_skipped": "unknown device kind"}

    l, q = shapes.l, shapes.q
    flop = plm_flops_per_seq_site(l, q)
    ai = flop * l / plm_hbm_bytes_per_row(l, q, block_size=shapes.block)
    ridge = peak["bf16_peak_flops"] / peak["hbm_bytes_per_s"]
    out = {
        "mfu_device_kind": peak["device_kind"],
        "mfu_peak_tflops_bf16": round(peak["bf16_peak_flops"] / 1e12, 1),
        "mfu_peak_tflops_fp32": round(peak["fp32_peak_flops"] / 1e12, 1),
        "mfu_flop_per_seq_site": flop,
        # production mode (bf16): position on the roofline
        "mfu_ai_flop_per_byte": round(ai, 1),
        "mfu_ridge_flop_per_byte": round(ridge, 1),
    }
    if throughput:
        tflops = throughput * flop / 1e12
        out["mfu_production_tflops"] = round(tflops, 1)
        out["mfu_production"] = round(
            tflops * 1e12 / peak["bf16_peak_flops"], 3)
    if parity_throughput:
        basis, passes = gemm_pass_model(PARITY_PRECISION)
        tflops = parity_throughput * flop / 1e12
        out["mfu_parity_tflops"] = round(tflops, 1)
        out["mfu_parity"] = round(tflops * 1e12 / peak[_BASIS_PEAK[basis]],
                                  3)
        out["parity_peak_basis"] = basis
        out["parity_passes"] = passes
        # the units' duty: model FLOPs times the passes they take
        out["parity_duty"] = round(out["mfu_parity"] * passes, 3)
    if large_l:
        # the asymmetric fit runs the same four GEMMs per row
        tflops = large_l * plm_flops_per_seq_site(shapes.l_big, q) / 1e12
        out["mfu_large_l_tflops"] = round(tflops, 1)
        out["mfu_large_l"] = round(
            tflops * 1e12 / peak["bf16_peak_flops"], 3)
    return out


# ---------------------------------------------------------------------
# PLM throughput records
# ---------------------------------------------------------------------

def _plm_throughput(cfg, n, shapes, steps_per_call, warmup_calls,
                    bench_calls, device, seed=0):
    """seq*site/s of the unfused value+grad + Adam step loop
    (ops/plm._make_adam_step, optax.adam's arithmetic) at the given
    PlmConfig on uniform random codes; one step is one plmc-LBFGS
    iteration equivalent. Steps run in chunks of steps_per_call, timed
    between two synchronisations."""
    import torch

    from evcouplings_torch.ops.plm import (
        _make_adam_step, build_augmented_onehot, make_plm_value_and_grad,
    )

    L, q = shapes.l, shapes.q
    vg = make_plm_value_and_grad(L, q, cfg)
    rng = np.random.default_rng(seed)
    codes = torch.as_tensor(rng.integers(0, q, size=(n, L)).astype(np.int8),
                            device=device)
    weights = torch.ones((n,), dtype=torch.float32, device=device)
    compute_dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                     else torch.float32)
    # static per-fit input of the two-phase layout, built once
    oh_aug = build_augmented_onehot(codes, q, compute_dtype)
    params = {
        "J": torch.zeros((L * q, L * q), dtype=torch.float32, device=device),
        "h": torch.zeros((L, q), dtype=torch.float32, device=device),
    }
    state = {"count": 0,
             "mu": {k: torch.zeros_like(v) for k, v in params.items()},
             "nu": {k: torch.zeros_like(v) for k, v in params.items()}}
    step = _make_adam_step(vg, cfg)

    def chunk(params, state):
        for _ in range(steps_per_call):
            params, state, row = step(params, state, codes, weights, oh_aug)
        return params, state, row[0]

    for _ in range(warmup_calls):
        params, state, value = chunk(params, state)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(bench_calls):
        params, state, value = chunk(params, state)
    _sync(device)
    elapsed = time.perf_counter() - t0
    if not math.isfinite(float(value)):
        raise RuntimeError("non-finite objective {}".format(float(value)))
    return n * L * bench_calls * steps_per_call / elapsed


def _warm_window(stamps):
    """(seconds, iterations) between the end of the first callback
    burst (compile) and the last, from (perf_counter, iter) stamps.
    Returns (None, 0) when everything landed in one burst (converged
    within the first chunk) — callers must skip the rate in that
    case."""
    bursts = [[stamps[0]]]
    for s in stamps[1:]:
        if s[0] - bursts[-1][-1][0] > 2e-3:
            bursts.append([])
        bursts[-1].append(s)
    if len(bursts) < 2:
        return None, 0
    iters = bursts[-1][-1][1] - bursts[0][-1][1]
    return bursts[-1][-1][0] - bursts[0][-1][0], iters


def _window_rate(stamps, what):
    """(seconds, iterations) of _warm_window; raises where there is no
    window (every callback in one burst) instead of reporting no rate."""
    warm, iters = _warm_window(stamps) if stamps else (None, 0)
    if warm is None or warm <= 0 or iters == 0:
        raise RuntimeError("{}: no warm window in {} callback stamps".format(
            what, len(stamps)))
    return warm, iters


def _per(device):
    """The unit's suffix: a rate on the card, or on the host."""
    return "per card" if device.type == "cuda" else "on the host"


def _stamper(stamps):
    return lambda r: stamps.append((time.perf_counter(), r["iter"]))


def parity_lbfgs_case(n, L, q, seed=2):
    """The parity LBFGS record's MSA: uniform codes with six planted
    covarying column pairs (positions scaled from L=160), and uniform
    weights in [0.5, 1)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, q, size=(n, L)).astype(np.int8)
    for (a, b, conc) in _PARITY_PAIRS:
        state = rng.integers(0, 2, size=n)
        partner = np.where(rng.random(n) < conc, state, 1 - state)
        codes[:, a * L // 160] = state * 3
        codes[:, b * L // 160] = partner * 4 + 1
    return codes, rng.uniform(0.5, 1.0, size=n)


def parity_lbfgs_fit(shapes, device, callback=None):
    """fit_plm on parity_lbfgs_case: the native LBFGS solver at float32,
    "highest", block 512 (K4 for its dots on the card)."""
    from evcouplings_torch.ops.plm import PlmConfig, fit_plm

    codes, w = parity_lbfgs_case(shapes.n, shapes.l, shapes.q)
    cfg = PlmConfig(solver="lbfgs", max_iter=shapes.lbfgs_iter,
                    steps_per_call=shapes.lbfgs_steps,
                    block_size=shapes.parity_block, dtype="float32",
                    precision=PARITY_PRECISION, conv_tol=0.0)
    return fit_plm(codes, w, shapes.q, cfg, callback=callback, device=device)


def _parity_lbfgs_throughput(shapes, device):
    """seq*site/s of the full parity configuration (linesearch, history,
    convergence checks) over the warm window of a real fit_plm run at the
    headline row count; returns (rate, window iterations)."""
    stamps = []
    parity_lbfgs_fit(shapes, device, callback=_stamper(stamps))
    warm, iters = _window_rate(stamps, "parity LBFGS")
    return shapes.n * shapes.l * iters / warm, iters


def _large_l_throughput(shapes, device):
    """seq*site/s of the asymmetric fit at L = l_big (production
    bf16/adam), over the warm window of its iteration callbacks."""
    from evcouplings_torch.ops.plm import PlmConfig
    from evcouplings_torch.ops.plm_sites import fit_plm_asym

    rng = np.random.default_rng(1)
    codes = rng.integers(0, shapes.q,
                         size=(shapes.n_big, shapes.l_big)).astype(np.int8)
    w = rng.uniform(0.5, 1.0, size=shapes.n_big)
    cfg = PlmConfig(solver="adam", max_iter=shapes.big_iter,
                    steps_per_call=shapes.big_steps,
                    block_size=shapes.big_block, dtype="bfloat16",
                    precision="default", conv_tol=0.0)
    stamps = []
    fit_plm_asym(codes, w, shapes.q, cfg, callback=_stamper(stamps),
                 device=device)
    warm, iters = _window_rate(stamps, "large-L asymmetric fit")
    return shapes.n_big * shapes.l_big * iters / warm


# ---------------------------------------------------------------------
# family-config records (bench.py's BASELINE configs #1, #3, #4, #5)
# ---------------------------------------------------------------------

def mi_apc_case(n, l, q=21, seed=1):
    """Uniform codes with three correlated column pairs."""
    rng = np.random.default_rng(seed)
    m = rng.integers(0, q, size=(n, l)).astype(np.int8)
    for (a, b) in ((3, 50), (10, 77), (20, 31)):
        m[:, b] = (m[:, a] + rng.integers(0, 2, size=n)) % q
    return m


def mi_apc_ec_table(scored):
    """The EC table of the upper triangle of an MI+APC matrix, by cn."""
    import pandas as pd

    l1 = scored.shape[0]
    ii, jj = np.triu_indices(l1, k=1)
    return pd.DataFrame(
        {"i": ii + 1, "j": jj + 1, "cn": scored[ii, jj]}
    ).sort_values("cn", ascending=False)


def _bench_mi_apc(shapes, device):
    """MI+APC EC scoring (reweighting through K1 on the card, weighted
    frequencies, MI, APC: ops/scores.mi_apc_from_codes), then the
    skew-normal EM mixture rescoring on the host."""
    from evcouplings_torch.couplings.pairs import add_mixture_probability
    from evcouplings_torch.ops.scores import mi_apc_from_codes

    n1, l1, q = shapes.mi_apc_n, shapes.mi_apc_l, shapes.q
    m = mi_apc_case(n1, l1, q)

    def kernel():
        # a numpy result: the host fetch ends the device work
        return mi_apc_from_codes(m, 0.8, num_symbols=q, device=device)[1]

    kernel()  # warm: builds and loads K1
    kernel_dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        scored = kernel()
        kernel_dt = min(kernel_dt, time.perf_counter() - t0)

    ecs = mi_apc_ec_table(scored)
    t0 = time.perf_counter()
    rescored = add_mixture_probability(ecs, model="skewnormal", score="cn")
    rescore_dt = time.perf_counter() - t0
    if not rescored["probability"].between(0, 1).all():
        raise RuntimeError("mixture probabilities outside [0, 1]")

    dt = kernel_dt + rescore_dt
    return {
        "mi_apc_value": round(l1 * (l1 - 1) / 2 / dt, 1),
        "mi_apc_unit": "scored pairs/s (N={}, L={}, incl. EM "
                       "rescoring)".format(n1, l1),
        "mi_apc_ms": round(dt * 1e3, 2),
        "mi_apc_kernel_ms": round(kernel_dt * 1e3, 2),
        "mi_apc_rescore_ms": round(rescore_dt * 1e3, 2),
    }


def de_scan_case(l, q=21, seed=2):
    """Symmetric couplings J (L, L, q, q), fields h, a target sequence."""
    rng = np.random.default_rng(seed)
    J = rng.normal(scale=0.05, size=(l, l, q, q))
    J = 0.5 * (J + J.transpose(1, 0, 3, 2))
    h = rng.normal(scale=0.2, size=(l, q))
    target = rng.integers(0, q, size=l)
    return J, h, target


def de_scan_run(J, h, target):
    """All single and double mutant Delta-E (ops/hamiltonian)."""
    from evcouplings_torch.ops.hamiltonian import (
        FULL, double_mutant_matrix, single_mutant_hamiltonians,
    )

    smm = single_mutant_hamiltonians(target, J, h)
    return smm, double_mutant_matrix(smm[:, :, FULL], J, target)


def _bench_de_scan(shapes, device):
    """Full single + double mutant Delta-E scan from a coupled model."""
    J, h, target = de_scan_case(shapes.l, shapes.q)
    de_scan_run(J, h, target)  # warm
    t0 = time.perf_counter()
    smm, dmm = de_scan_run(J, h, target)
    dt = time.perf_counter() - t0
    return {
        "de_scan_value": round((smm.size + dmm.size) / dt, 1),
        "de_scan_unit": "dE entries/s (L={} singles+doubles)".format(
            shapes.l),
        "de_scan_ms": round(dt * 1e3, 2),
    }


def evcomplex_case(l1, seed=3):
    """EC table of two segments of l1 residues each, with a sparse tail
    of strong scores."""
    import pandas as pd

    total = 2 * l1
    pos = np.arange(1, total + 1)
    ii, jj = np.triu_indices(total, k=1)
    rng = np.random.default_rng(seed)
    seg = np.where(pos <= l1, "A_1", "B_1")
    return pd.DataFrame({
        "i": pos[ii], "j": pos[jj],
        "segment_i": seg[ii], "segment_j": seg[jj],
        "cn": rng.normal(scale=0.02, size=ii.size)
        + 0.2 * (rng.random(ii.size) > 0.999),
    })


def evcomplex_run(ecs):
    """EVcomplex probabilities (couplings/pairs.EVComplexScoreModel) and
    the inter/intra-segment split: (scored, inter, intra)."""
    from evcouplings_torch.couplings.pairs import EVComplexScoreModel

    scored = ecs.assign(
        probability=EVComplexScoreModel(ecs.cn.values).probability(
            ecs.cn.values))
    return (scored, scored.query("segment_i != segment_j"),
            scored.query("segment_i == segment_j"))


def _bench_evcomplex(shapes, device):
    """EVcomplex scoring of a paired-alignment EC table with the
    inter/intra-segment split."""
    ecs = evcomplex_case(shapes.evcomplex_l)
    t0 = time.perf_counter()
    scored, inter, intra = evcomplex_run(ecs)
    dt = time.perf_counter() - t0
    if len(inter) + len(intra) != len(scored):
        raise RuntimeError("inter/intra split lost rows")
    return {
        "evcomplex_value": round(len(scored) / dt, 1),
        "evcomplex_unit": "EC pairs scored+split/s (two {}-res "
                          "segments)".format(shapes.evcomplex_l),
        "evcomplex_ms": round(dt * 1e3, 2),
    }


def fold_prep_case(l, seed=4):
    """(EC table sorted by cn, residue table, symmetric distance matrix)
    over l positions."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    pos = np.arange(1, l + 1)
    ii, jj = np.triu_indices(l, k=6)
    ecs = pd.DataFrame({
        "i": pos[ii], "A_i": "A", "j": pos[jj], "A_j": "V",
        "cn": rng.random(ii.size),
    }).sort_values("cn", ascending=False)
    coords = rng.normal(scale=8.0, size=(l, 3))
    dmat = np.linalg.norm(coords[:, None, :] - coords[None, :, :], axis=-1)
    residues = pd.DataFrame({"id": pos.astype(str)})
    return ecs, residues, dmat


def fold_prep_run(ecs, residues, dmat, out, n_restraints):
    """CNS distance restraints of the top n_restraints ECs written to
    `out` (fold/restraints, fold/cns), and the EC table compared with the
    distance map (compare/distances, compare/ecs)."""
    from evcouplings_torch.compare.distances import DistanceMap
    from evcouplings_torch.compare.ecs import coupling_scores_compared
    from evcouplings_torch.fold.cns import cns_dist_restraint
    from evcouplings_torch.fold.restraints import ec_dist_restraints

    dist_map = DistanceMap(residues, residues, dmat, symmetric=True)
    ec_dist_restraints(ecs.head(n_restraints), out, cns_dist_restraint)
    return coupling_scores_compared(ecs, dist_map, dist_cutoff=5.0,
                                    min_sequence_dist=6)


def _bench_fold_prep(shapes, device):
    """Fold-stage preparation: CNS restraints from the top ECs plus the
    contact-map comparison table."""
    l1 = shapes.fold_l
    ecs, residues, dmat = fold_prep_case(l1)
    tmp = tempfile.mkdtemp(prefix="bench_torch_fold_")
    try:
        t0 = time.perf_counter()
        compared = fold_prep_run(ecs, residues, dmat,
                                 os.path.join(tmp, "restraints.tbl"), 2 * l1)
        dt = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if "precision" not in compared.columns:
        raise RuntimeError("comparison table has no precision column")
    return {
        "fold_prep_value": round((2 * l1 + len(compared)) / dt, 1),
        "fold_prep_unit": "restraints+compared EC rows/s (L={})".format(l1),
        "fold_prep_ms": round(dt * 1e3, 2),
    }


def _family_config_records(shapes, device):
    out = {}
    for fn in (_bench_mi_apc, _bench_de_scan, _bench_evcomplex,
               _bench_fold_prep):
        out.update(fn(shapes, device))
    return out


# ---------------------------------------------------------------------
# reweighting records
# ---------------------------------------------------------------------

def reweight_case(n, l, q=21, seed=7):
    """Uniform codes with 512 planted near-copies (at most n / 2): a row
    copied onto another far from it with 10% of its sites redrawn, so
    that some counts exceed 1 (uniform rows match only themselves)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, q, size=(n, l)).astype(np.int8)
    rows = rng.choice(n, size=2 * min(512, n // 2), replace=False)
    src, dst = rows[0::2], rows[1::2]
    copies = codes[src].copy()
    redraw = rng.random(copies.shape) < 0.1
    copies[redraw] = rng.integers(0, q, size=int(redraw.sum()))
    codes[dst] = copies
    return codes


def reweight_library_route(codes, q, min_count, block):
    """The same counts by one library call per row block: torch._int_mm of
    a block of the int8 one-hot against the whole one-hot's transpose,
    thresholded at min_count and summed over the valid columns. The
    one-hot's rows are padded with zero rows to a multiple of `block` (a
    multiple of 8 above 16: the call's requirement on its operands)."""
    import torch

    if block % 8 or block <= 16:
        raise ValueError("block must be a multiple of 8 above 16, got "
                         "{}".format(block))
    n, L = codes.shape
    oh = torch.zeros((-(-n // block) * block, L * q), dtype=torch.int8,
                     device=codes.device)
    oh[:n] = (codes.long().unsqueeze(-1) == torch.arange(
        q, device=codes.device)).to(torch.int8).reshape(n, L * q)
    counts = torch.empty((n,), dtype=torch.int32, device=codes.device)
    for start in range(0, n, block):
        stop = min(start + block, n)
        ident = torch._int_mm(oh[start:start + block], oh.T)
        counts[start:stop] = (ident[:stop - start, :n] >= min_count).sum(
            dim=1, dtype=torch.int32)
    return counts


def _timed_peak(device, fn):
    """(fn(), its seconds between two synchronisations, the allocator's
    peak bytes during it above what was live before, or None on the
    host)."""
    import torch

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        live = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    secs = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device) - live if on_card
            else None)
    return out, secs, peak


def _bench_reweighting_512k(shapes, device):
    """K1 at n = reweight_big_n, L = 160 against the library route at the
    same shape: row pairs per second of one timed call each (after a warm
    call at 1024 rows that builds and loads everything), the bytes each
    route holds on the card (its peak above the codes, plus the codes),
    and the counts of both routes, which must be equal."""
    import torch

    from evcouplings_torch.ops.weights import (
        _identity_count_threshold, _neighbor_counts,
    )

    n, l, q = shapes.reweight_big_n, shapes.l, shapes.q
    codes = torch.as_tensor(reweight_case(n, l, q), device=device)
    min_count = _identity_count_threshold(l, 0.8)
    routes = {
        "kernel": lambda c: _neighbor_counts(c, min_count),
        "library": lambda c: reweight_library_route(
            c, q, min_count, shapes.library_block),
    }
    out = {"reweight_512k_rows": n}
    counts = {}
    for name, route in routes.items():
        route(codes[:1024])
        counts[name], dt, peak = _timed_peak(device, lambda: route(codes))
        out["reweight_512k_{}_pairs_per_s".format(name)] = round(
            n * n / dt, 1)
        out["reweight_512k_{}_hbm_bytes".format(name)] = (
            None if peak is None else peak + codes.numel())
    equal = bool(torch.equal(counts["kernel"].to(torch.int64),
                             counts["library"].to(torch.int64)))
    if not equal:
        bad = int((counts["kernel"].to(torch.int64)
                   != counts["library"].to(torch.int64)).sum())
        raise RuntimeError("reweighting: kernel and library counts differ "
                           "on {} of {} rows".format(bad, n))
    out["reweight_512k_counts_equal"] = equal
    out["reweight_512k_max_count"] = int(counts["kernel"].max())
    out["reweight_512k_library_block"] = shapes.library_block
    return out


def bench_reweighting(shapes, device):
    """Secondary (--all): reweighting throughput in row pairs per second
    at N = reweight_n through ops/weights.num_cluster_members (K1 on the
    card), host input to host-read result."""
    from evcouplings_torch.ops.weights import num_cluster_members

    n = shapes.reweight_n
    rng = np.random.default_rng(0)
    m = rng.integers(0, shapes.q, size=(n, shapes.l)).astype(np.int8)
    num_cluster_members(m[:1024], 0.8, device=device)   # warm small shape
    num_cluster_members(m, 0.8, device=device)          # warm full shape
    t0 = time.perf_counter()
    counts = num_cluster_members(m, 0.8, device=device)
    float(counts[0])                                    # host read
    elapsed = time.perf_counter() - t0
    return {
        "metric": "reweighting_row_pairs_per_s",
        "value": round(n * n / elapsed, 1),
        "unit": "row pairs/s {} (N={}, L={})".format(_per(device), n,
                                                   shapes.l),
        "vs_baseline": None,
    }


# ---------------------------------------------------------------------
# the hermetic monomer pipeline and the real-family fit
# ---------------------------------------------------------------------

def _write_pipeline_inputs(tmp, n_rows, l_cols, first_index=11,
                           seed=5):
    """Synthetic inputs for the hermetic monomer pipeline: a focus
    a2m with planted covarying column pairs, plus a SIFTS table and a
    local BinaryCIF structure in which exactly those pairs are true
    3D contacts (so the compare stage has signal, not just files)."""
    import pandas as pd

    from evcouplings_torch.compare import bcif

    rng = np.random.default_rng(seed)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    mat = np.empty((n_rows, l_cols), dtype="U1")
    for col in range(l_cols):
        mat[:, col] = rng.choice(
            aa, size=n_rows, p=rng.dirichlet(np.ones(20) * 0.4)
        )
    planted = [
        (c_i, c_j, conc)
        for (c_i, c_j, conc) in
        ((5, l_cols * 5 // 12, 0.9),
         (l_cols // 5, l_cols * 3 // 4, 0.8),
         (l_cols // 3, l_cols * 11 // 12, 0.7))
    ]
    for ci, cj, conc in planted:
        state = rng.integers(0, 2, size=n_rows)
        partner = np.where(
            rng.random(n_rows) < conc, state, 1 - state
        )
        mat[:, ci] = np.where(state == 0, "A", "W")
        mat[:, cj] = np.where(partner == 0, "C", "Y")
    mat[rng.integers(1, n_rows, 60), rng.integers(0, l_cols, 60)] = "-"

    a2m = os.path.join(tmp, "input.a2m")
    last = first_index + l_cols - 1
    with open(a2m, "w") as f:
        f.write(">TARGET_SEQ/{}-{}\n".format(first_index, last))
        f.write("".join(mat[0]) + "\n")
        for r in range(1, n_rows):
            f.write(">seq{}/1-{}\n{}\n".format(
                r, l_cols, "".join(mat[r])
            ))

    # structure: CA trace on a line, planted pairs bent to 3.8 A
    res_ids = np.arange(1, l_cols + 1)
    coords = np.zeros((l_cols, 3))
    coords[:, 0] = np.arange(l_cols) * 6.0
    for ci, cj, _ in planted:
        coords[cj] = coords[ci] + np.array([0.0, 3.8, 0.0])
    n = l_cols
    structure_dir = os.path.join(tmp, "structures")
    os.makedirs(structure_dir, exist_ok=True)
    bcif.write_bcif(os.path.join(structure_dir, "9zzz.bcif"), {
        "_atom_site": {
            "pdbx_PDB_model_num": np.ones(n, dtype=int),
            "group_PDB": ["ATOM"] * n,
            "id": res_ids,
            "type_symbol": ["C"] * n,
            "label_atom_id": ["CA"] * n,
            "auth_atom_id": ["CA"] * n,
            "label_alt_id": [""] * n,
            "label_comp_id": ["ALA"] * n,
            "auth_comp_id": ["ALA"] * n,
            "label_asym_id": ["A"] * n,
            "auth_asym_id": ["A"] * n,
            "label_entity_id": ["1"] * n,
            "label_seq_id": res_ids,
            "auth_seq_id": res_ids,
            "pdbx_PDB_ins_code": [""] * n,
            "Cartn_x": coords[:, 0],
            "Cartn_y": coords[:, 1],
            "Cartn_z": coords[:, 2],
            "occupancy": np.ones(n),
            "B_iso_or_equiv": np.full(n, 20.0),
            "pdbx_formal_charge": np.zeros(n, dtype=int),
        },
    })

    sifts_table = os.path.join(tmp, "sifts.csv")
    pd.DataFrame([{
        "pdb_id": "9zzz", "pdb_chain": "A",
        "uniprot_ac": "TARGET_SEQ",
        "resseq_start": 1, "resseq_end": l_cols,
        "coord_start": "1", "coord_end": str(l_cols),
        "uniprot_start": first_index, "uniprot_end": last,
    }]).to_csv(sifts_table, index=False)

    return a2m, structure_dir, sifts_table


def pipeline_config(tmp, a2m, structure_dir, sifts_table, device):
    """bench.py's four-stage job config without its figures: align
    `existing`, couplings `standard` 50 iterations, compare against the
    local structure drawing no figure; the mutate stage is left out of
    the job (mutate_matrix_only runs it after the job)."""
    glob = {"prefix": os.path.join(tmp, "out", "job"),
            "sequence_id": "TARGET_SEQ", "theta": 0.8}
    if device.type != "cuda":
        glob["device"] = str(device)
    return {
        "pipeline": "protein_monomer",
        "stages": ["align", "couplings", "compare"],
        "global": glob,
        "tools": {"jackhmmer": None, "hhfilter": None, "plmc": None},
        "databases": {},
        "align": {
            "protocol": "existing",
            "input_alignment": a2m,
            "first_index": None,
            "extract_annotation": False,
            "seqid_filter": None,
            "hhfilter": None,
            "minimum_sequence_coverage": 50,
            "minimum_column_coverage": 70,
            "compute_num_effective_seqs": True,
        },
        "couplings": {
            "protocol": "standard",
            "focus_mode": True,
            "alphabet": None,
            "ignore_gaps": False,
            "iterations": 50,
            "lambda_h": 0.01,
            "lambda_J": 0.01,
            "lambda_group": None,
            "lambda_J_times_Lq": True,
            "scale_clusters": None,
            "cpu": None,
            "reuse_ecs": False,
            "min_sequence_distance": 3,
            "scoring_model": "skewnormal",
            "frequencies_file": None,
        },
        "compare": {
            "protocol": "standard",
            "min_sequence_distance": 5,
            "pdb_mmtf_dir": structure_dir,
            "atom_filter": None,
            "compare_multimer": False,
            "distance_cutoff": 5,
            "scale_sizes": True,
            "pdb_ids": None,
            "max_num_hits": 25,
            "max_num_structures": 10,
            "sifts_mapping_table": sifts_table,
            "sifts_sequence_db": None,
            "by_alignment": False,
            "pdb_alignment_method": "jackhmmer",
            "alignment_min_overlap": 20,
            "sequence_file": None,
            "region": None,
            "use_bitscores": True,
            "domain_threshold": 0.5,
            "sequence_threshold": 0.5,
            "boundaries": "union",
            "draw_secondary_structure": False,
            "plot_probability_cutoffs": [],
            "plot_lowest_count": 2,
            "plot_highest_count": 1,
            "plot_increase": 1,
        },
        "management": {},
    }


def mutate_matrix_only(model_file, prefix):
    """The mutate stage's single-mutant matrix (epistatic and independent
    predictions) without its figures; returns the CSV's path."""
    from evcouplings_torch.couplings.model import CouplingsModel
    from evcouplings_torch.mutate.protocol import _single_mutant_table
    from evcouplings_torch.utils.system import create_prefix_folders

    create_prefix_folders(prefix)
    epistatic = CouplingsModel(model_file)
    path = prefix + "_single_mutant_matrix.csv"
    _single_mutant_table([("epistatic", epistatic),
                          ("independent", epistatic.to_independent_model())],
                         path)
    return path


def _run_pipeline_once(n_rows, l_cols, device):
    """One four-stage monomer job in a fresh working directory. Returns
    (total wall seconds, {stage: seconds})."""
    import pandas as pd

    from evcouplings_torch.utils import pipeline as pl
    from evcouplings_torch.utils.system import insert_dir

    tmp = tempfile.mkdtemp(prefix="bench_torch_e2e_")
    try:
        a2m, structure_dir, sifts_table = _write_pipeline_inputs(
            tmp, n_rows, l_cols)
        config = pipeline_config(tmp, a2m, structure_dir, sifts_table,
                                 device)
        t0 = time.perf_counter()
        state = pl.execute_wrapped(**config)
        t1 = time.perf_counter()
        state["mutation_matrix_file"] = mutate_matrix_only(
            state["model_file"],
            insert_dir(config["global"]["prefix"], "mutate"))
        mutate_s = time.perf_counter() - t1
        total = time.perf_counter() - t0

        # the chain produced its terminal artifacts
        for key in ("ec_compared_longrange_file", "mutation_matrix_file"):
            if not os.path.isfile(state[key]):
                raise RuntimeError("pipeline wrote no {}".format(key))
        runtime = pd.read_csv(state["runtime_file"])
        stages = runtime.groupby("scope").seconds.sum().to_dict()
        stages["mutate"] = mutate_s
        return total, stages
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _bench_pipeline_e2e(shapes, device):
    """Wall clock of the hermetic four-stage monomer job through
    utils/pipeline.execute_wrapped (align existing -> couplings -> compare
    against a local structure -> mutate, no figure drawn) with its
    per-stage split, then the same job again in a fresh working directory
    in this process."""
    n_rows, l_cols = shapes.pipeline_rows, shapes.pipeline_cols
    total, stage_s = _run_pipeline_once(n_rows, l_cols, device)
    out = {
        "pipeline_e2e_s": round(total, 2),
        "pipeline_e2e_shape": "N={}, L={}".format(n_rows, l_cols),
        "pipeline_e2e_unit": (
            "s wall of execute_wrapped and the mutate matrix, no figure "
            "drawn; warm: a second run in a fresh working directory in "
            "the same process, the kernels already built and loaded"),
    }
    for stage in ("align", "couplings", "compare", "mutate"):
        out["pipeline_{}_s".format(stage)] = round(
            float(stage_s.get(stage, 0.0)), 2)
    total_w, stage_w = _run_pipeline_once(n_rows, l_cols, device)
    out["pipeline_e2e_warm_s"] = round(total_w, 2)
    out["pipeline_couplings_warm_s"] = round(
        float(stage_w.get("couplings", 0.0)), 2)
    return out


def _bench_family_fit(device, a2m=REAL_FAMILY_A2M, l_cols=200,
                      iterations=150):
    """A real family: the alignment cut to its first l_cols match columns,
    fit with both parametrizations (symmetric and asymmetric, Adam), wall
    time, N_eff and the estimators' agreement. family_fit_skipped while
    the alignment is absent."""
    from scipy.stats import spearmanr

    from evcouplings_torch.align.alignment import Alignment
    from evcouplings_torch.couplings.fitter import run_plm
    from evcouplings_torch.couplings.pairs import read_raw_ec_file

    if not os.path.isfile(a2m):
        return {"family_fit_skipped": "reference alignment missing"}

    tmp = tempfile.mkdtemp(prefix="bench_torch_family_")
    try:
        ali = Alignment.from_path(a2m)
        sliced = os.path.join(tmp, "family.a2m")
        with open(sliced, "w") as f:
            ali.select(columns=range(l_cols)).write(f, format="fasta")
        focus = str(ali.ids[0])
        results, ecs = {}, {}
        for parametrization in ("symmetric", "asymmetric"):
            ec_file = os.path.join(tmp, parametrization + "_ECs.txt")
            t0 = time.perf_counter()
            res = run_plm(
                sliced, ec_file,
                os.path.join(tmp, parametrization + ".model"),
                focus_seq=focus, theta=0.8, iterations=iterations,
                lambda_h=0.01, lambda_J=0.01 * 20 * (l_cols - 1),
                parametrization=parametrization, solver="adam",
                steps_per_call=25, device=device,
            )
            results[parametrization] = time.perf_counter() - t0
            ecs[parametrization] = read_raw_ec_file(ec_file)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    merged = ecs["symmetric"].merge(
        ecs["asymmetric"], on=["i", "j"], suffixes=("_s", "_a"))
    half = l_cols // 2
    tops = [set(map(tuple, t.nlargest(half, "cn")[["i", "j"]].values))
            for t in ecs.values()]
    return {
        "family_fit_name": "{} ({})".format(
            os.path.splitext(os.path.basename(a2m))[0],
            os.path.basename(a2m)),
        "family_fit_sites": l_cols,
        "family_fit_rows": int(res.num_valid_seqs),
        "family_fit_n_eff": round(float(res.effective_samples), 1),
        "family_fit_iterations": iterations,
        "family_fit_sym_wall_s": round(results["symmetric"], 1),
        "family_fit_asym_wall_s": round(results["asymmetric"], 1),
        "family_fit_estimator_spearman": round(
            float(spearmanr(merged.cn_s, merged.cn_a).statistic), 4),
        "family_fit_top_half_overlap": round(
            len(tops[0] & tops[1]) / half, 3),
    }


# ---------------------------------------------------------------------
# the headline line and the secondaries
# ---------------------------------------------------------------------

def headline(shapes, device):
    """bench.py main()'s record, measured on `device`."""
    import torch

    from evcouplings_torch.ops.plm import PlmConfig

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        held = (torch.cuda.memory_reserved(device),
                torch.cuda.memory_allocated(device))
        torch.cuda.reset_peak_memory_stats(device)
    # production mode: bf16 compute with float32 masters; block 8192
    # takes the two-phase gradient layout
    production = PlmConfig(block_size=shapes.block, precision="default",
                           dtype="bfloat16", solver="adam")
    throughput = _plm_throughput(
        production, shapes.n, shapes, shapes.steps_per_call,
        shapes.warmup_calls, shapes.bench_calls, device)
    peaks = {
        "production_peak_reserved_bytes": (
            torch.cuda.max_memory_reserved(device) - held[0] if on_card
            else None),
        "production_peak_allocated_bytes": (
            torch.cuda.max_memory_allocated(device) - held[1] if on_card
            else None),
    }

    # parity mode: float32, "highest" (IEEE products), block 512 (the
    # carried layout); fewer rows and steps
    parity = PlmConfig(block_size=shapes.parity_block,
                       precision=PARITY_PRECISION, dtype="float32",
                       solver="adam")
    parity_throughput = _plm_throughput(
        parity, shapes.n_parity, shapes, max(1, shapes.steps_per_call // 3),
        1, 2, device)

    large_l = _large_l_throughput(shapes, device)
    parity_lbfgs, lbfgs_window = _parity_lbfgs_throughput(shapes, device)
    peak = device_peak(torch.cuda.get_device_name(device)) if on_card \
        else None

    return {
        "metric": "plm_fit_seq_sites_per_s",
        "value": round(throughput, 1),
        "unit": "seq*site/s " + _per(device),
        "vs_baseline": round(throughput / PLMC_32T_BASELINE, 2),
        "vs_measured_cpu": None,
        "vs_measured_cpu_note": (
            "not compared: benchmarks/cpu_baseline.json was measured on "
            "another machine's host"),
        "production_shape": "N={}, L={}, q={}, block {}".format(
            shapes.n, shapes.l, shapes.q, shapes.block),
        **peaks,
        "parity_mode_value": round(parity_throughput, 1),
        "parity_mode_vs_baseline": round(
            parity_throughput / PLMC_32T_BASELINE, 2),
        "parity_mode_vs_measured_cpu": None,
        # the complete plmc-replacement loop (native LBFGS at parity
        # numerics), not just the per-step value+grad cost
        "parity_lbfgs_value": round(parity_lbfgs, 1),
        "parity_lbfgs_vs_baseline": round(
            parity_lbfgs / PLMC_32T_BASELINE, 2),
        "parity_lbfgs_window_iterations": lbfgs_window,
        # large-L regime (the asymmetric per-site fit, ops/plm_sites.py)
        "large_l_sites": shapes.l_big,
        "large_l_rows": shapes.n_big,
        "large_l_value": round(large_l, 1),
        "large_l_vs_baseline": round(large_l / PLMC_32T_BASELINE, 2),
        **_mfu_records(throughput, parity_throughput, large_l, peak,
                       shapes),
        **_family_config_records(shapes, device),
        **_bench_pipeline_e2e(shapes, device),
        **_bench_family_fit(device, l_cols=shapes.family_cols,
                            iterations=shapes.family_iter),
        **_bench_reweighting_512k(shapes, device),
    }


def bench_lbfgs(shapes, device):
    """Secondary (--all): ms per iteration of the native LBFGS through
    fit_plm at float32, "default" (one bf16 limb pass on the card)."""
    from evcouplings_torch.ops.plm import PlmConfig, fit_plm

    n = shapes.secondary_n
    rng = np.random.default_rng(0)
    codes = rng.integers(0, shapes.q, size=(n, shapes.l)).astype(np.int8)
    w = rng.uniform(0.5, 1.0, size=n)
    cfg = PlmConfig(solver="lbfgs", max_iter=shapes.sec_lbfgs_iter,
                    steps_per_call=shapes.sec_lbfgs_steps, block_size=512,
                    dtype="float32", precision="default", conv_tol=0.0)
    stamps = []
    fit_plm(codes, w, shapes.q, cfg, callback=_stamper(stamps),
            device=device)
    warm, iters = _window_rate(stamps, "bench_lbfgs")
    return {
        "metric": "lbfgs_iteration_ms",
        "value": round(warm / iters * 1e3, 2),
        "unit": "ms/iteration (N={}, L={}, f32)".format(n, shapes.l),
        "vs_baseline": None,
    }


def bench_asym(shapes, device):
    """Secondary (--all): seq*site/s of the asymmetric fit (Adam, bf16)
    at the headline's L."""
    from evcouplings_torch.ops.plm import PlmConfig
    from evcouplings_torch.ops.plm_sites import fit_plm_asym

    n = shapes.secondary_n
    rng = np.random.default_rng(0)
    codes = rng.integers(0, shapes.q, size=(n, shapes.l)).astype(np.int8)
    w = rng.uniform(0.5, 1.0, size=n)
    cfg = PlmConfig(solver="adam", max_iter=shapes.sec_asym_iter,
                    steps_per_call=shapes.sec_asym_steps, block_size=1024,
                    dtype="bfloat16", precision="default", conv_tol=0.0)
    stamps = []
    fit_plm_asym(codes, w, shapes.q, cfg, callback=_stamper(stamps),
                 device=device)
    warm, iters = _window_rate(stamps, "bench_asym")
    return {
        "metric": "asym_plm_fit_seq_sites_per_s",
        "value": round(n * shapes.l * iters / warm, 1),
        "unit": "seq*site/s " + _per(device),
        "vs_baseline": None,
    }


def bench_asym_lbfgs(shapes, device):
    """Secondary (--all): ms per iteration of the batched per-site LBFGS
    of the asymmetric fit (float32, "default": one bf16 limb pass on the
    card)."""
    from evcouplings_torch.ops.plm import PlmConfig
    from evcouplings_torch.ops.plm_sites import fit_plm_asym

    n = shapes.secondary_n
    rng = np.random.default_rng(0)
    codes = rng.integers(0, shapes.q, size=(n, shapes.l)).astype(np.int8)
    w = rng.uniform(0.5, 1.0, size=n)
    cfg = PlmConfig(solver="lbfgs", max_iter=shapes.sec_asym_lbfgs_iter,
                    steps_per_call=shapes.sec_asym_lbfgs_steps,
                    block_size=2048, dtype="float32", precision="default",
                    conv_tol=0.0)
    stamps = []
    fit_plm_asym(codes, w, shapes.q, cfg, callback=_stamper(stamps),
                 device=device)
    warm, iters = _window_rate(stamps, "bench_asym_lbfgs")
    return {
        "metric": "asym_lbfgs_iteration_ms",
        "value": round(warm / iters * 1e3, 2),
        "unit": "ms/iteration " + _per(device),
        "vs_baseline": None,
    }


SECONDARIES = (bench_reweighting, bench_lbfgs, bench_asym, bench_asym_lbfgs)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Benchmark records of evcouplings_torch (bench.py's "
                    "twin).")
    parser.add_argument("--all", action="store_true",
                        help="also print the four secondary records")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; "
                             "raises without one)")
    parser.add_argument("--small", action="store_true",
                        help="every record at a reduced size (SMALL)")
    args = parser.parse_args(argv)

    from evcouplings_torch._device import resolve_device

    device = resolve_device(args.device)
    shapes = SMALL if args.small else BENCH
    identity = device_identity(device)
    print(json.dumps({**headline(shapes, device), **identity}), flush=True)
    if args.all:
        for fn in SECONDARIES:
            print(json.dumps({**fn(shapes, device), **identity}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
