#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port (evcouplings_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every kernel from the sources in this checkout, holds each kernel
against its plain version on the card, reproduces the golden parity fit,
then drives the port's main paths at the full width of the repository's
headline shape (N=16384 sequences, L=160 sites, q=21): run_plm (the
in-process plmc replacement) in parity and production mode (phase 5),
and the pipeline a user runs, execute_wrapped with stages align and
couplings, then the mutate protocol (phase 6; card against host at a
small size first). Phase 7 drives the couplings stage's other routes:
exact group-L1 by FISTA (against the certified prox oracle, then at full
width), checkpoint/resume (bitwise at full width), the asymmetric fit
(golden3, full width, "auto" routing) and mean-field DCA through the
pipeline. Phase 8 drives the compare stage: the float64 minimum-atom
distance contraction, card against host (8a); a small job through
align, couplings and compare, its compare artifacts card against host
(8b); and the full-width job through align, couplings, compare and
mutate against ten seeded structures in a local SIFTS table (8c). Phase
9 probes for HMMER and HHsuite, checks the Gibbs sampler on the card and
times its sweep at full width (9a), and drives the sample config's search
route (align `standard` with the hhfilter identity filter, compare
`by_alignment`) on fake search binaries: a small job card against host
(9b), then the full-width job (9c). Phase 10 probes for CNS, PSIPRED,
maxcluster, jinja2 and Python.h, holds the port's C alignment readers
against its Python readers at full width and times both (10a), and runs
the monomer pipeline's five stages (align, couplings, compare, mutate,
fold; the fold stage on fake CNS, PSIPRED and maxcluster binaries): a
small job card against host (10b), then the full-width job with the
sample config's fold settings (10c). Phase 11 runs the protein-complex
pipeline (two monomer alignments, align `complex` with local EMBL and ENA
tables, their concatenation, couplings, compare, mutate and fold
`complex`/`complex_dock`): small jobs card against host with both
concatenation protocols (11a), then the full-width job with the sample
complex config's settings (11b). Phase 12 drives the sharded fits over
torch.distributed on the one card: NCCL at world size 1 in this process
(12a: the parity and production fits on a one-rank mesh bitwise equal to
the fits without one, the couplings stage with fit_devices 1), three gloo
ranks that this script starts as `chip_smoke.py --phase12-worker ...`
(12b: K1 split into three tile ranges, the fits, the collective profile,
the sharded float64 inversion, the couplings stage with fit_devices 3,
all-reduce times) and a (2, 2) mesh of four (12c: the asymmetric fit).
Every
phase raises on a mismatch; nothing is caught, except that a machine
without matplotlib cannot draw the mutate stage's plots (nor the
complex concatenation's distance plot), which the script then names
before its last lines (the compare stage is then configured to draw no
figure). The last lines are a JSON object
describing each kernel, the card's name and power limit as nvidia-smi
reports them, and {"ok": true, "device": {...}}.

Exits non-zero without a result when no CUDA device is available or the
port's package is not beside this script. Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "data", "golden")
SEED = 20240611
ALPHABET = "-ACDEFGHIKLMNPQRSTVWY"

# H100 SXM published peaks (dense): HBM bytes/s, int8 tensor-core ops/s
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12
# cycles of one dependent float32 FMA (K4's chain) on Hopper
FMA_LATENCY_CYCLES = 4
# K4 serial chain latencies of the parity fit below before its dots were
# batched (74 launches)
PARITY_CHAINS_UNBATCHED = 74

# the 8 covarying column pairs planted in the full-width pipeline synthetic
# (0-based; phases 6b, 7d and 8)
PLANTED = [(3, 40), (12, 77), (25, 150), (51, 90), (60, 131), (84, 118),
           (99, 142), (107, 158)]

# golden-fit gate of the repository (tests/test_golden_regression.py)
RTOL, ATOL = 1e-4, 1e-5
# iterations up to which the asymmetric golden fit (golden3) on the card
# is held to the gate against the port's host path (phase 7c)
GOLDEN3_GATE_ITERATIONS = 12


def log(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps launches (after one warm-up),
    from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps):
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def synthetic_codes(rng, n, L, q, families, mutate, gap_rows, missing_rows):
    """(n, L) int8 codes: rows drawn from `families` random centres with a
    `mutate` fraction of sites resampled (duplicates and near-duplicates,
    so cluster counts exceed 1), a `gap_rows` fraction of rows with half
    their sites set to the gap code 0, and a `missing_rows` fraction with
    a tenth of their sites set to -1 (matches nothing)."""
    centres = rng.integers(0, q, size=(families, L))
    codes = centres[rng.integers(0, families, size=n)]
    resample = rng.random((n, L)) < mutate
    codes = np.where(resample, rng.integers(0, q, size=(n, L)), codes)
    gappy = rng.random(n) < gap_rows
    codes[gappy] = np.where(rng.random((int(gappy.sum()), L)) < 0.5, 0,
                            codes[gappy])
    missing = rng.random(n) < missing_rows
    codes[missing] = np.where(rng.random((int(missing.sum()), L)) < 0.1, -1,
                              codes[missing])
    return codes.astype(np.int8)


def write_a2m(path, codes):
    """Alignment in a2m: a gap-free focus row TARGET/1-L, then the rows."""
    n, L = codes.shape
    letters = np.array(list(ALPHABET))
    with open(path, "w") as f:
        f.write(">TARGET/1-{}\n{}\n".format(
            L, "".join(letters[1 + np.arange(L) % 20])))
        for i, row in enumerate(codes):
            f.write(">seq{}/1-{}\n{}\n".format(
                i, L, "".join(letters[np.maximum(row, 0)])))


def read_ec(path):
    import pandas as pd

    return pd.read_csv(path, sep=" ", header=None,
                       names=["i", "A_i", "j", "A_j", "fn", "cn"])


def assert_exact_rank_order(got, want, max_exempt_frac=0.02,
                            max_top_l_exempt=0, col="cn", rtol=RTOL,
                            atol=ATOL):
    """Every pair of ECs whose reference scores (column `col`) differ by
    more than the gate's tolerance must rank the same way in the refit; at
    most max_exempt_frac of all comparisons may be exempt as near-ties,
    and none among the top-L (the rule of the repository's golden
    gate)."""
    key = list(zip(want.i.values, want.j.values))
    want_cn = dict(zip(key, want[col].values))
    got_cn = dict(zip(zip(got.i.values, got.j.values), got[col].values))
    assert set(got_cn) == set(want_cn)
    n_sites = len(set(want.i.values) | set(want.j.values))
    ranked = sorted(key, key=lambda k: -want_cn[k])
    checked = exempt = top_l_exempt = 0
    for idx_a, a in enumerate(ranked):
        for idx_b in range(idx_a + 1, len(ranked)):
            b = ranked[idx_b]
            checked += 1
            gap = want_cn[a] - want_cn[b]
            tol = rtol * max(abs(want_cn[a]), abs(want_cn[b])) + atol
            if gap > tol:
                assert got_cn[a] > got_cn[b], (
                    "rank swap of distinguishable pair: {} ({}) vs {} "
                    "({})".format(a, got_cn[a], b, got_cn[b]))
            else:
                exempt += 1
                if idx_b < n_sites:
                    top_l_exempt += 1
    assert exempt / checked <= max_exempt_frac, exempt / checked
    assert top_l_exempt <= max_top_l_exempt, top_l_exempt
    return checked, exempt


def max_rel_excess(got, want):
    """max |got - want| / (ATOL + RTOL |want|): <= 1 passes the gate."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want) / (ATOL + RTOL * np.abs(want))))


def write_synthetic_a2m(path, N=150, L=18, seed=7):
    """The repository's small synthetic focus alignment (the generator of
    tests/test_protocols.py): random columns, three planted covarying
    column pairs of graded strength, a few gaps."""
    rng = np.random.default_rng(seed)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    mat = np.empty((N, L), dtype="U1")
    for col in range(L):
        probs = rng.dirichlet(np.ones(20) * 0.4)
        mat[:, col] = rng.choice(aa, size=N, p=probs)
    planted = [
        ((2, 9), ("A", "W"), ("C", "Y"), 0.90),
        ((4, 15), ("D", "R"), ("E", "K"), 0.78),
        ((6, 12), ("F", "L"), ("H", "T"), 0.68),
    ]
    for (ci, cj), (si0, si1), (sj0, sj1), conc in planted:
        state = rng.integers(0, 2, size=N)
        follow = rng.random(N) < conc
        partner = np.where(follow, state, 1 - state)
        mat[:, ci] = np.where(state == 0, si0, si1)
        mat[:, cj] = np.where(partner == 0, sj0, sj1)
    gap_rows = rng.integers(1, N, size=10)
    gap_cols = rng.integers(0, L, size=10)
    mat[gap_rows, gap_cols] = "-"
    with open(path, "w") as f:
        f.write(">TARGET_SEQ/11-{}\n".format(11 + L - 1))
        f.write("".join(mat[0]) + "\n")
        for k in range(1, N):
            f.write(">seq{}/1-{}\n{}\n".format(k, L, "".join(mat[k])))


def plant_pairs(rng, codes, pairs, concordance=0.9):
    """Overwrite each column pair (i, j) with a two-state covariation:
    per row a random state picks one of two symbols at i, and j follows
    it with the given concordance (independent of the rows' families)."""
    n = len(codes)
    for k, (i, j) in enumerate(pairs):
        state = rng.integers(0, 2, size=n)
        follow = rng.random(n) < concordance
        partner = np.where(follow, state, 1 - state)
        codes[:, i] = np.where(state == 0, 1 + k, 11 + k)
        codes[:, j] = np.where(partner == 0, 2 + k, 12 + k)
    return codes


def pipeline_config(prefix, a2m, sequence_id, align_kw, couplings_kw,
                    stages=("align", "couplings"), device=None):
    """A protein_monomer job config (device None: the card)."""
    glob = {"prefix": prefix, "sequence_id": sequence_id, "theta": 0.8}
    if device is not None:
        glob["device"] = device
    return {
        "pipeline": "protein_monomer", "stages": list(stages),
        "global": glob,
        "tools": {"jackhmmer": None, "hhfilter": None, "plmc": None},
        "databases": {},
        "align": {"protocol": "existing", "input_alignment": a2m,
                  "first_index": None, "seqid_filter": None,
                  "hhfilter": None, **align_kw},
        "couplings": {"protocol": "standard", "frequencies_file": None,
                      "focus_mode": True, "alphabet": None,
                      "ignore_gaps": False, "lambda_h": 0.01,
                      "lambda_J": 0.01, "lambda_group": None,
                      "lambda_J_times_Lq": True, "scale_clusters": None,
                      "cpu": None, **couplings_kw},
        "mutate": {"protocol": "standard", "mutation_dataset_file": None},
        "compare": {"protocol": "standard"},
        "fold": {"protocol": "standard"},
        "management": {},
    }


def run_mutate(model_file, prefix, not_produced, segments=None):
    """mutate `standard` on a fitted model (with segments: `complex`);
    returns (outcfg, seconds).

    Where matplotlib is not installed, the stage's plots (and the pymol
    scripts, whose colors come from matplotlib) cannot be made: that
    ModuleNotFoundError, and only it, is expected. The single-mutant
    matrix, which needs no matplotlib, is then computed as the stage
    computes it, and what was not produced is recorded in not_produced.
    """
    import importlib.util

    from evcouplings_torch.couplings.mapping import (
        MultiSegmentCouplingsModel, Segment,
    )
    from evcouplings_torch.couplings.model import CouplingsModel
    from evcouplings_torch.mutate import protocol as mutate
    from evcouplings_torch.mutate.calculations import (
        predict_mutation_table, single_mutant_matrix,
    )

    t = time.perf_counter()
    protocol = "standard" if segments is None else "complex"
    extra = {} if segments is None else {"segments": segments}
    try:
        out = mutate.run(protocol=protocol, prefix=prefix,
                         model_file=model_file, mutation_dataset_file=None,
                         **extra)
    except ModuleNotFoundError as e:
        if (e.name != "matplotlib"
                or importlib.util.find_spec("matplotlib") is not None):
            raise
        if segments is None:
            epistatic = CouplingsModel(model_file)
            others = [("independent", epistatic.to_independent_model())]
        else:
            epistatic = MultiSegmentCouplingsModel(
                model_file, *[Segment.from_list(s) for s in segments])
            others = [("independent", epistatic.to_independent_model()),
                      ("inter_segment", epistatic.to_inter_segment_model())]
        table = single_mutant_matrix(
            epistatic, output_column="prediction_epistatic")
        for tag, model in others:
            table = predict_mutation_table(model, table, "prediction_" + tag)
        out = {"mutation_matrix_file": prefix + "_single_mutant_matrix.csv"}
        table.to_csv(out["mutation_matrix_file"], index=False)
        not_produced.add(
            "mutate {}: {}_{{{}}}_model.pdf and .pml (matplotlib is not "
            "installed on this machine)".format(
                protocol, os.path.basename(prefix),
                ",".join(["epistatic"] + [tag for tag, _ in others])))
    return out, time.perf_counter() - t


def runtime_seconds(state):
    import pandas as pd

    table = pd.read_csv(state["runtime_file"])
    return dict(zip(table.scope, table.seconds))


# ---------------------------------------------------------------------------
# phase 7: the couplings stage's other fit routes (FISTA, checkpoint/resume,
# the asymmetric fit, mean-field DCA), each driven on the card at full width
# ---------------------------------------------------------------------------

def kernel_counts():
    """The launch counters of K1, K2, K3 and K4 (name -> wrapper)."""
    from evcouplings_torch.kernels import adam_update as k_adam
    from evcouplings_torch.kernels import reweight as k_reweight
    from evcouplings_torch.kernels import seqdot as k_seqdot

    return {"K1": k_reweight.neighbor_counts,
            "K2": k_adam.fused_adam_update_cuda,
            "K3": k_adam.fused_adam_update_presym_cuda,
            "K4": k_seqdot.sequential_dots}


def counted(fn):
    """fn() with every kernel counter set to 0 just before and read just
    after: (fn's result, {kernel: launches})."""
    import torch

    counters = kernel_counts()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}


def zero_pair_blocks(J_ij):
    L = J_ij.shape[0]
    norms = np.sqrt((J_ij ** 2).sum(axis=(2, 3)))[np.triu_indices(L, k=1)]
    return int(np.sum(norms == 0.0)), len(norms)


def block_gradient_norms(codes, weights, lambda_J):
    """Twice the norm of each pair block of the smooth objective's J
    gradient at J = 0, h = 0: the first FISTA prox step zeroes a block iff
    this is at most lambda_g. Returns the norms of the L(L-1)/2 pair
    blocks (numpy)."""
    import torch

    from evcouplings_torch._device import matmul_precision
    from evcouplings_torch.ops import plm as ops_plm
    from evcouplings_torch.ops.encode import pad_rows

    n, L = codes.shape
    codes_p, _ = pad_rows(np.asarray(codes, dtype=np.int8), 512)
    codes_p[n:] = -1
    w = torch.zeros(len(codes_p), dtype=torch.float32, device="cuda")
    w[:n] = torch.as_tensor(np.asarray(weights), device="cuda")
    vg = ops_plm.make_plm_value_and_grad(
        L, 21, ops_plm.PlmConfig(lambda_J=lambda_J), symmetric_params=True)
    params = {"J": torch.zeros((L * 21, L * 21), device="cuda"),
              "h": torch.zeros((L, 21), device="cuda")}
    with matmul_precision("highest"):
        _, grads = vg(params, torch.as_tensor(codes_p, device="cuda"), w)
    norms = 2 * grads["J"].reshape(L, 21, L, 21).pow(2).sum((1, 3)).sqrt()
    iu = torch.triu_indices(L, L, 1, device="cuda")
    return norms[iu[0], iu[1]].double().cpu().numpy()


def phase7a_fista(tmp, a2m, common):
    """FISTA: the card against the certified prox oracle (float64, the
    oracle suite's sparse case), then run_plm with lambda_g > 0 at full
    width (f32 "highest", 10 iterations)."""
    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import oracle_plm as oracle
    from evcouplings_torch.couplings.fitter import run_plm
    from evcouplings_torch.ops import plm as ops_plm

    codes = oracle.synthetic_msa(24, 6, 4, seed=17, n_coupled=2)
    w = np.ones(24)
    t = time.perf_counter()
    ref = oracle.fit_prox(codes, w, 4, lambda_h=0.01, lambda_J=0.05,
                          lambda_group=12.0, tol=1e-8, max_iter=3000)
    oracle_s = time.perf_counter() - t
    assert ref["result"]["converged"] and ref["kkt_margin"] > 0.1
    cfg = ops_plm.PlmConfig(lambda_h=0.01, lambda_J=0.05, lambda_group=12.0,
                            solver="fista", max_iter=1000, conv_tol=1e-9,
                            block_size=8, dtype="float64")
    t = time.perf_counter()
    fit = ops_plm.fit_plm(codes, w, 4, cfg, device="cuda")
    card_s = time.perf_counter() - t
    h_err = float(np.abs(fit.h_i - ref["h"]).max())
    J_err = float(np.abs(fit.J_ij - ref["J"]).max())
    bn = np.sqrt((fit.J_ij ** 2).sum(axis=(2, 3)))[np.triu_indices(6, k=1)]
    assert np.array_equal(np.flatnonzero(bn == 0.0),
                          np.sort(ref["zero_pairs"])), bn
    assert h_err <= 5e-6 and J_err <= 2e-6, (h_err, J_err)
    log("phase 7a FISTA vs the certified prox oracle (float64, L=6, q=4, "
        "1000 iterations on the card in {:.1f} s; oracle {:.1f} s on the "
        "host): zero set equal ({} of 15 pairs), max |h err| {:.2e} (5e-6), "
        "max |J err| {:.2e} (2e-6)".format(
            card_s, oracle_s, len(ref["zero_pairs"]), h_err, J_err))

    # lambda_g: a percentile of the pair blocks' first-step prox test with
    # the fit's sequence weights; at the median the first prox step keeps
    # about half the blocks, at the 25th percentile about three quarters
    from evcouplings_torch.couplings.fitter import prepare_alignment
    from evcouplings_torch.couplings.model import CouplingsModel
    from evcouplings_torch.ops.weights import num_cluster_members

    codes = prepare_alignment(a2m, focus_seq=common["focus_seq"])["codes"]
    weights = 1.0 / num_cluster_members(
        torch.as_tensor(codes, device="cuda"), common["theta"]).cpu().numpy()
    p1, p25, p50, p99 = np.quantile(
        block_gradient_norms(codes, weights, common["lambda_J"]),
        [0.01, 0.25, 0.5, 0.99])
    log("phase 7a twice the pair blocks' gradient norms at J = 0 (N_eff "
        "{:.1f} of N={}): 1st, 25th, 50th, 99th percentile {:.1f}, {:.1f}, "
        "{:.1f}, {:.1f}; lambda_g = the median, then the 25th "
        "percentile".format(weights.sum(), len(codes), p1, p25, p50, p99))
    main_counts = None
    for name, lambda_g in (("median", p50), ("25th percentile", p25)):
        table = []
        before = dict(ops_plm.fista_counts)
        (res, t_s), counts = counted(lambda: timed(lambda: run_plm(
            a2m, os.path.join(tmp, "fista_ECs.txt"),
            os.path.join(tmp, "fista.model"), iterations=10,
            lambda_g=lambda_g, solver=None, compute_dtype="float32",
            matmul_precision="highest", callback=table.append, **common)))
        steps = ops_plm.fista_counts["steps"] - before["steps"]
        backtracks = ops_plm.fista_counts["backtracks"] - before["backtracks"]
        fx = [r["fx"] for r in table]
        assert steps == 10 and len(fx) == 10 and np.all(np.isfinite(fx)), fx
        assert fx[-1] < fx[0], fx
        zeros, pairs = zero_pair_blocks(
            CouplingsModel(os.path.join(tmp, "fista.model")).J_ij)
        log("phase 7a FISTA run_plm N={} L={} (lambda_g {:.1f}, the {} -> "
            "solver fista, f32 highest): 10 iterations in {:.2f} s end to "
            "end, {:.4f} s per iteration in the fit loop, {:.2f} backtracks "
            "per iteration ({} trial evaluations in all), {} of {} pair "
            "blocks exactly zero, fx {:.2f} -> {:.2f}; launches {}".format(
                res.num_valid_seqs, res.num_valid_sites, lambda_g, name, t_s,
                (table[-1]["time"] - table[0]["time"]) / 9,
                backtracks / steps, steps + backtracks, zeros, pairs, fx[0],
                fx[-1], json.dumps(counts)))
        assert counts["K1"] == 1 and counts["K4"] == 0, counts
        main_counts = main_counts or counts
    return main_counts


def profile_device_time(what, fn, host_ops=True):
    """fn() once under torch.profiler: the wall time, the device's busy
    share of it, the GEMMs' share of the busy time, and the kernels with
    the most device time. Returns the wall and busy seconds and the
    number of device operations (kernels, copies, fills), or None when
    the profiler saw no device time. host_ops=False traces the device
    alone (a long host-bound stage: the host ops' trace takes longer to
    read than the stage)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        _, wall = timed(fn)
    # user annotations (a fit's plm_step_chunk ranges) enclose kernels
    # already counted: leave them out of the busy sum
    kern = [(getattr(e, "self_device_time_total", 0.0) / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)]
    busy = sum(ms for ms, _, _ in kern)
    if busy == 0:
        log("{} under the profiler: no device time (not measured)".format(
            what))
        return None
    gemm = sum(ms for ms, _, k in kern
               if any(t in k.lower() for t in ("gemm", "cutlass", "nvjet",
                                               "sm90_xmma")))
    top = sorted(kern, reverse=True)[:6]
    log("{} under the profiler: wall {:.3f} s, device busy {:.3f} s "
        "({:.1%}), GEMM kernels {:.1f} ms ({:.1%} of busy); top device "
        "time: {}".format(what, wall, busy / 1e3, busy / 1e3 / wall, gemm,
                          gemm / busy, "; ".join(
                              "{} x{} {:.1f} ms".format(k[:60], c, ms)
                              for ms, c, k in top)))
    return {"wall_s": wall, "busy_s": busy / 1e3,
            "launches": sum(c for _, c, _ in kern)}


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def phase7b_resume(tmp, codes, lambda_J):
    """Checkpoint/resume at full width: for each solver an uninterrupted
    fit of 2k iterations against one stopped at k and resumed to 2k, bit
    for bit; then a snapshot of another configuration must be refused.
    Deterministic algorithms are requested (warn_only) over the fits, and
    the warnings they raise are printed."""
    import warnings

    import torch

    from evcouplings_torch.ops.plm import PlmConfig, fit_plm

    weights = np.ones(len(codes))
    # FISTA at the median of the pair blocks' first-step prox test (unit
    # weights), so the prox zeroes blocks from the first step
    lambda_g = np.median(block_gradient_norms(codes, weights, lambda_J))
    cases = (
        ("parity lbfgs", 3, dict(solver="lbfgs", dtype="float32",
                                 precision="highest")),
        ("production adam (fused auto)", 5, dict(
            solver="adam", dtype="bfloat16", precision="default",
            block_size=8192)),
        ("fista", 3, dict(solver="fista", lambda_group=lambda_g,
                          dtype="float32", precision="highest")),
    )
    out = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for name, k, kw in cases:
                def cfg(n):
                    return PlmConfig(max_iter=n, conv_tol=0.0,
                                     lambda_J=lambda_J, **kw)
                ckpt = os.path.join(tmp, "resume_{}.npz".format(k))
                if os.path.exists(ckpt):
                    os.remove(ckpt)
                (ref, ref_s), counts = counted(lambda: timed(
                    lambda: fit_plm(codes, weights, 21, cfg(2 * k),
                                    device="cuda")))
                fit_plm(codes, weights, 21, cfg(k), checkpoint_file=ckpt,
                        checkpoint_every=k, device="cuda")
                snap_mb = os.path.getsize(ckpt) / 1e6
                res, res_s = timed(lambda: fit_plm(
                    codes, weights, 21, cfg(2 * k), checkpoint_file=ckpt,
                    checkpoint_every=k, device="cuda"))
                assert res.iteration_table[0]["iter"] == k + 1, name
                assert np.array_equal(res.J_ij, ref.J_ij), name
                assert np.array_equal(res.h_i, ref.h_i), name
                assert res.final_loss == ref.final_loss, name
                log("phase 7b {}: {} iterations uninterrupted ({:.2f} s) "
                    "and {} + {} resumed from a {:.0f} MB snapshot ({:.2f} s "
                    "for the resumed half): J_ij, h_i and the final loss "
                    "bitwise equal ({} of {} pair blocks zero); launches of "
                    "the uninterrupted fit {}".format(
                        name, 2 * k, ref_s, k, k, snap_mb, res_s,
                        *zero_pair_blocks(ref.J_ij), json.dumps(counts)))
                out[name] = counts
                if name.startswith("production"):
                    try:
                        fit_plm(codes, weights, 21, PlmConfig(
                            max_iter=2 * k, lambda_J=lambda_J,
                            adam_lr=1e-2, **kw),
                            checkpoint_file=ckpt, device="cuda")
                    except ValueError as e:
                        assert "DIFFERENT" in str(e), e
                    else:
                        raise AssertionError(
                            "a snapshot of another config was resumed")
                os.remove(ckpt)
        finally:
            torch.use_deterministic_algorithms(False)
    msgs = sorted({str(w.message).split(".")[0][:160] for w in caught})
    log("phase 7b another configuration's snapshot refused (ValueError); "
        "deterministic-algorithm warnings over the fits: {}".format(
            json.dumps(msgs) if msgs else "none"))
    return out


def phase7c_asymmetric(tmp, a2m, codes, common, golden_gate):
    """The asymmetric fit: golden3 on the card, full width (Adam bf16 and
    per-site LBFGS f32), and "auto" routing under a simulated budget."""
    import torch

    import evcouplings_torch.couplings.fitter as fitter
    from evcouplings_torch.couplings.fitter import run_plm
    from evcouplings_torch.couplings.model import CouplingsModel
    from evcouplings_torch.ops import plm as ops_plm
    from evcouplings_torch.ops.plm_sites import fit_plm_asym

    g3_kw = dict(focus_seq="TARGET_SEQ/11-28", theta=0.8, lambda_h=0.01,
                 lambda_J=16.15, parametrization="asymmetric",
                 solver="lbfgs", compute_dtype="float32",
                 matmul_precision="highest")

    def g3(device, iterations):
        tag = "g3_{}_{}".format(device, iterations)
        run_plm(os.path.join(GOLDEN, "golden.a2m"),
                os.path.join(tmp, tag + "_ECs.txt"),
                os.path.join(tmp, tag + ".model"), iterations=iterations,
                device=device, **g3_kw)
        return (read_ec(os.path.join(tmp, tag + "_ECs.txt")),
                CouplingsModel(os.path.join(tmp, tag + ".model")))

    # the card against the port's host path, iteration count by count
    # (all printed first); the gate holds up to GOLDEN3_GATE_ITERATIONS
    runs = {}
    for its in (8, 10, 12, 14, 16):
        runs[its] = g3("cuda", its), g3("cpu", its)
        excess, _ = golden_gate(*runs[its][0], *runs[its][1])
        log("phase 7c golden3 card vs host at {} iterations: excess over "
            "the 1e-4 gate {}".format(its, json.dumps(excess)))
    for its, ((card_ec, card_m), (host_ec, host_m)) in runs.items():
        if its <= GOLDEN3_GATE_ITERATIONS:
            excess, _ = golden_gate(card_ec, card_m, host_ec, host_m)
            assert max(excess.values()) <= 1.0, (its, excess)
            assert_exact_rank_order(card_ec, host_ec, max_exempt_frac=1.0,
                                    max_top_l_exempt=len(host_ec))
    want_ec = read_ec(os.path.join(GOLDEN, "golden3_ECs.txt"))
    want_m = CouplingsModel(os.path.join(GOLDEN, "golden3.model"))
    card_ec, card_m = g3("cuda", 25)
    excess, abs_err = golden_gate(card_ec, card_m, want_ec, want_m)
    log("phase 7c golden3 at 25 iterations on the card against the "
        "fixture: excess over the 1e-4 gate {}, max |err| {}".format(
            json.dumps(excess), json.dumps(abs_err)))
    # twice the drift one-ulp gradient noise causes on the host
    # (tests/test_torch_plm_sites.py::test_golden3_ulp_envelope)
    envelope = {"cn": 4e-3, "fn": 4e-3, "J_ij": 6e-3, "h_i": 0.5}
    assert all(abs_err[k] <= envelope[k] for k in envelope), abs_err
    log("phase 7c golden3 within the 1-ulp envelope {}".format(
        json.dumps(envelope)))

    # full width: the phase-5 synthetic, Adam bf16 and per-site LBFGS f32
    weights = np.ones(len(codes))
    out = {}
    for name, steps, kw in (
            ("adam bf16", 20, dict(solver="adam", dtype="bfloat16",
                                   precision="default", block_size=1024)),
            ("per-site lbfgs f32", 5, dict(solver="lbfgs", dtype="float32",
                                           precision="highest",
                                           block_size=1024))):
        table = []
        cfg = ops_plm.PlmConfig(max_iter=steps, conv_tol=0.0,
                                lambda_J=common["lambda_J"], **kw)
        (fit, secs), counts = counted(lambda: timed(lambda: fit_plm_asym(
            codes, weights, 21, cfg, callback=table.append,
            device="cuda")))
        fx = [r["fx"] for r in table]
        assert len(fx) == steps and np.all(np.isfinite(fx)), fx
        assert fx[-1] < fx[0] and np.isfinite(fit.J_ij).all(), fx
        step_ms = (table[-1]["time"] - table[0]["time"]) * 1e3 / (steps - 1)
        log("phase 7c asymmetric {} N={} L={}: {} steps in {:.2f} s, "
            "{:.2f} ms per step (steps 2..{}), fx {:.2f} -> {:.2f}; "
            "launches {}".format(name, *codes.shape, steps, secs, step_ms,
                                 steps, fx[0], fx[-1], json.dumps(counts)))
        out[name] = step_ms
        profile_device_time("phase 7c asymmetric " + name, lambda: (
            fit_plm_asym(codes, weights, 21, cfg, device="cuda")))

    # "auto" routes to the asymmetric fit when the symmetric estimate
    # passes 0.9 x the (simulated) device budget
    n_fit, L = codes.shape
    sym = ops_plm.estimate_fit_hbm_bytes(
        n_fit, L, 21, ops_plm.PlmConfig(block_size=512))
    asym = ops_plm.estimate_fit_hbm_bytes(
        n_fit, L, 21, ops_plm.PlmConfig(solver="adam", block_size=1024),
        "asymmetric")
    budget = int(1.05 * asym)
    assert sym > 0.9 * budget, (sym, asym)
    calls = []
    real = fitter.fit_plm_asym

    def spy(*args, **kw):
        calls.append(kw.get("device"))
        return real(*args, **kw)

    os.environ["EVCOUPLINGS_HBM_BYTES"] = str(budget)
    fitter.fit_plm_asym = spy
    try:
        (res, secs), counts = counted(lambda: timed(lambda: run_plm(
            a2m, os.path.join(tmp, "auto_ECs.txt"),
            os.path.join(tmp, "auto.model"), iterations=3, **common)))
    finally:
        fitter.fit_plm_asym = real
        del os.environ["EVCOUPLINGS_HBM_BYTES"]
    assert len(calls) == 1, calls
    log("phase 7c auto routing under EVCOUPLINGS_HBM_BYTES={} (symmetric "
        "estimate {:.0f} MB > 0.9 x budget, asymmetric {:.0f} MB): routed "
        "to the asymmetric fit, 3 Adam steps, run_plm {:.2f} s, status {!r}; "
        "launches {}".format(budget, sym / 1e6, asym / 1e6, secs,
                             res.optimization_status, json.dumps(counts)))
    return out


def mean_field_config(prefix, a2m, sequence_id, device=None):
    config = pipeline_config(
        prefix, a2m, sequence_id,
        dict(extract_annotation=False, minimum_sequence_coverage=50,
             minimum_column_coverage=70, compute_num_effective_seqs=True),
        {}, device=device)
    config["couplings"] = {
        "protocol": "mean_field", "frequencies_file": None,
        "focus_mode": True, "alphabet": None, "theta": 0.8,
        "pseudo_count": 0.5, "min_sequence_distance": 6,
        "ec_score_type": "cn", "scoring_model": "logistic_regression",
        "reuse_ecs": False}
    return config


def read_mf_ec(path):
    import pandas as pd

    return pd.read_csv(path, sep=" ", header=None, names=[
        "i", "A_i", "j", "A_j", "mi_raw", "mi_apc", "di", "cn"])


def phase7d_mean_field(tmp, small, full, big_L=500):
    """Mean-field DCA through execute_wrapped (align existing ->
    couplings mean_field): card against host at the small synthetic, then
    full width on the card; inversion times at the job's D = 20 L and at
    D = 20 big_L (10000)."""
    import torch

    from evcouplings_torch.ops import frequencies as freq
    from evcouplings_torch.ops import mean_field as mf

    jobs = {}
    for device in ("cuda", "cpu"):
        root = os.path.join(tmp, "mf_small_" + device)
        state, counts, secs = run_job(mean_field_config(
            os.path.join(root, "job"), small, "TARGET_SEQ",
            device=None if device == "cuda" else "cpu"))
        jobs[device] = state
        log("phase 7d mean-field small job on the {}: {:.2f} s, stages {}, "
            "launches {}".format(device, secs,
                                 json.dumps(runtime_seconds(state)),
                                 json.dumps(counts)))
        if device == "cuda":
            assert counts["K1"] == 2, counts
    card = read_mf_ec(jobs["cuda"]["raw_ec_file"])
    host = read_mf_ec(jobs["cpu"]["raw_ec_file"])
    assert (card.i.values == host.i.values).all()
    assert (card.j.values == host.j.values).all()
    ulp = {c: float(np.max(np.abs(card[c].values - host[c].values)))
           for c in ("mi_raw", "mi_apc", "di", "cn")}
    # printed to 6 decimals: at most one unit in the last place
    assert all(v <= 1e-6 + 1e-12 for v in ulp.values()), ulp
    assert_exact_rank_order(card, host, col="di", rtol=0, atol=1e-6)
    log("phase 7d small mean-field job, card vs host: raw EC files within "
        "{} (one unit in the 6th decimal at most), DI rank order exact for "
        "pairs more than 1e-6 apart".format(json.dumps(ulp)))

    before = (mf.direct_information.sweeps, mf.direct_information.syncs)
    state, counts, secs = run_job(mean_field_config(
        os.path.join(tmp, "mf_full", "job"), full, "TARGET"))
    sweeps = mf.direct_information.sweeps - before[0]
    syncs = mf.direct_information.syncs - before[1]
    stages = runtime_seconds(state)
    ec = read_mf_ec(state["raw_ec_file"])
    L = state["num_sites"]
    assert len(ec) == L * (L - 1) // 2 and np.isfinite(ec.di).all()
    assert counts["K1"] == 2, counts
    log("phase 7d mean-field full-width job N={} L={}: {:.2f} s, stages {}; "
        "DI {} sweeps, {} host reads of the active flags; launches "
        "{}".format(state["num_sequences"], state["num_sites"], secs,
                    json.dumps(stages), sweeps, syncs, json.dumps(counts)))

    # the stage's device pieces at this width, timed alone
    from evcouplings_torch.couplings.model import CouplingsModel

    model = CouplingsModel(state["model_file"], device="cuda")
    C = mf.compute_covariance_matrix(model.regularized_f_i,
                                     model.regularized_f_ij, device="cuda")
    inv64 = cuda_ms(lambda: mf.invert_covariance(C), 3)
    inv32 = cuda_ms(lambda: mf.invert_covariance_device(C), 3)
    t = time.perf_counter()
    mf.direct_information(model.J_ij, model.regularized_f_i, device="cuda")
    torch.cuda.synchronize()
    di_ms = (time.perf_counter() - t) * 1e3
    del C

    # D = 10000: a synthetic with L = 500 (q = 21, N = 4000), one f64
    # inversion of 800 MB
    rng = np.random.default_rng(SEED + 7)
    codes = synthetic_codes(rng, 4000, big_L, 21, families=64, mutate=0.3,
                            gap_rows=0.1, missing_rows=0.0)
    codes_d = torch.as_tensor(codes, device="cuda")
    w = np.ones(len(codes))
    f_i = freq.frequencies(codes_d, w, 21)
    f_ij = freq.pair_frequencies(codes_d, w, 21, f_i)
    from evcouplings_torch.couplings.mean_field import (
        regularize_frequencies, regularize_pair_frequencies,
    )
    C = mf.compute_covariance_matrix(
        regularize_frequencies(f_i), regularize_pair_frequencies(f_ij),
        device="cuda")
    big64 = cuda_ms(lambda: mf.invert_covariance(C), 1)
    big32 = cuda_ms(lambda: mf.invert_covariance_device(C), 1)
    assert torch.isfinite(mf.invert_covariance(C)).all()
    del C
    log("phase 7d inversion of -C: D={} float64 {:.3f} ms, float32 {:.3f} "
        "ms; D={} float64 {:.3f} ms, float32 {:.3f} ms; DI fixed point at "
        "L={} ({} pairs) {:.2f} ms; the couplings stage took {:.2f} "
        "s".format(20 * L, inv64, inv32, 20 * big_L, big64, big32, L,
                   L * (L - 1) // 2, di_ms, stages["couplings"]))
    return counts


# ---------------------------------------------------------------------------
# phase 8: the compare stage (SIFTS lookup, structure readers, the float64
# minimum-atom-distance contraction on the card, EC comparison) in the
# monomer pipeline after couplings. Structures and SIFTS tables are local
# files made from a seed (tests/compare_fixtures.py): the machine has
# no network, and the stage fetches only what is missing.
# ---------------------------------------------------------------------------

# every key the compare stage's outcfg carries when it finds structures
COMPARE_KEYS = (
    "ec_compared_all_file", "ec_compared_longrange_file",
    "pdb_structure_hits_file", "pdb_structure_hits_unfiltered_file",
    "distmap_monomer", "distmap_multimer", "distmap_monomer_residues_file",
    "distmap_monomer_files", "distmap_monomer_individual_files",
    "monomer_contacts_file", "distmap_multimer_files",
    "distmap_multimer_individual_files", "multimer_contacts_file",
    "remapped_pdb_files", "renumbered_pdb_files",
    "ec_lines_compared_pml_file", "contact_map_files")


def have_matplotlib():
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


def compare_config(structure_dir, sifts_table):
    """compare `standard` with the sample monomer config's settings
    (config/sample_config_monomer.txt, compare section), except that
    structures are found by a SIFTS lookup of sequence_id (by_alignment
    off: there is no HMMER) in a local table; where matplotlib is absent,
    plot settings that select no figure."""
    if have_matplotlib():
        plots = {"plot_probability_cutoffs": [0.90, 0.99],
                 "plot_lowest_count": 0.05, "plot_highest_count": 1.0,
                 "plot_increase": 0.05}
    else:
        plots = {"plot_probability_cutoffs": [], "plot_lowest_count": 2,
                 "plot_highest_count": 1, "plot_increase": 1}
    return {"protocol": "standard", "by_alignment": False,
            "pdb_alignment_method": "jackhmmer", "alignment_min_overlap": 20,
            "pdb_ids": None, "max_num_hits": 25, "max_num_structures": 10,
            "use_bitscores": True, "domain_threshold": 0.1,
            "sequence_threshold": 0.1, "compare_multimer": True,
            "distance_cutoff": 5, "atom_filter": None,
            "min_sequence_distance": 6, "boundaries": "union",
            "draw_secondary_structure": True, "scale_sizes": True,
            "raise_missing": False, "region": None,
            "pdb_mmtf_dir": structure_dir,
            "sifts_mapping_table": sifts_table, "sifts_sequence_db": None,
            **plots}


def write_structures(directory, structures, rows, truncated=()):
    """Each structure as <id>.bcif (the ids in `truncated` cut to half
    their bytes: they fail to load) and the SIFTS table; returns
    (structure dir, table path)."""
    import pandas as pd

    from evcouplings_torch.compare.bcif import write_bcif

    structure_dir = os.path.join(directory, "structures")
    os.makedirs(structure_dir, exist_ok=True)
    for pdb_id, cats in structures.items():
        path = os.path.join(structure_dir, pdb_id + ".bcif")
        write_bcif(path, cats)
        if pdb_id in truncated:
            with open(path, "rb") as f:
                data = f.read()
            with open(path, "wb") as f:
                f.write(data[:len(data) // 2])
    table = os.path.join(directory, "sifts.csv")
    pd.DataFrame(rows).to_csv(table, index=False)
    return structure_dir, table


def monomer_job(prefix, a2m, sequence_id, align_kw, couplings_kw,
                structure_dir, sifts_table):
    """[align, couplings, compare, mutate] on the card; without
    matplotlib the mutate stage is left out of the job (its plots cannot
    be drawn) and run_mutate follows it."""
    stages = ["align", "couplings", "compare"]
    if have_matplotlib():
        stages.append("mutate")
    config = pipeline_config(prefix, a2m, sequence_id, align_kw,
                             couplings_kw, stages=stages)
    config["compare"] = compare_config(structure_dir, sifts_table)
    return config


def stage_outcfg(config, stage):
    from evcouplings_torch.utils.config import read_config_file
    from evcouplings_torch.utils.system import insert_dir

    return read_config_file("{}_{}.outcfg".format(
        insert_dir(config["global"]["prefix"], stage), stage))


def phase8a(rng):
    """The contraction alone, card against the port's host path (both
    float64): the phase-8c structure (L=160, all heavy atoms, ragged, one
    single-atom residue), an asymmetric two-chain case and a 1000-residue
    chain. Returns {case: (card ms, host ms)}."""
    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import compare_fixtures as ss
    from evcouplings_torch.ops.distances import (
        _pad_atoms, block_bytes, min_atom_distances,
    )

    # full_structure_set's chain (same seed): every 8c structure is cut
    # from it
    base = ss.target_chain(160, PLANTED, np.random.default_rng(8))
    # residues 20-139 again, shifted by a few A: a partner chain in
    # contact along its length
    other = ss.sub_chain(base, 20, 140)
    other["xyz"] = np.round(other["xyz"] + rng.normal(scale=3.0, size=3), 3)
    big = ss.make_chain(rng, 1000)
    cases = (("L=160 heavy atoms, symmetric", base, base),
             ("160 x 120 two chains", base, other),
             ("1000-residue chain, symmetric", big, big))
    out = {}
    for name, ci, cj in cases:
        args = (ss.atom_ranges(ci), ci["xyz"], ss.atom_ranges(cj), cj["xyz"],
                ci is cj)
        t = time.perf_counter()
        host = min_atom_distances(*args, device="cpu")
        host_call_ms = (time.perf_counter() - t) * 1e3
        card = min_atom_distances(*args)
        err = float(np.abs(card - host).max())
        assert err <= 1e-9, (name, err)
        contacts = {}
        for cutoff in (5.0, 8.0):
            sets = []
            for d in (card, host):
                close = d <= cutoff
                if ci is cj:
                    close = np.triu(close, 1)
                sets.append(set(zip(*np.nonzero(close))))
            assert sets[0] == sets[1], (name, cutoff)
            contacts[cutoff] = len(sets[0])
        card_ms = cuda_ms(lambda: min_atom_distances(*args), 5)
        A_i = _pad_atoms(args[0], args[1])[1].shape[1]
        A_j = _pad_atoms(args[2], args[3])[1].shape[1]
        n_i, n_j = len(args[0]), len(args[2])
        log("phase 8a min_atom_distances {} ({} x {} residues, {} x {} "
            "atoms): card vs host max |d diff| {:.2e} A (1e-9), contact "
            "sets equal ({} pairs at 5 A, {} at 8 A); card {:.3f} ms per "
            "call (CUDA events, 5 calls), host {:.1f} ms (one call, torch "
            "float64 on the CPU); largest block {:.1f} MB".format(
                name, n_i, n_j, int(np.sum(ci["counts"])),
                int(np.sum(cj["counts"])), err, contacts[5.0],
                contacts[8.0], card_ms, host_call_ms,
                block_bytes(min(512, n_i), A_i, n_j, A_j) / 1e6))
        out[name] = (card_ms, host_call_ms)
    del big
    torch.cuda.empty_cache()
    return out


def phase8b(tmp, small, align_kw, not_produced):
    """The small job (the phase-6a generator, N=150, L=18) through [align,
    couplings, compare(, mutate)] on the card against three seeded
    structures (one a homodimer); then the compare stage alone on the host
    (device cpu) over a copy of the card job's tree, so that both read the
    same alignment and ECs (the two fits differ in their last bits, phase
    6a). Every compare artifact must agree. Returns the card job's
    launches."""
    import shutil

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import compare_fixtures as ss

    root = os.path.join(tmp, "compare_small")
    structure_dir, table = write_structures(root,
                                            *ss.small_structure_set())
    couplings_kw = dict(iterations=12, reuse_ecs=False,
                        min_sequence_distance=3, scoring_model="skewnormal")
    card_root = os.path.join(root, "card")
    config = monomer_job(os.path.join(card_root, "job"), small, "TARGET_SEQ",
                         align_kw, couplings_kw, structure_dir, table)
    state, counts, secs = run_job(config)
    assert counts["K1"] == 2, counts
    if "mutate" not in config["stages"]:
        run_mutate(state["model_file"], os.path.join(card_root, "mutate",
                                                     "job"), not_produced)
    host_root = os.path.join(root, "host")
    shutil.copytree(card_root, host_root)
    host_config = dict(config, stages=["compare"], **{"global": dict(
        config["global"], prefix=os.path.join(host_root, "job"),
        device="cpu")})
    _, _, host_secs = run_job(host_config)

    got, want = stage_outcfg(config, "compare"), stage_outcfg(host_config,
                                                              "compare")
    compared, err = ss.assert_same_compare_artifacts(got, want, card_root,
                                                     host_root)
    assert compared >= 14, compared
    log("phase 8b small job [{}] on the card {:.2f} s (stages {}), the "
        "compare stage alone on the host {:.2f} s: {} compare artifacts "
        "equal (hits, contacts, maps, compared ECs, {} remapped and "
        "renumbered PDB files and the .pml byte for byte), max |dist "
        "diff| {:.2e} A; launches {}".format(
            ", ".join(config["stages"]), secs,
            json.dumps(runtime_seconds(state)), host_secs, compared,
            len(got["remapped_pdb_files"]) + len(got["renumbered_pdb_files"]),
            err, json.dumps(counts)))
    return counts


def phase8c(tmp, full, align_kw, couplings_kw, not_produced):
    """The full-width job: the phase-6b planted synthetic (N=16384 + focus,
    L=160) through [align, couplings (parity, 5 iterations), compare(,
    mutate)] against ten seeded structures of the target (homodimers,
    sub-ranges, a two-segment mapping, a chain named "NA", one truncated
    file that is skipped). The compare stage's time is split by wrapping
    the functions it calls. Returns the job's launches."""
    import pandas as pd

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import compare_fixtures as ss
    import evcouplings_torch.compare.distances as cd
    import evcouplings_torch.compare.protocol as cp

    root = os.path.join(tmp, "compare_full")
    structures, rows = ss.full_structure_set(160, PLANTED)
    structure_dir, table = write_structures(root, structures, rows,
                                            truncated=("1t10",))
    config = monomer_job(os.path.join(root, "job"), full, "TARGET",
                         align_kw, couplings_kw, structure_dir, table)

    split = dict.fromkeys(("SIFTS lookup", "structure load",
                           "distance maps", "of which the contraction",
                           "EC comparison"), 0.0)
    wrapped = (("SIFTS lookup", cp, "_identify_structures"),
               ("structure load", cp, "load_structures"),
               ("distance maps", cp, "intra_dists"),
               ("distance maps", cp, "multimer_dists"),
               ("of which the contraction", cd, "min_atom_distances"),
               ("EC comparison", cp, "coupling_scores_compared"))
    originals = [(module, name, getattr(module, name))
                 for _, module, name in wrapped]

    def timing(part, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                split[part] += time.perf_counter() - t
        return run

    for part, module, name in wrapped:
        setattr(module, name, timing(part, getattr(module, name)))
    try:
        state, counts, secs = run_job(config)
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)
    assert counts["K1"] == 2, counts
    missing = [k for k in COMPARE_KEYS if k not in state
               or (state[k] is None and k != "contact_map_files")]
    assert not missing, missing
    hits = pd.read_csv(state["pdb_structure_hits_file"],
                       keep_default_na=False)
    assert len(hits) == 13 and "NA" in set(hits.pdb_chain), hits
    assert len(state["remapped_pdb_files"]) == 12     # 1t10 skipped
    longrange = pd.read_csv(state["ec_compared_longrange_file"])
    top8 = longrange.iloc[:8]
    want8 = {(i + 1, j + 1) for i, j in PLANTED}
    assert set(zip(top8.i, top8.j)) == want8, top8
    assert (top8.precision == 1.0).all() and (top8.dist <= 5).all(), top8
    stages = runtime_seconds(state)
    rest = stages["compare"] - (split["SIFTS lookup"]
                                + split["structure load"]
                                + split["distance maps"]
                                + split["EC comparison"])
    mut_secs = 0.0
    if "mutate" not in config["stages"]:
        _, mut_secs = run_mutate(state["model_file"], os.path.join(
            root, "mutate", "job"), not_produced)
    log("phase 8c full-width job [{}] N={} L={}: {:.2f} s; stages {}; "
        "top 8 long-range compared ECs = the 8 planted pairs, precision "
        "1.0, max dist {:.3f} A; 13 chains of 10 structures (1t10 "
        "truncated, skipped), {} compared pairs ({} long-range); compare "
        "stage split (s): {}, writing and the rest {:.3f}; mutate {:.2f} "
        "s; launches {}".format(
            ", ".join(config["stages"]), state["num_sequences"],
            state["num_sites"], secs, json.dumps(stages),
            float(top8.dist.max()),
            len(pd.read_csv(state["ec_compared_all_file"])), len(longrange),
            json.dumps({k: round(v, 4) for k, v in split.items()}), rest,
            mut_secs, json.dumps(counts)))
    return counts


# ---------------------------------------------------------------------------
# phase 9: the Gibbs sampler (9a) and the sequence-search protocols: align
# `standard` (jackhmmer, the hhfilter identity filter) and compare
# by_alignment, card against host at a small size (9b) and at full width
# (9c). The machine has no HMMER, HHsuite or sequence database: the search
# binaries are bash scripts that keep the tools' command lines and return
# prepared outputs (tests/search_fixtures.py), as the JAX package's own
# tests drive them; real binaries are probed and reported.
# ---------------------------------------------------------------------------

SEARCH_TOOLS = ("jackhmmer", "hmmbuild", "hmmsearch", "hmmscan", "hhfilter")
# the fake binaries and their prepared outputs are written inside the
# checkout (build/ is git-ignored), where the kernels are built and run:
# a temporary directory may be mounted without execute permission
SEARCH_DIR = os.path.join(HERE, "build", "chip_smoke_search")


def phase9_probe():
    import shutil

    found = {tool: shutil.which(tool) for tool in SEARCH_TOOLS}
    log("phase 9 probe (shutil.which): {}".format(json.dumps(found)))
    return found


def phase9a_sampler(L=160, q=21, S=4096, sweeps=50):
    """The sampler on the card: exactness checks at tiny sizes, then ms
    per sweep at full width (L=160, q=21, S=4096, 50 sweeps) against the
    bytes a sweep of this formulation moves."""
    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import sampling_fixtures as sfx
    from evcouplings_torch.ops.sampling import gibbs_sample

    J, h = sfx.tiny_model(0, 3, 3)
    codes, _ = gibbs_sample(J, h, 20000, 60, seed=1)
    tv = sfx.total_variation(codes, sfx.boltzmann(J, h), 3)
    assert tv < 0.03, tv
    again, _ = gibbs_sample(J, h, 20000, 60, seed=1)
    assert np.array_equal(codes, again)
    L4 = 4
    h0 = np.random.default_rng(1).normal(size=(L4, 4))
    uniform, _ = gibbs_sample(np.zeros((L4, L4, 4, 4)), h0, 8000, 10, seed=2,
                              beta=0.0)
    freqs = np.stack([np.bincount(uniform[:, i].astype(int), minlength=4)
                      / 8000 for i in range(L4)])
    uni_err = float(np.abs(freqs - 0.25).max())
    assert uni_err <= 0.03, uni_err
    J, h = sfx.tiny_model(21, 7, 5, h_scale=1.0, J_scale=0.5)
    init = np.random.default_rng(22).integers(0, 5, (256, 7))
    want, gap = sfx.argmax_chain(J, h, init, 4)
    assert gap > 1e-3, gap
    card, _ = gibbs_sample(J, h, 256, 4, init_codes=init, beta=1e6, seed=5)
    host, _ = gibbs_sample(J, h, 256, 4, init_codes=init, beta=1e6, seed=5,
                           device="cpu")
    assert np.array_equal(card, host) and np.array_equal(card, want)
    log("phase 9a sampler checks on the card: Boltzmann L=3 q=3 (20000 "
        "chains, 60 sweeps) TV {:.4f} (< 0.03), the same seed twice equal; "
        "beta=0 max |f - 1/q| {:.4f} (0.03); beta=1e6 card = host = the "
        "float64 argmax chain code for code (smallest logit gap {:.4f} > "
        "1e-3)".format(tv, uni_err, gap))

    # full width: a seeded model with couplings of plausible scale
    rng = np.random.default_rng(SEED + 9)
    h = rng.normal(scale=0.5, size=(L, q))
    J = rng.normal(scale=0.05, size=(L, L, q, q))
    J = 0.5 * (J + J.transpose(1, 0, 3, 2))
    J[np.arange(L), np.arange(L)] = 0.0
    out = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        def run():
            return gibbs_sample(J, h, S, sweeps, seed=3, dtype=dtype)
        (codes, _), secs = timed(run)
        (codes2, _), secs2 = timed(run)
        assert np.array_equal(codes, codes2)
        assert codes.shape == (S, L) and 0 <= codes.min() and codes.max() < q
        prof = profile_device_time("phase 9a sampler " + name, run)
        nbytes = 2 if dtype == torch.bfloat16 else 4
        lq = L * q
        # per site: the one-hot state and the site's rows read, the
        # logits written (compute dtype), the site's Gumbel block read
        per_sweep = L * (S * lq * nbytes + lq * q * nbytes
                         + S * q * nbytes + S * q * 4)
        bound_ms = per_sweep / HBM_BYTES_PER_S * 1e3
        ms = min(secs, secs2) * 1e3 / sweeps
        out[name] = dict(ms_per_sweep=ms, bound_ms=bound_ms,
                         launches_per_sweep=(prof["launches"] / sweeps
                                             if prof else None),
                         busy=(prof["busy_s"] / prof["wall_s"]
                               if prof else None))
        log("phase 9a sampler full width L={} q={} S={} {} sweeps {}: "
            "{:.3f} ms per sweep (best of two calls, host clock after "
            "sync; {:.2f} s and {:.2f} s), byte bound {:.3f} ms per sweep "
            "({:.2f} GB: the {:.1f} MB one-hot read at each of the L "
            "sites), {} device operations per sweep, device busy {}; "
            "state {:.1f} MB, flattened J {:.1f} MB".format(
                L, q, S, sweeps, name, ms, secs, secs2, bound_ms,
                per_sweep / 1e9, S * lq * nbytes / 1e6,
                "{:.1f}".format(out[name]["launches_per_sweep"])
                if prof else "not measured",
                "{:.1%}".format(out[name]["busy"]) if prof
                else "not measured", S * lq * nbytes / 1e6,
                lq * lq * nbytes / 1e6))
    return out


def search_config(prefix, files, structure_dir, couplings_kw, stages,
                  device=None, seqid_filter=None, min_overlap=20):
    """The sample monomer config's align and compare sections
    (config/sample_config_monomer.txt: align protocol standard, compare
    by_alignment) on the fake binaries and files of
    search_fixtures.search_job_files; N_eff is computed in the align
    stage."""
    config = pipeline_config(prefix, None, files["sequence_id"], {},
                             couplings_kw, stages=stages, device=device)
    config["global"].update(sequence_file=files["sequence_file"],
                            region=None, cpu=None)
    config["tools"] = {"jackhmmer": files["jackhmmer"],
                       "hhfilter": files["hhfilter"], "hmmbuild": None,
                       "hmmsearch": None, "plmc": None}
    config["databases"] = {
        "uniref90": files["uniref90"],
        "sequence_download_url": "http://invalid.example/{}.fasta",
        "sifts_mapping_table": files["sifts_mapping_table"],
        "sifts_sequence_db": files["sifts_sequence_db"]}
    config["align"] = {
        "protocol": "standard", "first_index": files["first_index"],
        "iterations": 5, "database": "uniref90", "use_bitscores": True,
        "domain_threshold": 0.5, "sequence_threshold": 0.5,
        "checkpoints_hmm": False, "checkpoints_ali": False, "nobias": False,
        "reuse_alignment": True, "seqid_filter": seqid_filter,
        "minimum_sequence_coverage": 50, "minimum_column_coverage": 70,
        "compute_num_effective_seqs": True, "extract_annotation": True}
    compare = compare_config(structure_dir, None)
    for key in ("sifts_mapping_table", "sifts_sequence_db"):
        compare.pop(key)
    compare.update(by_alignment=True, alignment_min_overlap=min_overlap)
    config["compare"] = compare
    return config


def search_files(directory, a2m, rows, small):
    """search_job_files (tests/search_fixtures.py) plus the target's id
    and numbering."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import search_fixtures as sf

    files = sf.search_job_files(directory, a2m, rows, small=small)
    header = sf.read_rows(a2m)[0][0]
    name, span = header.split("/")
    files.update(sequence_id=name, first_index=int(span.split("-")[0]))
    return files


def phase9b(tmp, small, not_produced):
    """The small job (the phase-6a generator, N=150, L=18): align standard
    with seqid_filter (the fake hhfilter drops every 7th row), couplings,
    compare by_alignment (the fake jackhmmer finds the three seeded
    structures, 3ccc through a homolog), mutate, on the card; the align
    stage alone on the host, and the compare stage alone on the host over
    a copy of the card job's tree (the two fits differ in their last
    bits). The .a2m, the align CSVs and every compare artifact must be
    equal. Returns the card job's launches."""
    import shutil

    import pandas as pd

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import compare_fixtures as ss

    root = os.path.join(tmp, "search_small")
    structures, rows = ss.small_structure_set()
    structure_dir, _ = write_structures(root, structures, rows)
    files = search_files(os.path.join(SEARCH_DIR, "small"), small, rows,
                         True)
    couplings_kw = dict(iterations=12, reuse_ecs=False,
                        min_sequence_distance=3, scoring_model="skewnormal")
    stages = ["align", "couplings", "compare"]
    if have_matplotlib():
        stages.append("mutate")
    card_root = os.path.join(root, "card")
    config = search_config(os.path.join(card_root, "job"), files,
                           structure_dir, couplings_kw, stages,
                           seqid_filter=95, min_overlap=10)
    state, counts, secs = run_job(config)
    assert counts["K1"] == 2, counts
    if "mutate" not in stages:
        run_mutate(state["model_file"], os.path.join(card_root, "mutate",
                                                     "job"), not_produced)
    host_align = search_config(os.path.join(root, "host_align", "job"),
                               files, structure_dir, couplings_kw, ["align"],
                               device="cpu", seqid_filter=95,
                               min_overlap=10)
    host, _, host_align_secs = run_job(host_align)
    equal = []
    for key in ("alignment_file", "raw_focus_alignment_file",
                "identities_file", "frequencies_file",
                "sequence_weights_file", "annotation_file"):
        with open(state[key]) as a, open(host[key]) as b:
            assert a.read() == b.read(), key
        equal.append(key)
    got, want = (pd.read_csv(x["statistics_file"]).drop(columns="prefix")
                 for x in (state, host))
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert state["num_sequences"] == host["num_sequences"]
    host_root = os.path.join(root, "host")
    shutil.copytree(card_root, host_root)
    host_config = dict(config, stages=["compare"], **{"global": dict(
        config["global"], prefix=os.path.join(host_root, "job"),
        device="cpu")})
    _, _, host_secs = run_job(host_config)
    got, want = (stage_outcfg(config, "compare"),
                 stage_outcfg(host_config, "compare"))
    compared, err = ss.assert_same_compare_artifacts(got, want, card_root,
                                                     host_root)
    hits = pd.read_csv(got["pdb_structure_hits_file"])
    assert set(hits.pdb_id) == {"1aaa", "2bbb", "3ccc"}, hits
    log("phase 9b small search job [{}] on the card {:.2f} s (stages {}; "
        "hhfilter dropped {} rows, {} sequences after the filters), align "
        "on the host {:.2f} s, compare on the host {:.2f} s: .a2m and the "
        "align CSVs equal ({} files + statistics), {} compare artifacts "
        "equal ({} structure hits by sequence search), max |dist diff| "
        "{:.2e} A; launches {}".format(
            ", ".join(stages), secs, json.dumps(runtime_seconds(state)),
            len(files["dropped"]), state["num_sequences"], host_align_secs,
            host_secs, len(equal), compared, len(hits), err,
            json.dumps(counts)))
    return counts


def phase9c(tmp, full, couplings_kw, not_produced):
    """The full-width job: the phase-6b planted synthetic (N=16384 + the
    query, L=160) returned by the fake jackhmmer as Stockholm, through
    align standard (N_eff), couplings (parity), compare by_alignment
    against the ten seeded structures of phase 8c (the fake search of the
    SIFTS sequence file finds the target's entry) and mutate. Returns the
    job's launches."""
    import pandas as pd

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import compare_fixtures as ss
    from evcouplings_torch.align.alignment import Alignment

    root = os.path.join(tmp, "search_full")
    structures, rows = ss.full_structure_set(160, PLANTED)
    structure_dir, _ = write_structures(root, structures, rows,
                                        truncated=("1t10",))
    t = time.perf_counter()
    files = search_files(os.path.join(SEARCH_DIR, "full"), full, rows,
                         False)
    prep_secs = time.perf_counter() - t
    uniref_sto = os.path.join(SEARCH_DIR, "full", "uniref.sto")
    t = time.perf_counter()
    raw = Alignment.from_path(uniref_sto, "stockholm", device="cpu")
    read_secs = time.perf_counter() - t
    mb = os.path.getsize(uniref_sto) / 1e6
    stages = ["align", "couplings", "compare"]
    if have_matplotlib():
        stages.append("mutate")
    config = search_config(os.path.join(root, "job"), files, structure_dir,
                           couplings_kw, stages)
    state, counts, secs = run_job(config)
    assert counts["K1"] == 2 and counts["K4"] > 0, counts
    mut_secs = 0.0
    if "mutate" not in stages:
        _, mut_secs = run_mutate(state["model_file"], os.path.join(
            root, "mutate", "job"), not_produced)
    hits = pd.read_csv(state["pdb_structure_hits_file"],
                       keep_default_na=False)
    assert len(hits) == 13 and "NA" in set(hits.pdb_chain), hits
    longrange = pd.read_csv(state["ec_compared_longrange_file"])
    top8 = longrange.iloc[:8]
    want8 = {(i + 1, j + 1) for i, j in PLANTED}
    assert set(zip(top8.i, top8.j)) == want8, top8
    assert (top8.precision == 1.0).all() and (top8.dist <= 5).all(), top8
    log("phase 9c full-width search job [{}] N={} ({} rows searched, "
        "N_eff {:.1f}) L={}: {:.2f} s; stages {}; mutate {:.2f} s; the "
        "{:.1f} MB Stockholm result read by Alignment.from_path (the C "
        "reader) {:.2f} s ({} x {}); fake search files written in {:.2f} "
        "s; {} "
        "structure hits by sequence search; top 8 long-range compared ECs "
        "= the 8 planted pairs, precision 1.0; launches {}".format(
            ", ".join(stages), state["num_sequences"], raw.N,
            state["effective_sequences"], state["num_sites"], secs,
            json.dumps(runtime_seconds(state)), mut_secs, mb, read_secs,
            raw.N, raw.L, prep_secs, len(hits), json.dumps(counts)))
    return counts


# ---------------------------------------------------------------------------
# phase 10: the native alignment readers (A20) and the fold stage (A19b).
# The readers are host C (csrc/fasta_io.c, stockholm_io.c, built with cc in
# phase 1); the fold stage is host code that runs CNS, PSIPRED and
# maxcluster, which the machine does not have: fake binaries keep their
# command lines (tests/fold_fixtures.py). The five-stage job's device work
# is its couplings stage (K1, K4) and compare's distances.
# ---------------------------------------------------------------------------

FOLD_TOOLS = ("cns", "runpsipred", "maxcluster")
# inside the checkout (build/ is git-ignored), as phase 9's fakes
FOLD_DIR = os.path.join(HERE, "build", "chip_smoke_fold")
FIVE_STAGES = ["align", "couplings", "compare", "mutate", "fold"]


def phase10_probe():
    """Recorded, gating nothing: the folding binaries on PATH, jinja2
    (the fold stage renders its CNS scripts with it) and Python.h (the JAX
    package's CPython loaders would need it; the port's readers do not)."""
    import importlib.util
    import shutil
    import sysconfig

    found = {tool: shutil.which(tool) for tool in FOLD_TOOLS}
    found["jinja2"] = importlib.util.find_spec("jinja2") is not None
    include = sysconfig.get_paths().get("include") or ""
    found["Python.h"] = os.path.isfile(os.path.join(include, "Python.h"))
    # what a fake CNS call and a spawned fold worker cost before any work:
    # an interpreter start, and a fresh import of the fold stage
    starts = {}
    for what, cmd in (
            ("python3 -c pass", ["python3", "-c", "pass"]),
            ("import evcouplings_torch.fold.cns",
             [sys.executable, "-c", "import evcouplings_torch.fold.cns"])):
        t = time.perf_counter()
        subprocess.run(cmd, check=True, cwd=HERE,
                       env=dict(os.environ, PYTHONPATH=HERE))
        starts[what] = time.perf_counter() - t
    log("phase 10 probe (shutil.which, find_spec, sysconfig include {}): "
        "{}; a fresh process (host clock, s): {}".format(
            include, json.dumps(found), json.dumps(starts)))
    return found


def _plain(annotation):
    if isinstance(annotation, dict):
        return {k: _plain(v) for k, v in annotation.items()}
    return annotation


def phase10a_readers(tmp, full, align_kw):
    """The port's C readers against its Python readers on phase 9c's
    16385 x 160 Stockholm result and the full-width a2m: ids, matrix and
    annotation equal, and each reader's seconds (Alignment.from_path on
    the C route, Alignment.from_file on the Python reader; C, Python,
    Python, C). Then the align stage of a 6b-style job alone, on the C
    route and with the C readers patched out (C, Python, Python, C).
    Returns the align jobs' launches."""
    from evcouplings_torch.align import alignment as al

    sto = os.path.join(SEARCH_DIR, "full", "uniref.sto")
    for path, fmt, reader in ((sto, "stockholm", "read_stockholm"),
                              (full, "fasta", "read_fasta")):
        python_reads = []
        original = getattr(al, reader)

        def counted_reader(*args, **kwargs):
            python_reads.append(1)
            return original(*args, **kwargs)

        secs = {"C": [], "Python": []}
        alis = {}
        setattr(al, reader, counted_reader)
        try:
            for route in ("C", "Python", "Python", "C"):
                t = time.perf_counter()
                if route == "C":
                    ali = al.Alignment.from_path(path, fmt, device="cpu")
                else:
                    with open(path) as f:
                        ali = al.Alignment.from_file(f, fmt, device="cpu")
                secs[route].append(time.perf_counter() - t)
                alis[route] = ali
        finally:
            setattr(al, reader, original)
        # the Python reader ran only for the two from_file calls
        assert len(python_reads) == 2, python_reads
        c, py = alis["C"], alis["Python"]
        assert list(c.ids) == list(py.ids)
        assert c.matrix.shape == py.matrix.shape
        assert (c.matrix == py.matrix).all()
        assert _plain(c.annotation) == _plain(py.annotation)
        log("phase 10a {} reader, {} ({:.1f} MB, {} x {}): ids, matrix and "
            "annotation equal; C route {} s, Python reader {} s (host "
            "clock, C, Python, Python, C)".format(
                fmt, os.path.basename(path), os.path.getsize(path) / 1e6,
                c.N, c.L, ", ".join("{:.3f}".format(s) for s in secs["C"]),
                ", ".join("{:.3f}".format(s) for s in secs["Python"])))

    launches = dict.fromkeys(kernel_counts(), 0)
    align_secs = {"C": [], "Python": []}
    native_fasta = al.Alignment.__dict__["_from_native_fasta"]
    for k, route in enumerate(("C", "Python", "Python", "C")):
        config = pipeline_config(os.path.join(tmp, "align_{}".format(k),
                                              "job"), full, "TARGET",
                                 align_kw, {}, stages=["align"])
        if route == "Python":
            al.Alignment._from_native_fasta = classmethod(
                lambda cls, *args: None)
        try:
            state, counts, _ = run_job(config)
        finally:
            al.Alignment._from_native_fasta = native_fasta
        assert counts["K1"] == 1, counts
        for key in counts:
            launches[key] += counts[key]
        align_secs[route].append(runtime_seconds(state)["align"])
    log("phase 10a 6b-style job, align stage alone (N={}, N_eff on the "
        "card): C route {} s, Python reader {} s (C, Python, Python, "
        "C)".format(state["num_sequences"],
                    ", ".join("{:.3f}".format(s) for s in align_secs["C"]),
                    ", ".join("{:.3f}".format(s)
                              for s in align_secs["Python"])))
    return launches


def fold_tools(directory, a2m):
    """The fake folding binaries (tests/fold_fixtures.py) for an a2m's
    target: its gap-free first row, numbered from its header's start."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import fold_fixtures as ff

    with open(a2m) as f:
        header = f.readline()[1:].strip()
        target = f.readline().strip()
    start = int(header.split("/")[1].split("-")[0])
    return ff.write_fold_tools(directory, target, first_index=start)


def five_stage_config(prefix, a2m, sequence_id, align_kw, couplings_kw,
                      structure_dir, sifts_table, tools, fold):
    """[align, couplings, compare, mutate, fold] on the card: compare as
    in phase 8 (monomer_job), fold on the fake binaries."""
    config = monomer_job(prefix, a2m, sequence_id, align_kw, couplings_kw,
                         structure_dir, sifts_table)
    config["stages"] = list(FIVE_STAGES)
    config["tools"] = dict(config["tools"], cns=tools["cns"],
                           maxcluster=tools["maxcluster"],
                           psipred=tools["runpsipred"])
    config["fold"] = fold
    return config


def concatenate_without_plot(config, state, not_produced):
    """The concatenate stage's genome_distance protocol as the pipeline
    runs it (its input config composed the same way), without the
    distance plot, which needs matplotlib; its outcfg is written where
    the pipeline reuses a skipped stage's. Returns (outcfg, seconds)."""
    import evcouplings_torch.complex.protocol as pp
    from evcouplings_torch.utils.config import write_config_file
    from evcouplings_torch.utils.system import insert_dir

    stage_prefix = insert_dir(config["global"]["prefix"], "concatenate")
    incfg = {**config["tools"], **config["databases"],
             **config["concatenate"], **state, "prefix": stage_prefix}
    plot = pp.plot_distance_distribution
    pp.plot_distance_distribution = lambda *args: not_produced.add(
        "concatenate genome_distance: {}_distplot.pdf (matplotlib is not "
        "installed on this machine)".format(os.path.basename(stage_prefix)))
    try:
        out, secs = timed(lambda: pp.run(**incfg))
    finally:
        pp.plot_distance_distribution = plot
    del out["distance_plot_file"]
    write_config_file(stage_prefix + "_concatenate.outcfg", out)
    return out, secs


def run_job_without_plots(config, not_produced):
    """A job (protein_monomer or protein_complex) through
    execute_wrapped. Without matplotlib the stages that draw
    unconditionally cannot run inside the pipeline: the concatenate
    stage's genome_distance protocol runs without its distance plot
    (concatenate_without_plot) and mutate computes its matrix without
    plots (run_mutate); each writes its outcfg where the pipeline reuses
    a skipped stage's, and the pipeline runs the stages between. Returns
    (state, launches, {stage: seconds}, seconds)."""
    from evcouplings_torch.utils.config import write_config_file
    from evcouplings_torch.utils.system import insert_dir

    if have_matplotlib():
        state, counts, secs = run_job(config)
        return state, counts, runtime_seconds(state), secs
    outside = {"mutate"}
    if config.get("concatenate", {}).get("protocol") == "genome_distance":
        outside.add("concatenate")
    counts = dict.fromkeys(kernel_counts(), 0)
    stages, total, group = {}, 0.0, []
    state = dict(config["global"])

    def flush():
        nonlocal state, total
        if group:
            state, c, secs = run_job(dict(config, stages=list(group)))
            for k in counts:
                counts[k] += c[k]
            stages.update(runtime_seconds(state))
            total += secs
            group.clear()

    for stage in config["stages"]:
        if stage not in outside:
            group.append(stage)
            continue
        flush()
        if stage == "concatenate":
            (out, secs), c = counted(lambda: concatenate_without_plot(
                config, state, not_produced))
            for k in counts:
                counts[k] += c[k]
        else:
            prefix = insert_dir(config["global"]["prefix"], "mutate")
            segments = (state["segments"]
                        if config["mutate"]["protocol"] == "complex" else None)
            out, secs = run_mutate(state["model_file"], prefix, not_produced,
                                   segments=segments)
            write_config_file(prefix + "_mutate.outcfg", out)
        state = {**state, **out}
        stages[stage] = secs
        total += secs
    flush()
    return state, counts, stages, total


def phase10b(tmp, small, align_kw, not_produced):
    """The small job (the phase-6a generator, N=150, L=18) through all
    five stages on the card, against phase 8b's three seeded structures,
    fold with the sample config's probability cutoffs, a short count
    ramp, two models per sub-run, cpu 2 (a spawned pool in a process that
    holds a CUDA context) and its intermediate files kept; then compare
    and fold alone on the host over a copy of the card job's tree (the
    two fits differ in their last bits, phase 6a). Every compare and
    every fold artifact must be equal. Returns the card job's launches."""
    import shutil

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import compare_fixtures as ss
    import fold_fixtures as ff

    root = os.path.join(tmp, "fold_small")
    structure_dir, table = write_structures(root, *ss.small_structure_set())
    tools = fold_tools(os.path.join(FOLD_DIR, "small"), small)
    couplings_kw = dict(iterations=12, reuse_ecs=False,
                        min_sequence_distance=3, scoring_model="skewnormal")
    card_root = os.path.join(root, "card")
    config = five_stage_config(
        os.path.join(card_root, "job"), small, "TARGET_SEQ", align_kw,
        couplings_kw, structure_dir, table, tools,
        ff.fold_section(num_models=2, cpu=2, cleanup=False))
    state, counts, stages, secs = run_job_without_plots(config, not_produced)
    assert counts["K1"] == 2 and counts["K4"] > 0, counts
    assert len(state["folded_structure_files"]) >= 4
    host_root = os.path.join(root, "host")
    shutil.copytree(card_root, host_root)
    host_config = dict(config, stages=["compare", "fold"], **{
        "global": dict(config["global"],
                       prefix=os.path.join(host_root, "job"),
                       device="cpu")})
    host_state, _, host_secs = run_job(host_config)
    compared, err = ss.assert_same_compare_artifacts(
        stage_outcfg(config, "compare"), stage_outcfg(host_config, "compare"),
        card_root, host_root)
    folded = ff.assert_same_fold_artifacts(
        stage_outcfg(config, "fold"), stage_outcfg(host_config, "fold"),
        card_root, host_root)
    assert compared >= 14 and folded >= 20, (compared, folded)
    log("phase 10b small five-stage job on the card {:.2f} s (stages {}), "
        "compare and fold alone on the host {:.2f} s (stages {}): {} "
        "compare artifacts equal (max |dist diff| {:.2e} A), {} fold "
        "artifacts equal ({} models, restraint tables, CNS scripts, "
        "ranking, comparison tables); launches {}".format(
            secs, json.dumps(stages), host_secs,
            json.dumps(runtime_seconds(host_state)), compared, err, folded,
            len(state["folded_structure_files"]), json.dumps(counts)))
    return counts


def phase10c(tmp, full, align_kw, couplings_kw, not_produced,
             num_models=3):
    """The full-width five-stage job: the phase-6b planted synthetic
    (N=16384 + focus, L=160) through align, couplings (parity), compare
    against phase 8c's ten seeded structures, mutate and fold with the
    sample config's fold settings (config/sample_config_monomer.txt:
    probability cutoffs [0.90, 0.99], the count ramp 0.5-1.3 by 0.05 over
    19 sub-runs, cleanup), cpu 4. Depth is cut: 3 models per sub-run
    instead of the config's 10, with which the phase took 77 s on an
    NVIDIA H100 80GB HBM3 at 700 W (each fake CNS call is a process
    start). Returns the job's launches."""
    import pandas as pd

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import compare_fixtures as ss
    import evcouplings_torch.fold.protocol as fd
    import fold_fixtures as ff

    root = os.path.join(tmp, "fold_full")
    structures, rows = ss.full_structure_set(160, PLANTED)
    structure_dir, table = write_structures(root, structures, rows,
                                            truncated=("1t10",))
    tools = fold_tools(os.path.join(FOLD_DIR, "full"), full)
    fold = ff.fold_section(num_models=num_models, cpu=4, sample=True)
    config = five_stage_config(os.path.join(root, "job"), full, "TARGET",
                               align_kw, couplings_kw, structure_dir, table,
                               tools, fold)
    # the fold stage's time split, by wrapping the functions it calls; the
    # rest is the sub-runs on the pool and the copies of their models
    split = dict.fromkeys(("secondary structure", "clash filter",
                           "ranking", "clustering", "comparison"), 0.0)
    wrapped = (("secondary structure", "secondary_structure"),
               ("clash filter", "secstruct_clashes"),
               ("ranking", "dihedral_ranking"),
               ("clustering", "maxcluster_clustering_table"),
               ("comparison", "_write_experiment_comparisons"))
    originals = {name: getattr(fd, name) for _, name in wrapped}

    def timing(part, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                split[part] += time.perf_counter() - t
        return run

    for part, name in wrapped:
        setattr(fd, name, timing(part, originals[name]))
    try:
        state, counts, stages, secs = run_job_without_plots(config,
                                                            not_produced)
    finally:
        for name, fn in originals.items():
            setattr(fd, name, fn)
    assert counts["K1"] == 2 and counts["K4"] > 0, counts
    longrange = pd.read_csv(state["ec_compared_longrange_file"])
    top8 = longrange.iloc[:8]
    want8 = {(i + 1, j + 1) for i, j in PLANTED}
    assert set(zip(top8.i, top8.j)) == want8, top8
    assert (top8.precision == 1.0).all(), top8
    models = state["folded_structure_files"]
    ranking = pd.read_csv(state["folding_ranking_file"])
    comparison = pd.read_csv(state["folding_comparison_file"])
    assert len(ranking) == len(models) > 0
    assert np.isfinite(ranking.ranking_score).all()
    assert comparison.tm.notna().all()
    assert len(state["folding_individual_comparison_files"]) == \
        len(state["remapped_pdb_files"])
    rest = stages["fold"] - sum(split.values())
    log("phase 10c full-width five-stage job N={} L={}: {:.2f} s; stages "
        "{}; top 8 long-range compared ECs = the 8 planted pairs, "
        "precision 1.0; fold: {} models ({} per sub-run, cpu {}), ranking "
        "score {:.4f}-{:.4f}, compared against {} remapped structures; "
        "fold stage split (s): {}, sub-runs on the pool and the rest "
        "{:.3f}; launches {}".format(
            state["num_sequences"], state["num_sites"], secs,
            json.dumps(stages), len(models), num_models, fold["cpu"],
            float(ranking.ranking_score.min()),
            float(ranking.ranking_score.max()),
            len(state["remapped_pdb_files"]),
            json.dumps({k: round(v, 4) for k, v in split.items()}), rest,
            json.dumps(counts)))
    return counts


# ---------------------------------------------------------------------------
# phase 11: the protein-complex pipeline (A19c): two monomer alignments,
# align `complex` over `existing` with local UniProt-to-EMBL and ENA tables,
# their concatenation (best_hit or genome_distance), couplings `complex`
# on the concatenated alignment (K1 reweights the paired rows, the parity
# LBFGS drives K4), compare `complex` against seeded two-chain structures
# (the float64 distance contraction for intra-chain, homomultimer and
# inter-chain maps on the card), mutate `complex` and fold `complex_dock`.
# Inputs are made from a seed (tests/complex_fixtures.py).
# ---------------------------------------------------------------------------

# full width (11b): the two monomers' lengths, and the planted pairs
# (0-based): inter (site of monomer 1, site of monomer 2) and intra pairs
COMPLEX_L = (90, 70)
COMPLEX_INTER = [(5, 12), (30, 44), (52, 3), (77, 60)]
COMPLEX_INTRA = ([(10, 40), (60, 85)], [(20, 50), (8, 33)])


def phase11a(tmp, not_produced):
    """The small complex job (tests/test_complex.py's generator: two
    monomers of N=140, L=10, 3 planted inter pairs and one intra pair in
    each; seeded EMBL and ENA tables; three seeded structures) through all
    seven stages, with best_hit and with genome_distance, on the card and
    on the host (device cpu). Card and host: every align_1, align_2 and
    concatenate artifact equal byte for byte, the model within the golden
    gate at 12 iterations, the inter ECs in exact rank order,
    probabilities within atol 1e-3; then compare and fold alone on the
    host over a copy of the card job's tree (the two fits differ in their
    last bits): every compare artifact and every docking restraint file
    equal. Returns the card jobs' launches."""
    import shutil

    import pandas as pd

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import complex_fixtures as cf
    import compare_fixtures as ss
    from evcouplings_torch.couplings.model import CouplingsModel

    root = os.path.join(tmp, "complex_small")
    from evcouplings_torch.compare.bcif import write_bcif

    inputs = cf.write_job_inputs(os.path.join(root, "in"), write_bcif)
    launches = dict.fromkeys(kernel_counts(), 0)
    for protocol in ("best_hit", "genome_distance"):
        jobs = {}
        for device in ("cuda", "cpu"):
            config = cf.job_config(
                os.path.join(root, protocol, device, "job"), inputs,
                concatenate=protocol,
                device=None if device == "cuda" else "cpu",
                figures=have_matplotlib())
            jobs[device] = (config,) + run_job_without_plots(config,
                                                             not_produced)
        (card_cfg, card, counts, stages, secs), (host_cfg, host, _, hstages,
                                                  hsecs) = (jobs["cuda"],
                                                            jobs["cpu"])
        assert counts["K1"] == 2 and counts["K4"] > 0, counts
        for k in launches:
            launches[k] += counts[k]
        card_root, host_root = (os.path.dirname(c["global"]["prefix"])
                                for c in (card_cfg, host_cfg))
        files = sum(cf.assert_same_outputs(
            stage_outcfg(card_cfg, s), stage_outcfg(host_cfg, s), card_root,
            host_root) for s in ("align_1", "align_2", "concatenate"))
        card_m, host_m = (CouplingsModel(s["model_file"])
                          for s in (card, host))
        excess = {a: max_rel_excess(getattr(card_m, a), getattr(host_m, a))
                  for a in ("J_ij", "h_i", "f_i", "f_ij")}
        assert max(excess.values()) <= 1.0, excess
        card_ec, host_ec = (pd.read_csv(s["ec_file"]).sort_values(
            ["i", "j", "segment_i"]).reset_index(drop=True)
            for s in (card, host))
        for col in ("cn", "fn"):
            excess[col] = max_rel_excess(card_ec[col], host_ec[col])
        assert max(excess.values()) <= 1.0, excess
        prob_err = float(np.max(np.abs(card_ec.probability.values
                                       - host_ec.probability.values)))
        assert prob_err <= 1e-3, prob_err
        inter = [pd.read_csv(s["inter_ec_file"]) for s in (card, host)]
        assert_exact_rank_order(inter[0], inter[1])
        want2 = [(ci + 1, cj + 1) for ci, cj, _ in cf.INTER_PLANTED[:2]]
        assert list(zip(inter[0].i, inter[0].j))[:2] == want2, inter[0]
        # compare and fold on the host over a copy of the card job's tree
        copy_root = os.path.join(root, protocol, "host_on_card_job")
        shutil.copytree(card_root, copy_root)
        again = dict(card_cfg, stages=["compare", "fold"], **{
            "global": dict(card_cfg["global"], device="cpu",
                           prefix=os.path.join(copy_root, "job"))})
        _, _, again_secs = run_job(again)
        compared, err = ss.assert_same_compare_artifacts(
            stage_outcfg(card_cfg, "compare"), stage_outcfg(again, "compare"),
            card_root, copy_root)
        restraints = [stage_outcfg(c, "fold")["docking_restraint_files"]
                      for c in (card_cfg, again)]
        assert len(restraints[0]) == len(restraints[1]) > 0
        for a, b in zip(*restraints):
            assert os.path.relpath(a, card_root) == os.path.relpath(
                b, copy_root)
            with open(a, "rb") as f, open(b, "rb") as g:
                assert f.read() == g.read(), a
        log("phase 11a small complex job, {}: card {:.2f} s (stages {}), "
            "host {:.2f} s (stages {}); {} align and concatenate artifacts "
            "equal (the concatenated .a2m, _concatenation_statistics.csv, "
            "genome locations, identities, frequencies, statistics, "
            "weights), {} paired rows; excess over the 1e-4 gate {}; "
            "inter EC rank order exact; probability max |err| {:.2e} "
            "(atol 1e-3); compare and fold on the host over the card "
            "job's tree {:.2f} s: {} compare artifacts equal (max |dist "
            "diff| {:.2e} A), {} docking restraint files equal; "
            "launches {}".format(
                protocol, secs, json.dumps(stages), hsecs,
                json.dumps(hstages), files, card["num_sequences"],
                json.dumps(excess), prob_err, again_secs, compared, err,
                len(restraints[0]), json.dumps(counts)))
    return launches


def write_complex_monomer(path, target_id, ids, target, codes):
    """One monomer alignment: the gap-free target row, then the rows."""
    letters = np.array(list(ALPHABET))
    with open(path, "w") as f:
        f.write(">{}\n{}\n".format(target_id, "".join(letters[target])))
        for name, row in zip(ids, codes):
            f.write(">{}\n{}\n".format(name, "".join(
                letters[np.maximum(row, 0)])))


def complex_full_inputs(directory, rng, n=16384, paralog_frac=0.05,
                        query_paralogs=6):
    """The full-width complex job's inputs: two monomers of n rows + the
    target (L = 90 and 70, the phase-5 family structure), planted pairs
    across and within them (plant_pairs, concordance 0.9), one species
    per paired row; a paralog_frac of species hold a second row of lower
    identity to the target (most_similar_by_organism picks the first),
    and the targets' own species holds query_paralogs rows of other
    families (paralogs: best_reciprocal filtering drops the best hits
    closer to them than to the target). Each row keeps the target's
    residue at about half its sites. Annotation, EMBL and ENA tables;
    seeded structures of the heterodimer with the planted pairs in
    contact. Returns the paths as complex_fixtures.write_job_inputs."""
    import pandas as pd

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import complex_fixtures as cf

    os.makedirs(directory, exist_ok=True)
    L1, L2 = COMPLEX_L
    n_par = int(round(paralog_frac * n))
    n_species = n - n_par - query_paralogs
    codes = np.hstack([
        synthetic_codes(rng, n_species, L, 21, families=256, mutate=0.15,
                        gap_rows=0.1, missing_rows=0.0)
        for L in COMPLEX_L])
    # homologs of the targets: each row keeps the target's residue at
    # about half its sites (identity to the target ~0.5; rows of one
    # family are closer to each other than to other families)
    target = rng.integers(1, 21, size=L1 + L2)
    codes = np.where(rng.random(codes.shape) < 0.5, target, codes).astype(
        np.int8)
    plant_pairs(rng, codes, [(i, L1 + j) for i, j in COMPLEX_INTER]
                + COMPLEX_INTRA[0]
                + [(L1 + i, L1 + j) for i, j in COMPLEX_INTRA[1]])
    second = rng.choice(n_species, size=n_par, replace=False)
    weaker = codes[second].copy()
    same = (weaker == target) & (rng.random(weaker.shape) < 0.5)
    weaker[same] = weaker[same] % 20 + 1     # another residue
    others = codes[rng.choice(n_species, size=query_paralogs)].copy()
    rows = np.vstack([codes, weaker, others])
    species = (["Sp{}".format(k) for k in range(n_species)]
               + ["Sp{}".format(k) for k in second]
               + ["Query"] * len(others))
    paths, annotations = [], []
    for m, (tag, lo, hi) in enumerate((("a", 0, L1), ("b", L1, L1 + L2))):
        L = hi - lo
        ids = (["{}{}/1-{}".format(tag, k, L) for k in range(n_species)]
               + ["{}{}p/1-{}".format(tag, k, L) for k in second]
               + ["{}q{}/1-{}".format(tag, k, L)
                  for k in range(len(others))])
        target_id = "T{}/1-{}".format(m + 1, L)
        path = os.path.join(directory, "m{}.a2m".format(m + 1))
        write_complex_monomer(path, target_id, ids, target[lo:hi],
                              rows[:, lo:hi])
        anno = os.path.join(directory, "anno{}.csv".format(m + 1))
        pd.DataFrame({"id": [target_id] + ids,
                      "name": ["T{}".format(m + 1)] + ids,
                      "OS": ["Query"] + species}).to_csv(anno, index=False)
        paths.append(path)
        annotations.append(anno)
    embl = os.path.join(directory, "uniprot_to_embl.txt")
    ena = os.path.join(directory, "ena_locations.tsv")
    cf.write_genome_tables(embl, ena,
                           ["a{}".format(k) for k in range(n_species)],
                           ["b{}".format(k) for k in range(n_species)])
    structure_dir, sifts = write_structures(
        directory, *cf.complex_structure_set(L1, L2, COMPLEX_INTER,
                                             *COMPLEX_INTRA))
    return {"alignments": tuple(paths), "annotations": tuple(annotations),
            "uniprot_to_embl_table": embl, "ena_genome_location_table": ena,
            "sifts_mapping_table": sifts, "structure_dir": structure_dir}


def phase11b(tmp, rng, not_produced, n=16384):
    """The full-width complex job (complex_full_inputs: N=16384 + target
    per monomer, L = 90 + 70 = 160, q = 21) on the sample complex config
    itself (config/sample_config_complex.txt, read and given local
    inputs by complex_fixtures.sample_job_config): align `complex` over
    `existing`, best_hit with the best-reciprocal filter (paralog
    threshold 0.95), couplings `complex` (lbfgs, parity, skewnormal, intra
    and inter ECs scored apart, min sequence distance 6), compare
    `complex` (by a SIFTS lookup) against the seeded heterodimer
    structures, mutate `complex`, fold `complex_dock`; N_eff
    is computed in the concatenate stage. Depth is cut: 5 iterations
    instead of 100, and no archive is written. Gate: the top 4 inter ECs
    are the planted inter pairs, each a contact in the structures
    (precision 1.0); K1 twice, K4 launched. The couplings stage runs once
    more under torch.profiler on a copy of the job's tree (for its device
    busy share). Returns the job's launches."""
    import shutil

    import pandas as pd

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import complex_fixtures as cf

    root = os.path.join(tmp, "complex_full")
    t = time.perf_counter()
    inputs = complex_full_inputs(os.path.join(root, "in"), rng, n=n)
    make_secs = time.perf_counter() - t
    config = cf.sample_job_config(os.path.join(root, "out", "job"), inputs,
                                  iterations=5, figures=have_matplotlib())
    # no archive: gzipping the 45 MB .model alone took 17.8 s on the CPU
    # of a rehearsal (tests/test_torch_complex.py writes the archive)
    config["management"]["archive"] = None
    state, counts, stages, secs = run_job_without_plots(config, not_produced)
    assert counts["K1"] == 2 and counts["K4"] > 0, counts
    inter = pd.read_csv(state["inter_ec_file"])
    want4 = {(i + 1, j + 1) for i, j in COMPLEX_INTER}
    top4 = set(zip(inter.i.values[:4], inter.j.values[:4]))
    assert top4 == want4, inter.iloc[:8]
    compared = pd.read_csv(state["ec_compared_inter_file"]).sort_values(
        "cn", ascending=False)
    assert set(zip(compared.i.values[:4], compared.j.values[:4])) == want4
    assert (compared.dist.values[:4] <= 5).all(), compared.iloc[:4]
    stats = pd.read_csv(state["concatentation_statistics_file"])
    # the couplings stage again, on a copy of the tree without its outputs
    copy_root = os.path.join(root, "profiled")
    shutil.copytree(os.path.join(root, "out"), copy_root, ignore=(
        lambda d, names: ["couplings"] if d.endswith("job") else []))
    again = dict(config, stages=["couplings"], **{"global": dict(
        config["global"], prefix=os.path.join(copy_root, "job"))})
    prof = profile_device_time("phase 11b couplings stage", lambda: run_job(
        again), host_ops=False)
    log("phase 11b full-width complex job: inputs written in {:.2f} s; "
        "monomers N={} and {} + target, L={} + {}; {} species in both, {} "
        "paired rows after best-reciprocal filtering and the coverage "
        "filter (N_eff {:.1f}), L={}; job {:.2f} s; stages {}; top 4 "
        "inter ECs = the 4 planted inter pairs, each a contact (dist {}), "
        "precision 1.0; couplings stage under the profiler: device busy "
        "share {}; launches {}".format(
            make_secs, stats.num_seqs_1.iloc[0] - 1,
            stats.num_seqs_2.iloc[0] - 1, *COMPLEX_L,
            stats.num_species_overlap.iloc[0], state["num_sequences"],
            state["effective_sequences"], state["num_sites"], secs,
            json.dumps(stages),
            [round(float(d), 3) for d in compared.dist.values[:4]],
            "not measured" if prof is None else "{:.1%}".format(
                prof["busy_s"] / prof["wall_s"]), json.dumps(counts)))
    return counts


# ---------------------------------------------------------------------------
# phase 12: the sharded fits over torch.distributed (A18). The machine has
# one card: NCCL runs at world size 1 in this process (12a), and several
# ranks share the card over gloo in workers this script starts as
# `chip_smoke.py --phase12-worker KIND RANK WORLD INIT_FILE DIR` (12b: 3
# ranks, 12c: a (2, 2) mesh of 4). Nothing across cards is measured, and no
# scaling is claimed.
# ---------------------------------------------------------------------------

# seconds a collective may wait for the other ranks, and a set of spawned
# ranks may run, before the phase fails
PHASE12_COLLECTIVE_S = 120
PHASE12_RUN_S = 300
# the 3-rank fits against one process (PERF.md, written before the first
# run): parity at the golden gate, fx at rtol 1e-5; production (Adam in
# bfloat16, where a one-ulp change of a gradient near zero may flip an
# element's first steps) by the relative Frobenius norm of the difference;
# the asymmetric (2, 2) fit at the JAX package's own tolerance; the
# inversion's relative max error
PARITY_TOL = dict(rtol=1e-4, atol=1e-5)
FX_RTOL = 1e-5
PRODUCTION_REL = 1e-3
ASYM_TOL = dict(rtol=1e-3, atol=2e-5)
INVERSE_REL = 1e-8
INVERSE_D = 3200
# all-reduce payloads timed over the 3 gloo ranks (float32 elements; the
# last is the full-width gradient payload)
COST_PAYLOADS = (10 ** 4, 10 ** 6, 3360 * 3456 + 1)


def phase12_probe():
    import torch
    import torch.distributed as dist

    log("phase 12 probe: torch.distributed nccl {}, gloo {}, {} CUDA "
        "device(s)".format(dist.is_nccl_available(), dist.is_gloo_available(),
                           torch.cuda.device_count()))


def phase12_alignment(tmp):
    """Phase 12's fit data: the phase-5 synthetic (N=16384 + the focus row,
    L=160, q=21) drawn from a generator of its own, seeded as phase 5's,
    so that phase 12 sees the same data whether it runs alone or after the
    phases that draw from phase 5's generator first."""
    rng = np.random.default_rng(SEED)
    codes = synthetic_codes(rng, 16384, 160, 21, families=256, mutate=0.15,
                            gap_rows=0.1, missing_rows=0.0)
    a2m = os.path.join(tmp, "phase12.a2m")
    write_a2m(a2m, codes)
    return a2m


def phase12_task(a2m, focus_seq, stage_incfg, lambda_J):
    """The inputs every rank of phase 12 shares: the fit codes of `a2m`
    (phase12_alignment's: N=16385 with the focus row, L=160) and their K1
    weights, the fits' settings and the couplings stage's config (phase
    6b's parity job's)."""
    from evcouplings_torch.couplings.fitter import prepare_alignment
    from evcouplings_torch.ops.weights import num_cluster_members
    from evcouplings_torch.utils.config import read_config_file

    codes = prepare_alignment(a2m, focus_seq=focus_seq)["codes"]
    weights = 1.0 / num_cluster_members(codes, 0.8).cpu().numpy()
    stage = read_config_file(stage_incfg)
    task = {
        "parity": dict(solver="lbfgs", dtype="float32", precision="highest",
                       max_iter=5, lambda_J=lambda_J, block_size=512),
        # run_plm's default block for this N on 3 ranks (one per rank)
        "production": dict(solver="adam", dtype="bfloat16",
                           precision="default", max_iter=20,
                           lambda_J=lambda_J, block_size=5632),
        "asym": dict(solver="lbfgs", dtype="float32", precision="highest",
                     max_iter=5, conv_tol=0.0, lambda_J=lambda_J,
                     block_size=1024),
        "stage": dict(stage, reuse_ecs=False),
        "seed": SEED + 12,
    }
    return codes, weights, task


def phase12_start(kind, world, directory, codes, weights, task):
    """Start `world` ranks of sub-phase `kind` (gloo, file:// rendezvous in
    `directory`); phase12_wait collects them."""
    os.makedirs(directory)
    np.savez(os.path.join(directory, "inputs.npz"), codes=codes,
             weights=weights)
    with open(os.path.join(directory, "task.json"), "w") as f:
        json.dump(task, f)
    init = os.path.join(directory, "rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase12-worker", kind,
         str(r), str(world), init, directory],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    return kind, procs, directory, time.perf_counter()


def phase12_wait(started):
    """The ranks' results, once all have ended; a rank that fails, or is
    still running after PHASE12_RUN_S seconds (then every rank is killed),
    fails the phase with its output."""
    import pickle

    kind, procs, directory, t0 = started
    outputs = []
    for p in procs:
        left = max(1.0, PHASE12_RUN_S - (time.perf_counter() - t0))
        try:
            out, _ = p.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            out += b"\n(killed after %d s)" % PHASE12_RUN_S
        outputs.append(out.decode(errors="replace"))
    for r, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, "phase {} rank {} exit {}:\n{}".format(
            kind, r, p.returncode, out[-6000:])
    results = []
    for r in range(len(procs)):
        with open(os.path.join(directory, "rank{}.pkl".format(r)),
                  "rb") as f:
            results.append(pickle.load(f))
    log("phase {}: {} ranks ended after {:.1f} s".format(
        kind, len(procs), time.perf_counter() - t0))
    return results


def _digest(fit):
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(fit.J_ij).tobytes()
                          + np.ascontiguousarray(fit.h_i).tobytes()
                          ).hexdigest()


def _fit_record(fit, table, secs, launches, keep):
    rec = {"digest": _digest(fit), "secs": secs, "launches": launches,
           "fx": np.array([r["fx"] for r in table])}
    if keep:
        rec.update(J=fit.J_ij.astype(np.float32), h=fit.h_i)
    return rec


def phase12_worker(kind, rank, world, init_file, directory):
    """One rank of 12b or 12c: a gloo process group on the card. Pickles
    its results to DIRECTORY/rank<RANK>.pkl."""
    import pickle

    import torch

    sys.path.insert(0, HERE)
    from evcouplings_torch import parallel

    rank, world = int(rank), int(world)
    parallel.distributed_initialize(
        "file://" + init_file, world, rank, backend="gloo",
        timeout=PHASE12_COLLECTIVE_S)
    with open(os.path.join(directory, "task.json")) as f:
        task = json.load(f)
    data = np.load(os.path.join(directory, "inputs.npz"))
    run = phase12b_rank if kind == "12b" else phase12c_rank
    out = run(task, data["codes"], data["weights"], directory)
    with open(os.path.join(directory, "rank{}.pkl".format(rank)), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


def phase12b_rank(task, codes, weights, directory):
    """One of 3 gloo ranks on the card: K1 split into three tile ranges,
    the parity and production fits on a 3-rank mesh, the collective
    profile of an evaluation at two N, the sharded float64 inversion, the
    couplings stage with fit_devices 3, and all-reduce times."""
    import torch

    from evcouplings_torch import parallel
    from evcouplings_torch.couplings import protocol as couplings
    from evcouplings_torch.ops.mean_field import (
        invert_covariance, invert_covariance_sharded,
    )
    from evcouplings_torch.ops.plm import (
        PlmConfig, fit_plm, make_plm_value_and_grad,
    )
    from evcouplings_torch.parallel import comm_accounting as ca

    mesh = parallel.make_mesh(device="cuda")
    rank = mesh.rank
    out = {}
    (counts, secs), launches = counted(lambda: timed(
        lambda: parallel.num_cluster_members_sharded(codes, 0.8, mesh)))
    out["k1"] = {"secs": secs, "launches": launches}
    if rank == 0:
        out["k1"]["counts"] = counts.cpu().numpy().astype(np.int64)
    for mode in ("parity", "production"):
        table = []
        cfg = PlmConfig(**task[mode])
        (fit, secs), launches = counted(lambda: timed(lambda: fit_plm(
            codes, weights, 21, cfg, mesh=mesh, callback=table.append)))
        out[mode] = _fit_record(fit, table, secs, launches, rank == 0)

    # the collectives of one evaluation, at two N
    L, q = codes.shape[1], 21
    vg = make_plm_value_and_grad(L, q, PlmConfig(block_size=512), mesh=mesh)
    params = {"J": torch.zeros((L * q, L * q), device="cuda"),
              "h": torch.zeros((L, q), device="cuda")}
    for n in (len(codes), len(codes) // 2):
        rows, _ = parallel.shard_rows(codes[:n].astype(np.int8), mesh,
                                      pad_multiple=512)
        w_loc, _ = parallel.shard_rows(weights[:n], mesh, pad_multiple=512)
        first = rows.shape[0] * mesh.index("data")
        rows[first + torch.arange(rows.shape[0], device="cuda") >= n] = -1
        ops, summary = ca.collective_profile(vg, params, rows, w_loc.float())
        out["profile", n] = dict(summary, ops=[(o.op, o.axis, o.bytes)
                                               for o in ops])

    # the float64 inversion, C = A A^T + D I from a seeded generator (the
    # same on every rank of the card)
    D = INVERSE_D
    gen = torch.Generator(device="cuda").manual_seed(task["seed"])
    A = torch.randn((D, D), generator=gen, device="cuda", dtype=torch.float64)
    C = A @ A.T + D * torch.eye(D, device="cuda", dtype=torch.float64)
    X, secs = timed(lambda: invert_covariance_sharded(C, mesh))
    out["inverse"] = {"secs": secs}
    if rank == 0:
        ref, ref_secs = timed(lambda: invert_covariance(C))
        out["inverse"].update(
            ref_secs=ref_secs,
            rel_err=float((X - ref).abs().max() / ref.abs().max()))
    del A, C, X

    # the couplings stage on the three ranks (rank 0 writes)
    stage = dict(task["stage"], fit_devices=3,
                 prefix=os.path.join(directory, "stage", "job"))
    (outcfg, secs), launches = counted(lambda: timed(
        lambda: couplings.run(**stage)))
    out["stage"] = {"outcfg": outcfg, "secs": secs, "launches": launches}

    out["cost"] = ca.measure_all_reduce_cost([mesh.size], COST_PAYLOADS,
                                             reps=5, device="cuda")
    return out


def phase12c_rank(task, codes, weights, directory):
    """One of 4 gloo ranks on the card, a (2, 2) mesh: the asymmetric fit
    (per-site LBFGS) with rows and sites split."""
    from evcouplings_torch import parallel
    from evcouplings_torch.ops.plm import PlmConfig
    from evcouplings_torch.ops.plm_sites import fit_plm_asym

    mesh = parallel.make_mesh_2d(2, 2, device="cuda")
    table = []
    (fit, secs), launches = counted(lambda: timed(lambda: fit_plm_asym(
        codes, weights, 21, PlmConfig(**task["asym"]), mesh=mesh,
        callback=table.append)))
    return {"asym": _fit_record(fit, table, secs, launches, mesh.rank == 0),
            "coords": mesh.coords}


def _rel_fro(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check_fit(what, got, want, tol=None, rel=None):
    """A rank's fit against the one-process fit: within `tol`
    (assert_allclose on J_ij and h_i) or `rel` (relative Frobenius norm of
    the difference), fx at FX_RTOL; prints the measured differences."""
    errs = {k: float(np.max(np.abs(got[k] - want[k]))) for k in ("J", "h")}
    rels = {k: _rel_fro(got[k], want[k]) for k in ("J", "h")}
    fx = float(np.max(np.abs(got["fx"] - want["fx"]) / np.abs(want["fx"])))
    log("{}: max |dJ_ij| {:.3e}, max |dh_i| {:.3e}, relative Frobenius "
        "{:.3e} / {:.3e}, fx max rel {:.3e}".format(
            what, errs["J"], errs["h"], rels["J"], rels["h"], fx))
    if tol is not None:
        for k in ("J", "h"):
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
    if rel is not None:
        assert max(rels.values()) <= rel, rels
    assert fx <= FX_RTOL, fx
    return {"max_abs": errs, "rel_fro": rels, "fx_rel": fx}


def phase12a(tmp, codes, weights, task, refs, full_state):
    """NCCL at world size 1 in this process: the parity and production
    fits on a one-rank mesh, bitwise equal to the same fits without one
    (K2 runs: "auto" keeps it on a mesh of one), and the couplings stage
    with fit_devices 1, whose EC files equal phase 6b's parity job's."""
    import datetime

    import torch
    import torch.distributed as dist

    from evcouplings_torch import parallel
    from evcouplings_torch.couplings import protocol as couplings
    from evcouplings_torch.ops.plm import PlmConfig, fit_plm

    init = os.path.join(tmp, "phase12a_rendezvous")
    dist.init_process_group("nccl", init_method="file://" + init,
                            world_size=1, rank=0, timeout=datetime.timedelta(
                                seconds=PHASE12_COLLECTIVE_S))
    try:
        def path():
            mesh = parallel.make_mesh(device="cuda")
            fits = {}
            for mode in ("parity", "production"):
                table = []
                fit, secs = timed(lambda: fit_plm(
                    codes, weights, 21, PlmConfig(**task[mode]), mesh=mesh,
                    callback=table.append))
                fits[mode] = _fit_record(fit, table, secs, None, True)
            stage = dict(task["stage"], fit_devices=1,
                         prefix=os.path.join(tmp, "phase12a", "job"))
            outcfg, secs = timed(lambda: couplings.run(**stage))
            return fits, outcfg, secs

        (fits, outcfg, stage_secs), launches = counted(path)
    finally:
        dist.destroy_process_group()
    for mode in ("parity", "production"):
        got, want = fits[mode], refs[mode]
        assert got["digest"] == want["digest"], mode
        assert np.array_equal(got["fx"], want["fx"]), mode
    for key in ("raw_ec_file", "ec_file"):
        with open(outcfg[key]) as a, open(full_state[key]) as b:
            assert a.read() == b.read(), key
    assert launches["K1"] > 0 and launches["K2"] > 0 and launches["K4"] > 0
    log("phase 12a NCCL world size 1: parity fit {:.2f} s and production "
        "fit {:.2f} s on a one-rank mesh bitwise equal to the fits without "
        "one ({:.2f} s, {:.2f} s); couplings stage with fit_devices 1 "
        "{:.2f} s, its raw EC and CouplingScores files equal phase 6b's; "
        "launches {}".format(fits["parity"]["secs"],
                             fits["production"]["secs"],
                             refs["parity"]["secs"],
                             refs["production"]["secs"], stage_secs,
                             json.dumps(launches)))
    return launches


def phase12_references(codes, weights, task):
    """The one-process fits on the card that 12a and 12b are held to:
    parity, production with K2 ("auto" on the card), production without
    it (as on a mesh of several ranks)."""
    from dataclasses import replace

    from evcouplings_torch.ops.plm import PlmConfig, fit_plm

    refs = {}
    for name, mode, fused in (("parity", "parity", "auto"),
                              ("production", "production", "auto"),
                              ("unfused", "production", "off")):
        table = []
        cfg = replace(PlmConfig(**task[mode]), fused_update=fused)
        fit, secs = timed(lambda: fit_plm(codes, weights, 21, cfg,
                                          callback=table.append,
                                          device="cuda"))
        refs[name] = _fit_record(fit, table, secs, None, True)
    return refs


def tile_pairs(n, begin, count, tile=128):
    """Row pairs (i <= j) that K1's tiles [begin, begin + count) cover for
    n rows (a diagonal tile its triangle, the others their rectangle)."""
    tiles = -(-n // tile)
    rows = [min(tile, n - t * tile) for t in range(tiles)]
    pairs, k = 0, 0
    for ti in range(tiles):
        for tj in range(ti, tiles):
            if begin <= k < begin + count:
                pairs += (rows[ti] * (rows[ti] + 1) // 2 if ti == tj
                          else rows[ti] * rows[tj])
            k += 1
    return pairs


def phase12_k1_ranges(codes, parts=3):
    """K1's three tile ranges launched in turn in this process (the ranks
    of 12b share the card, so their own times overlap): each range's ms and
    its operations bound, the pairs it covers x 2 L q int8 ops."""
    import torch

    from evcouplings_torch.kernels import reweight as k_reweight
    from evcouplings_torch.ops.weights import _identity_count_threshold

    n, L = codes.shape
    q = 21
    dev_codes = torch.as_tensor(codes, device="cuda")
    padded = k_reweight.pad_codes(dev_codes)
    k = _identity_count_threshold(L, 0.8)
    ms, bound = [], []
    for r in range(parts):
        tiles = k_reweight.tile_range(n, r, parts)
        ms.append(cuda_ms(lambda: k_reweight.launch(
            padded, int(dev_codes.max()) + 1, k, tiles), 10))
        bound.append(2 * tile_pairs(n, *tiles) * L * q / INT8_TC_OPS_PER_S
                     * 1e3)
    whole = cuda_ms(lambda: k_reweight.launch(
        padded, int(dev_codes.max()) + 1, k), 10)
    log("phase 12 K1 N={} in {} tile ranges, launched in turn: {} ms "
        "(bounds {} ms, operations), whole launch {:.4f} ms".format(
            n, parts, ", ".join("{:.4f}".format(m) for m in ms),
            ", ".join("{:.4f}".format(b) for b in bound), whole))
    return ms, bound


def phase12(tmp, a2m, focus_seq, full_state, stage_incfg, lambda_J, rows):
    """Phase 12 (see the section's comment) on the fit data of `a2m`.
    Returns the kernel launches of each sub-phase."""
    import torch

    from evcouplings_torch.kernels import reweight as k_reweight
    from evcouplings_torch.ops.weights import (
        _identity_count_threshold, _num_cluster_members_plain,
    )

    phase12_probe()
    codes, weights, task = phase12_task(a2m, focus_seq, stage_incfg,
                                        lambda_J)
    root = os.path.join(tmp, "phase12")
    started = phase12_start("12b", 3, os.path.join(root, "12b"), codes,
                            weights, task)
    refs = phase12_references(codes, weights, task)
    launches = {"12a": phase12a(tmp, codes, weights, task, refs,
                                full_state)}
    ranks = phase12_wait(started)
    # the 12c ranks start while this process checks 12b and times K1's
    # ranges (their own work starts after their import)
    started = phase12_start("12c", 4, os.path.join(root, "12c"), codes,
                            weights, task)

    # 12b: K1 split, counts exactly equal to one whole launch and to the
    # plain version
    dev_codes = torch.as_tensor(codes, device="cuda")
    k = _identity_count_threshold(codes.shape[1], 0.8)
    whole = k_reweight.neighbor_counts(dev_codes, k).cpu().numpy()
    plain = _num_cluster_members_plain(dev_codes, k).cpu().numpy()
    got = ranks[0]["k1"]["counts"]
    assert np.array_equal(got, whole) and np.array_equal(got, plain)
    k1_ranges = [r["k1"]["launches"]["K1"] for r in ranks]
    assert k1_ranges == [1, 1, 1], k1_ranges
    ms, bound = phase12_k1_ranges(codes)
    rows["K1"].update(range_launches=sum(k1_ranges), range_ms=ms,
                      range_bound_ms=bound)
    log("phase 12b K1 split over 3 ranks (one range launch each, {:.3f} s "
        "on the shared card): counts exactly equal to one whole launch and "
        "to the plain version".format(max(r["k1"]["secs"] for r in ranks)))

    # the fits: every rank bitwise equal to rank 0, rank 0 within the
    # tolerances of the one-process fits
    for mode, ref, kw in (("parity", "parity", dict(tol=PARITY_TOL)),
                          ("production", "unfused",
                           dict(rel=PRODUCTION_REL))):
        digests = {r[mode]["digest"] for r in ranks}
        assert len(digests) == 1, (mode, digests)
        _check_fit("phase 12b {} fit on 3 ranks ({:.2f} s; one process "
                   "{:.2f} s) against one process".format(
                       mode, ranks[0][mode]["secs"], refs[ref]["secs"]),
                   ranks[0][mode], refs[ref], **kw)
        assert ranks[0][mode]["launches"]["K2"] == 0
    assert ranks[0]["parity"]["launches"]["K4"] > 0

    from evcouplings_torch.parallel.comm_accounting import (
        expected_gradient_payload,
    )

    payload = expected_gradient_payload(codes.shape[1], 21)["bytes"]
    for n in (len(codes), len(codes) // 2):
        for r in ranks:
            prof = r["profile", n]
            assert prof["all_reduce_count"] == prof["count"] == 1, prof
            assert prof["bytes"] == payload, (prof["bytes"], payload)
    log("phase 12b collective profile of one evaluation at N={} and {}: one "
        "all-reduce of {} bytes (expected_gradient_payload) on every "
        "rank".format(len(codes), len(codes) // 2, payload))

    inv = ranks[0]["inverse"]
    assert inv["rel_err"] <= INVERSE_REL, inv
    log("phase 12b inversion D={} float64: sharded over 3 ranks {:.1f} ms "
        "per rank (shared card), one process {:.1f} ms, max rel error "
        "{:.2e}".format(INVERSE_D, inv["secs"] * 1e3,
                        inv["ref_secs"] * 1e3, inv["rel_err"]))

    import pandas as pd

    outcfg = ranks[0]["stage"]["outcfg"]
    assert all(r["stage"]["outcfg"] == outcfg for r in ranks)
    longrange = pd.read_csv(outcfg["ec_longrange_file"])
    top8 = set(zip(longrange.i.values[:8], longrange.j.values[:8]))
    assert top8 == {(i + 1, j + 1) for i, j in PLANTED}, sorted(top8)
    log("phase 12b couplings stage with fit_devices 3: {:.2f} s, the same "
        "outcfg on every rank, planted pairs at top-8 precision 1.0; "
        "launches by rank {}".format(
            ranks[0]["stage"]["secs"],
            json.dumps([r["stage"]["launches"] for r in ranks])))
    cost = ranks[0]["cost"][3]
    log("phase 12b gloo all-reduce over 3 ranks on one card (host copies "
        "and loopback, not a link between cards): {}".format(", ".join(
            "{} floats {:.3f} ms".format(p, s * 1e3)
            for p, s in sorted(cost.items()))))
    launches["12b"] = {key: sum(r[part]["launches"][key] for r in ranks
                                for part in ("k1", "parity", "production",
                                             "stage"))
                       for key in kernel_counts()}

    # 12c: the (2, 2) mesh's asymmetric fit against one process
    from evcouplings_torch.ops.plm import PlmConfig
    from evcouplings_torch.ops.plm_sites import fit_plm_asym

    table = []
    fit, secs = timed(lambda: fit_plm_asym(
        codes, weights, 21, PlmConfig(**task["asym"]),
        callback=table.append, device="cuda"))
    ref = _fit_record(fit, table, secs, None, True)
    ranks = phase12_wait(started)
    assert [r["coords"] for r in ranks] == [
        {"data": d, "model": m} for d in (0, 1) for m in (0, 1)]
    assert len({r["asym"]["digest"] for r in ranks}) == 1
    _check_fit("phase 12c per-site LBFGS on a (2, 2) mesh ({:.2f} s; one "
               "process {:.2f} s) against one process".format(
                   ranks[0]["asym"]["secs"], secs),
               ranks[0]["asym"], ref, tol=ASYM_TOL)
    launches["12c"] = {key: sum(r["asym"]["launches"][key] for r in ranks)
                       for key in kernel_counts()}
    log("phase 12 launches by sub-phase: {}".format(json.dumps(launches)))
    return launches


def run_job(config):
    """One pipeline job through execute_wrapped, its kernel launches
    counted from zero, and its final state; every file the final outcfg
    names must exist. Returns (state, launches, seconds)."""
    from evcouplings_torch.utils import pipeline
    from evcouplings_torch.utils.config import (
        iterate_files, read_config_file,
    )

    (state, secs), counts = counted(lambda: timed(
        lambda: pipeline.execute_wrapped(**config)))
    final = read_config_file(config["global"]["prefix"] + "_final.outcfg")
    assert set(final) == set(state)
    missing = [p for p, _, _ in iterate_files(final)
               if not os.path.isfile(p)]
    assert not missing, missing
    return state, counts, secs


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    # raises ImportError when the port's package is not beside the script
    from evcouplings_torch._device import matmul_precision
    from evcouplings_torch.couplings.fitter import run_plm
    from evcouplings_torch.couplings.model import CouplingsModel
    from evcouplings_torch.kernels import _build
    from evcouplings_torch.kernels import adam_update as k_adam
    from evcouplings_torch.kernels import reweight as k_reweight
    from evcouplings_torch.kernels import seqdot as k_seqdot
    from evcouplings_torch.ops.plm import (
        PlmConfig, _augmented_width, fit_plm,
    )
    from evcouplings_torch.ops.plm_update import adam_update_reference
    from evcouplings_torch.ops.weights import (
        _identity_count_threshold, _num_cluster_members_plain,
    )

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log("phase 1 device:", kind, "|", smi.splitlines()[0])
    log("torch", torch.__version__, "cuda", torch.version.cuda)

    # ---- phase 1: build every native source, one compiler each, at once
    t = time.perf_counter()
    _build.build_all(["reweight", "seqdot", "seqdot_host", "fasta_io",
                      "stockholm_io"])
    log("phase 1 build: {:.1f} s (nvcc/cc, in parallel)".format(
        time.perf_counter() - t))
    rng = np.random.default_rng(SEED)
    rows = {}

    # ---- phase 2: K1 against its plain version, counts exactly equal, at
    # the timed shapes (N=32768, and the main path's N=16385 of phase 5),
    # a ragged one, and odd L with ragged n and all -1 rows
    for n, L, timed in ((32768, 160, True), (16385, 160, True),
                        (1000, 37, False), (777, 53, False)):
        codes_np = synthetic_codes(rng, n, L, 21, families=max(8, n // 64),
                                   mutate=0.08, gap_rows=0.2,
                                   missing_rows=0.05)
        if n == 777:
            codes_np[[0, 400, 776]] = -1
        codes = torch.as_tensor(codes_np, device=dev)
        min_count = _identity_count_threshold(L, 0.8)
        got = k_reweight.neighbor_counts(codes, min_count)
        with matmul_precision("highest"):
            want = _num_cluster_members_plain(codes, min_count)
        torch.cuda.synchronize()
        n_bad = int((got != want).sum())
        assert n_bad == 0, "K1 disagrees on {} of {} rows".format(n_bad, n)
        log("phase 2 K1 N={} L={}: counts equal, mean count {:.2f}, max "
            "{}".format(n, L, float(want.float().mean()), int(want.max())))
        if not timed:
            continue
        # the kernel alone (on rows padded as the wrapper pads them), and
        # the wrapper's whole call (its host read of q, the padding)
        q = int(codes.max()) + 1
        padded = k_reweight.pad_codes(codes)
        ms = cuda_ms(lambda: k_reweight.launch(padded, q, min_count), 10)
        call_ms = cuda_ms(
            lambda: k_reweight.neighbor_counts(codes, min_count), 10)
        del padded
        with matmul_precision("highest"):
            plain_ms = cuda_ms(
                lambda: _num_cluster_members_plain(codes, min_count), 2)
        # library yardstick: the (n, Lq) x (Lq, n) int8 identity GEMM alone
        # (torch._int_mm wants a multiple of 8 rows: zero rows pad it)
        n8 = -(-n // 8) * 8
        oh8 = torch.zeros((n8, L * 21), dtype=torch.int8, device=dev)
        oh8[:n] = (codes.long().unsqueeze(-1) == torch.arange(
            21, device=dev)).to(torch.int8).reshape(n, L * 21)
        lib_ms = cuda_ms(lambda: torch._int_mm(oh8, oh8.T), 3)
        del oh8
        # least time for the function: the identity GEMM over the dense
        # one-hot (depth L q), one triangle of the symmetric product; and
        # the bound of K1's own layout (depth 32 per site and 32 symbols)
        bound = n * (n + 1) * L * q / INT8_TC_OPS_PER_S * 1e3
        layout_bound = (n * (n + 1) * L * 32 * (-(-q // 32))
                        / INT8_TC_OPS_PER_S * 1e3)
        log("phase 2 K1 N={} L={}: kernel {:.4f} ms (wrapper call {:.4f} "
            "ms), plain {:.3f} ms, bound {:.4f} ms (N(N+1) L q int8 "
            "tensor-core ops), K1 layout's bound {:.4f} ms (N(N+1) L 32 "
            "ops), library torch._int_mm identity GEMM alone {:.4f} "
            "ms".format(n, L, ms, call_ms, plain_ms, bound, layout_bound,
                        lib_ms))
        if n != 16385:
            continue
        rows["K1"] = dict(
            name="K1 neighbor counts (reweighting)", route="cuda",
            source="evcouplings_torch/csrc/reweight.cu",
            replaces="evcouplings_tpu/ops/weights_pallas.py:75",
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by="operations", library_ms=lib_ms)

    # ---- phase 3: K2 and K3 against adam_update_reference
    L, q = 160, 21
    lq = L * q
    site = np.arange(lq) // q
    mask = (site[:, None] != site[None, :]).astype(np.float32)
    A = rng.normal(size=(lq, lq)).astype(np.float32)
    B = rng.normal(size=(lq, lq)).astype(np.float32)
    P = torch.as_tensor(0.5 * (A + A.T) * mask, device=dev)
    mu = torch.as_tensor(0.5 * (B + B.T) * mask, device=dev)
    nu = torch.as_tensor(np.abs(0.5 * (B + B.T)) * mask, device=dev)
    dJh = torch.as_tensor(rng.normal(
        size=(lq, _augmented_width(lq))).astype(np.float32), device=dev)
    S = (dJh[:, :lq] + dJh[:, :lq].T).contiguous()
    kw = dict(q=q, lambda_j=0.7, lr=3e-3)
    t = time.perf_counter()
    for name, launch, arg in (
            ("K2", k_adam.fused_adam_update_cuda, dJh),
            ("K3", k_adam.fused_adam_update_presym_cuda, S)):
        err = 0.0
        for out_dtype in (torch.bfloat16, torch.float32):
            got = launch(arg, P, mu, nu, 1.25, 1.05, out_dtype=out_dtype,
                         **kw)
            want = adam_update_reference(dJh, P, mu, nu, 1.25, 1.05,
                                         out_dtype=out_dtype, **kw)
            torch.cuda.synchronize()
            if name == "K2" and out_dtype == torch.bfloat16:
                log("phase 3 Triton compile + first launch: {:.1f} s".format(
                    time.perf_counter() - t))
            # f32 outputs: rtol = atol = 2e-6, the JAX kernel's own gate
            for g, w in zip(got[:3], want[:3]):
                torch.testing.assert_close(g, w, rtol=2e-6, atol=2e-6)
                err = max(err, float((g - w).abs().max()))
            # J_eff: f32 as P'; bf16 within the f32 gate's atol plus one
            # bf16 ulp (both round an f32 P' that may differ in its last
            # bits, or by the atol where P' cancels to near zero)
            gj, wj = got[3].float(), want[3].float()
            if out_dtype == torch.float32:
                torch.testing.assert_close(gj, wj, rtol=2e-6, atol=2e-6)
            else:
                excess = (gj - wj).abs() - 2e-6 - 2.0 ** -7 * torch.maximum(
                    gj.abs(), wj.abs())
                assert float(excess.max()) <= 0.0, (name,
                                                    float(excess.max()))
            # sum of g^2 over 11.3M terms in another order: rtol 1e-5
            torch.testing.assert_close(got[4], want[4], rtol=1e-5, atol=0)
        ms = cuda_ms(lambda: launch(arg, P, mu, nu, 1.25, 1.05, **kw), 20)
        plain_ms = cuda_ms(lambda: adam_update_reference(
            dJh, P, mu, nu, 1.25, 1.05, **kw), 5)
        # each input read once, each output written once: dJh[:, :Lq] (or
        # S), P, mu, nu in f32; P', mu', nu' in f32, J_eff in bf16
        nbytes = lq * lq * (4 * 4 + 3 * 4 + 2)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log("phase 3 {} Lq={}: max |err| f32 outputs {:.2e}, kernel {:.4f} "
            "ms, plain {:.4f} ms, bound {:.4f} ms ({:.0f} MB)".format(
                name, lq, err, ms, plain_ms, bound, nbytes / 1e6))
        rows[name] = dict(
            name="{} fused Adam epilogue{}".format(
                name, " (presymmetrized S)" if name == "K3" else ""),
            route="triton",
            source="evcouplings_torch/kernels/adam_update.py",
            replaces=("evcouplings_tpu/ops/plm_update.py:59" if name == "K2"
                      else "evcouplings_tpu/ops/plm_update.py:103"),
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by="bytes", library_ms=None)
    del A, B, P, mu, nu, dJh, S

    # ---- phase 3b: K4 against its host version, bitwise: one batch of
    # four pairs at the main path's D (one an odd-offset slice, as the
    # engine's x[d:]), then n = 0, 1 and 4097
    d = lq * lq + lq
    x = torch.as_tensor(rng.normal(size=d).astype(np.float32), device=dev)
    y = torch.as_tensor(rng.normal(size=d).astype(np.float32), device=dev)
    batch = ([x, x[3:], x, y], [y, y[:-3], x, y])
    for xs, ys in (batch, ([x[:0], x[:1], x[5:4102]],
                           [y[:0], y[1:2], y[:4097]])):
        got = k_seqdot.sequential_dots(xs, ys)
        for g, a, b in zip(got, xs, ys):
            want = k_seqdot._sequential_dot_plain(a.cpu(), b.cpu())
            assert float(g) == float(want), (a.numel(), float(g),
                                             float(want))
    ms = cuda_ms(lambda: k_seqdot.sequential_dot(x, y), 3)
    batch_ms = cuda_ms(lambda: k_seqdot.sequential_dots(*batch), 3)
    xc, yc = x.cpu(), y.cpu()
    plain_ms = host_ms(lambda: k_seqdot._sequential_dot_plain(xc, yc), 3)
    lib_ms = cuda_ms(lambda: torch.dot(x, y), 20)
    # least time of one chain: D dependent FMAs at their latency and the
    # card's highest SM clock; the bytes figure (x and y read once) beside
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    bound = d * FMA_LATENCY_CYCLES / (max_sm_mhz * 1e6) * 1e3
    bytes_bound = 2 * 4 * d / HBM_BYTES_PER_S * 1e3
    log("phase 3b K4 D={}: sequential_dots bitwise equal to the host chain "
        "(batch of 4 incl. an odd offset; n = 0, 1, 4097), one chain {:.3f} "
        "ms, batch of 4 {:.3f} ms, host plain {:.3f} ms, torch.dot {:.4f} "
        "ms, latency bound {:.3f} ms ({} cycles per FMA at {:.0f} MHz), "
        "bytes bound {:.4f} ms".format(
            d, ms, batch_ms, plain_ms, lib_ms, bound, FMA_LATENCY_CYCLES,
            max_sm_mhz, bytes_bound))
    rows["K4"] = dict(
        name="K4 sequential float32 dot (parity-mode LBFGS)", route="cuda",
        source="evcouplings_torch/csrc/seqdot.cu",
        replaces="evcouplings_tpu/ops/lbfgs.py:98 (jnp.dot, no Pallas "
                 "kernel)",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="latency", library_ms=lib_ms, batch4_ms=batch_ms,
        bytes_bound_ms=bytes_bound)
    del x, y, xc, yc, batch

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")

    # ---- phase 4: golden parity fit (tests/test_golden_regression.py)
    golden_kw = dict(focus_seq="TARGET_SEQ/11-28", theta=0.8,
                     lambda_h=0.01, lambda_J=16.15, solver="lbfgs",
                     compute_dtype="float32", matmul_precision="highest")
    want_ec = read_ec(os.path.join(GOLDEN, "golden_ECs.txt"))
    want_m = CouplingsModel(os.path.join(GOLDEN, "golden.model"))

    def golden_fit(device, iterations):
        tag = "{}_{}".format(device, iterations)
        table = []
        t = time.perf_counter()
        run_plm(os.path.join(GOLDEN, "golden.a2m"),
                os.path.join(tmp, tag + "_ECs.txt"),
                os.path.join(tmp, tag + ".model"), iterations=iterations,
                device=device, callback=table.append, **golden_kw)
        return (read_ec(os.path.join(tmp, tag + "_ECs.txt")),
                CouplingsModel(os.path.join(tmp, tag + ".model")),
                np.array([r["fx"] for r in table]), time.perf_counter() - t)

    def gate(got_ec, got_m, ref_ec, ref_m):
        """Excess over the golden gate, max |err| / (ATOL + RTOL |ref|)
        per quantity (<= 1 passes), and the max absolute errors."""
        pairs = {"cn": (got_ec.cn, ref_ec.cn), "fn": (got_ec.fn, ref_ec.fn),
                 "J_ij": (got_m.J_ij, ref_m.J_ij),
                 "h_i": (got_m.h_i, ref_m.h_i)}
        return ({k: max_rel_excess(g, w) for k, (g, w) in pairs.items()},
                {k: float(np.max(np.abs(np.asarray(g) - np.asarray(w))))
                 for k, (g, w) in pairs.items()})

    # 4a: the port's host path on this machine reproduces the fixture at
    # the gate's tolerance (the parity arithmetic, including K4's host
    # version for the LBFGS dot products)
    cpu_ec, cpu_m, cpu_fx, secs = golden_fit("cpu", 40)
    excess, _ = gate(cpu_ec, cpu_m, want_ec, want_m)
    assert max(excess.values()) <= 1.0, excess
    assert_exact_rank_order(cpu_ec, want_ec)
    log("phase 4a golden fit, port on the host ({:.1f} s): gate passed, "
        "excess {}".format(secs, json.dumps(excess)))

    # 4b: over 20 iterations the card agrees with the host path at the
    # gate's tolerance (1-ulp differences of the card's arithmetic have
    # not been amplified yet)
    k1_before = k_reweight.neighbor_counts.launches
    ref20 = golden_fit("cpu", 20)
    card20 = golden_fit("cuda", 20)
    assert k_reweight.neighbor_counts.launches > k1_before
    excess, _ = gate(card20[0], card20[1], ref20[0], ref20[1])
    assert max(excess.values()) <= 1.0, excess
    # no distinguishable pair may swap; the near-tie bounds are the
    # fixture's (the 20-iteration ranking has near-ties of its own)
    assert_exact_rank_order(card20[0], ref20[0], max_exempt_frac=1.0,
                            max_top_l_exempt=len(ref20[0]))
    np.testing.assert_allclose(card20[2], ref20[2], rtol=1e-5)
    log("phase 4b 20-iteration fit, card vs host: gate passed, excess "
        "{}".format(json.dumps(excess)))

    # 4c: the full 40-iteration fit on the card against the fixture. The
    # fit amplifies 1-ulp differences of the gradient to ~4e-4 in J_ij
    # and ~5e-3 in h_i by iteration 40 (one f32 ulp of noise injected
    # into the host path's gradient moves it that far, see
    # tests/test_torch_fitter.py::test_golden_fit_ulp_sensitivity), so
    # the card is held to twice that envelope, with the objective at
    # every iteration within 2e-5 of the host path's.
    card_ec, card_m, card_fx, secs = golden_fit("cuda", 40)
    assert (card_ec.i.values == want_ec.i.values).all()
    assert (card_ec.j.values == want_ec.j.values).all()
    np.testing.assert_allclose(card_m.weights, want_m.weights, rtol=1e-6)
    np.testing.assert_allclose(card_m.f_i, want_m.f_i, rtol=1e-6)
    excess, abs_err = gate(card_ec, card_m, want_ec, want_m)
    log("phase 4c golden fit on the card ({:.1f} s): excess over the "
        "1e-4 gate {}, max |err| {}".format(
            secs, json.dumps(excess), json.dumps(abs_err)))
    envelope = {"cn": 1e-3, "fn": 1e-3, "J_ij": 1e-3, "h_i": 1e-2}
    assert all(abs_err[k] <= envelope[k] for k in envelope), abs_err
    np.testing.assert_allclose(card_fx, cpu_fx, rtol=2e-5)
    log("phase 4c within the 1-ulp amplification envelope {}; fx within "
        "2e-5 of the host path at every iteration".format(
            json.dumps(envelope)))

    # ---- phase 5: the main path at full width
    n, L = 16384, 160
    codes_np = synthetic_codes(rng, n, L, 21, families=256, mutate=0.15,
                               gap_rows=0.1, missing_rows=0.0)
    a2m = os.path.join(tmp, "pf00071_scale.a2m")
    write_a2m(a2m, codes_np)
    common = dict(focus_seq="TARGET/1-160", theta=0.8, lambda_h=0.01,
                  lambda_J=0.01 * 20 * 159)
    for counter in (k_reweight.neighbor_counts, k_seqdot.sequential_dots,
                    k_adam.fused_adam_update_cuda,
                    k_adam.fused_adam_update_presym_cuda):
        counter.launches = 0
    k_seqdot.sequential_dots.chains = 0
    modes = (
        ("parity", dict(iterations=5, solver="lbfgs",
                        compute_dtype="float32",
                        matmul_precision="highest")),
        ("production", dict(iterations=20, solver="adam",
                            compute_dtype="bfloat16", fused_update="on")),
    )
    for mode, kw in modes:
        table = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = run_plm(a2m, os.path.join(tmp, mode + "_ECs.txt"),
                      os.path.join(tmp, mode + ".model"),
                      callback=table.append, **common, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        fx = [r["fx"] for r in table]
        assert len(fx) == kw["iterations"], (mode, len(fx))
        assert np.all(np.isfinite(fx)), (mode, fx)
        ec = read_ec(os.path.join(tmp, mode + "_ECs.txt"))
        assert len(ec) == L * (L - 1) // 2 and np.isfinite(ec.cn).all()
        if mode == "production":
            assert fx[-1] < fx[0], fx
        log("phase 5 {} N={} L={}: {} iterations in {:.2f} s, {:.3e} "
            "seq*site/s (run_plm end to end), fx {:.2f} -> {:.2f}, "
            "status {!r}".format(
                mode, res.num_valid_seqs, L, len(fx), secs,
                res.num_valid_seqs * L * len(fx) / secs, fx[0], fx[-1],
                res.optimization_status))
        if mode == "parity":
            serial = k_seqdot.sequential_dots.launches
            log("phase 5 parity: {} K4 launches (serial chain latencies) "
                "for {} chains; {} before batching".format(
                    serial, k_seqdot.sequential_dots.chains,
                    PARITY_CHAINS_UNBATCHED))
            assert 0 < serial < PARITY_CHAINS_UNBATCHED, serial
    launches = {
        "K1": k_reweight.neighbor_counts.launches,
        "K2": k_adam.fused_adam_update_cuda.launches,
        "K3": k_adam.fused_adam_update_presym_cuda.launches,
        "K4": k_seqdot.sequential_dots.launches,
    }
    log("phase 5 launches on the main path:", json.dumps(launches))
    for k in ("K1", "K2", "K4"):
        assert launches[k] > 0, (k, launches)

    # ---- phase 5b: where the time goes: one more fit of each mode under
    # torch.profiler; device time by kernel and the device's busy share of
    # the wall time (kernels, copies and fills on the one stream)
    for mode, kw in modes:
        profile_device_time("phase 5b " + mode, lambda: run_plm(
            a2m, os.path.join(tmp, mode + "_prof_ECs.txt"),
            os.path.join(tmp, mode + "_prof.model"), **common, **kw))

    # per-step time of the production Adam step, fused epilogue on vs off
    # (two fits each, alternating; steps 5..19 of each fit)
    codes_fit = np.where(codes_np < 0, -1, codes_np)
    weights = np.ones(n)
    step_ms = {"on": [], "off": []}
    for fused in ("off", "on", "on", "off"):
        cfg = PlmConfig(solver="adam", dtype="bfloat16", block_size=8192,
                        max_iter=20, lambda_J=common["lambda_J"],
                        fused_update=fused)
        table = []
        fit_plm(codes_fit, weights, 21, cfg, callback=table.append,
                device=dev)
        step_ms[fused].append(
            (table[19]["time"] - table[4]["time"]) * 1e3 / 15)
    log("phase 5 production step ms, fused_update on {} vs off {}".format(
        step_ms["on"], step_ms["off"]))

    # ---- phase 6: the pipeline, through the entry point users call:
    # execute_wrapped with stages [align, couplings] (align `existing`,
    # couplings `standard`), then the mutate protocol on its outputs
    import pandas as pd

    from evcouplings_torch.utils.system import insert_dir

    not_produced = set()

    # 6a: card against host at a small size (N=150, L=18). With this
    # config's lambda_J (lambda_J_times_Lq: 3.4, against the golden fit's
    # 16.15) the fit amplifies the card's one-ulp differences faster than
    # phase 4b's: the gate is held at 12 iterations, and the excess at 20
    # is printed beside it
    small = os.path.join(tmp, "synthetic.a2m")
    write_synthetic_a2m(small)
    align_kw = small_align_kw = dict(
        extract_annotation=False, minimum_sequence_coverage=50,
        minimum_column_coverage=70, compute_num_effective_seqs=True)

    def small_jobs(iterations, with_mutate):
        couplings_kw = dict(iterations=iterations, reuse_ecs=False,
                            min_sequence_distance=3,
                            scoring_model="skewnormal")
        jobs = {}
        for device in ("cuda", "cpu"):
            root = os.path.join(tmp, "small{}_{}".format(iterations, device))
            state, counts, secs = run_job(pipeline_config(
                os.path.join(root, "job"), small, "TARGET_SEQ", align_kw,
                couplings_kw, device=None if device == "cuda" else "cpu"))
            mut, mut_secs = (run_mutate(
                state["model_file"], os.path.join(root, "mutate", "job"),
                not_produced) if with_mutate else (None, 0.0))
            jobs[device] = (state, mut)
            log("phase 6a {} iterations, {} job: {:.2f} s, stages {}, mutate "
                "{:.2f} s, kernel launches {}".format(
                    iterations, device, secs,
                    json.dumps(runtime_seconds(state)), mut_secs,
                    json.dumps(counts)))
            if device == "cuda":
                assert counts["K1"] == 2 and counts["K4"] > 0, counts
        (card, _), (host, _) = jobs["cuda"], jobs["cpu"]
        card_m, host_m = (CouplingsModel(s["model_file"])
                          for s in (card, host))
        excess = {a: max_rel_excess(getattr(card_m, a), getattr(host_m, a))
                  for a in ("J_ij", "h_i", "f_i", "f_ij")}
        card_ec, host_ec = (pd.read_csv(s["ec_file"]).sort_values(["i", "j"])
                            for s in (card, host))
        for col in ("cn", "fn"):
            excess[col] = max_rel_excess(card_ec[col], host_ec[col])
        return jobs, excess, card_ec, host_ec

    jobs, excess, card_ec, host_ec = small_jobs(12, with_mutate=True)
    (card, card_mut), (host, host_mut) = jobs["cuda"], jobs["cpu"]
    assert set(card) - {"device"} == set(host) - {"device"}
    with open(card["alignment_file"]) as a, open(host["alignment_file"]) as b:
        assert a.read() == b.read(), "focus .a2m differs"
    for key in ("identities_file", "frequencies_file",
                "sequence_weights_file", "statistics_file"):
        got, want = pd.read_csv(card[key]), pd.read_csv(host[key])
        if key == "statistics_file":
            got, want = got.drop(columns="prefix"), want.drop(columns="prefix")
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert max(excess.values()) <= 1.0, excess
    assert_exact_rank_order(card_ec, host_ec)
    # the skew-normal EM amplifies gate-sized CN differences: atol 1e-3
    prob_err = float(np.max(np.abs(card_ec.probability.values
                                   - host_ec.probability.values)))
    assert prob_err <= 1e-3, prob_err
    got, want = (pd.read_csv(m["mutation_matrix_file"])
                 for m in (card_mut, host_mut))
    assert (got.mutant.values == want.mutant.values).all()
    # a Delta-E sums L + 1 parameter differences, each within the gate
    n_terms = got.pos.nunique() + 1
    for col in ("prediction_epistatic", "prediction_independent"):
        err = np.abs(got[col].values - want[col].values)
        assert np.all(err <= n_terms * ATOL + RTOL * np.abs(want[col])), col
    log("phase 6a card vs host, 12 iterations: .a2m and the align CSVs "
        "equal, outcfg keys equal; excess over the 1e-4 gate {}; "
        "skew-normal probability max |err| {:.2e} (atol 1e-3); "
        "single-mutant matrix within RTOL and {} ATOL".format(
            json.dumps(excess), prob_err, n_terms))
    _, excess20, _, _ = small_jobs(20, with_mutate=False)
    log("phase 6a card vs host, 20 iterations (not gated): excess over the "
        "1e-4 gate {}".format(json.dumps(excess20)))

    # 6b: full width. The phase-5 synthetic (N=16384 + focus row, L=160,
    # q=21) with 8 planted covarying pairs, through the sample monomer
    # config's align and couplings settings (coverage filters, theta 0.8,
    # lambda_J_times_Lq, logistic-regression scoring, min sequence
    # distance 6); N_eff is computed in the align stage. Depth is cut:
    # 5 iterations instead of 100.
    rng6 = np.random.default_rng(SEED + 6)
    codes6 = synthetic_codes(rng6, n, L, 21, families=256, mutate=0.15,
                             gap_rows=0.1, missing_rows=0.0)
    plant_pairs(rng6, codes6, PLANTED)
    full = os.path.join(tmp, "pf00071_scale_planted.a2m")
    write_a2m(full, codes6)
    del codes6
    align_kw = dict(extract_annotation=True, minimum_sequence_coverage=50,
                    minimum_column_coverage=70,
                    compute_num_effective_seqs=True)
    sample_couplings = dict(iterations=5, reuse_ecs=True,
                            checkpoint_every=None, solver="lbfgs",
                            precision="parity", steps_per_call=1,
                            pad_sites=None, pad_rows=None,
                            parametrization="auto", fit_devices=None,
                            model_shards=None,
                            scoring_model="logistic_regression",
                            min_sequence_distance=6)
    production = dict(sample_couplings, solver="adam",
                      precision="production", iterations=20,
                      steps_per_call=None)
    pipeline_launches = dict.fromkeys(kernel_counts(), 0)
    for mode, couplings_kw in (("parity", sample_couplings),
                               ("production", production)):
        prefix = os.path.join(tmp, "full_" + mode, "job")
        state, counts, secs = run_job(pipeline_config(
            prefix, full, "TARGET", align_kw, couplings_kw))
        if mode == "parity":
            # phase 12 runs this job's couplings stage again, sharded
            full_state = state
            stage_incfg = (insert_dir(prefix, "couplings")
                           + "_couplings.incfg")
        for k in counts:
            pipeline_launches[k] += counts[k]
        stage_secs = runtime_seconds(state)
        fit_secs = float(pd.read_csv(
            insert_dir(prefix, "couplings")
            + "_iteration_table.csv").time.iloc[-1])
        longrange = pd.read_csv(state["ec_longrange_file"])
        top8 = set(zip(longrange.i.values[:8], longrange.j.values[:8]))
        want8 = {(i + 1, j + 1) for i, j in PLANTED}
        log("phase 6b {} job N={} (after the coverage filter; N_eff {:.1f}) "
            "L={}: {:.2f} s; stages {}; couplings fit loop {:.2f} s, host "
            "rest of the couplings stage {:.2f} s; kernel launches {}; "
            "planted pairs in the top 8 long-range ECs: {}/8".format(
                mode, state["num_sequences"], state["effective_sequences"],
                state["num_sites"], secs, json.dumps(stage_secs), fit_secs,
                stage_secs["couplings"] - fit_secs, json.dumps(counts),
                len(top8 & want8)))
        assert counts["K1"] == 2, counts
        if mode == "parity":
            assert counts["K4"] > 0 and counts["K2"] == 0, counts
            assert top8 == want8, sorted(top8)
            mut, mut_secs = run_mutate(
                state["model_file"], os.path.join(
                    os.path.dirname(prefix), "mutate", "job"), not_produced)
            table = pd.read_csv(mut["mutation_matrix_file"])
            assert len(table) == L * 19, len(table)
            assert np.isfinite(table.prediction_epistatic).all()
            log("phase 6b parity mutate: {:.2f} s, {} single mutants".format(
                mut_secs, len(table)))
        else:
            assert counts["K2"] > 0, counts
    log("phase 6 pipeline launches (both full-width jobs):",
        json.dumps(pipeline_launches))

    # ---- phase 7: the couplings stage's other fit routes at full width:
    # exact group-L1 (FISTA), checkpoint/resume, the asymmetric fit and
    # mean-field DCA; each sub-phase counts its kernel launches from zero
    t7 = time.perf_counter()
    phase7 = {
        "7a fista run_plm": phase7a_fista(tmp, a2m, common),
        **{"7b " + k: v for k, v in phase7b_resume(
            tmp, codes_fit, common["lambda_J"]).items()},
    }
    phase7c_asymmetric(tmp, a2m, codes_fit, common, gate)
    phase7["7d mean-field full-width job"] = phase7d_mean_field(
        tmp, small, full)
    log("phase 7 launches by path: {}; phase 7 took {:.1f} s".format(
        json.dumps(phase7), time.perf_counter() - t7))

    # ---- phase 8: the compare stage: the float64 distance contraction
    # alone (8a), card against host at a small size (8b), the full-width
    # four-stage job (8c); K1 launches twice per job
    import importlib.util

    t8 = time.perf_counter()
    log("phase 8 packages: msgpack {}, matplotlib {}".format(
        *("present" if importlib.util.find_spec(m) else "absent"
          for m in ("msgpack", "matplotlib"))))
    phase8a(rng)
    phase8 = {"8b small job": phase8b(tmp, small, small_align_kw,
                                      not_produced),
              "8c full-width job": phase8c(tmp, full, align_kw,
                                           sample_couplings, not_produced)}
    phase8_launches = {k: sum(c[k] for c in phase8.values())
                       for k in kernel_counts()}
    log("phase 8 launches by job: {}; phase 8 took {:.1f} s".format(
        json.dumps(phase8), time.perf_counter() - t8))

    # ---- phase 9: the sampler, and the search protocols' jobs (K1 twice
    # per job: the align stage's N_eff and the couplings stage)
    import shutil

    t9 = time.perf_counter()
    shutil.rmtree(SEARCH_DIR, ignore_errors=True)
    phase9_probe()
    phase9a_sampler()
    phase9 = {"9b small search job": phase9b(tmp, small, not_produced),
              "9c full-width search job": phase9c(tmp, full,
                                                  sample_couplings,
                                                  not_produced)}
    phase9_launches = {k: sum(c[k] for c in phase9.values())
                       for k in kernel_counts()}
    log("phase 9 launches by job: {}; phase 9 took {:.1f} s".format(
        json.dumps(phase9), time.perf_counter() - t9))

    # ---- phase 10: the C alignment readers against the Python readers
    # (10a), the five-stage job card against host at a small size (10b)
    # and at full width with the sample config's fold settings (10c)
    t10 = time.perf_counter()
    shutil.rmtree(FOLD_DIR, ignore_errors=True)
    phase10_probe()
    phase10 = {"10a align jobs": phase10a_readers(tmp, full, align_kw),
               "10b small five-stage job": phase10b(tmp, small,
                                                    small_align_kw,
                                                    not_produced)}
    t10c = time.perf_counter()
    phase10["10c full-width five-stage job"] = phase10c(
        tmp, full, align_kw, sample_couplings, not_produced)
    phase10_launches = {k: sum(c[k] for c in phase10.values())
                        for k in kernel_counts()}
    log("phase 10 launches by job: {}; 10c took {:.1f} s, phase 10 {:.1f} "
        "s".format(json.dumps(phase10), time.perf_counter() - t10c,
                   time.perf_counter() - t10))

    # ---- phase 11: the protein-complex pipeline, card against host at a
    # small size with both concatenation protocols (11a), then at full
    # width with the sample complex config's settings (11b)
    t11 = time.perf_counter()
    phase11 = {"11a small complex jobs": phase11a(tmp, not_produced)}
    t11b = time.perf_counter()
    phase11["11b full-width complex job"] = phase11b(tmp, rng, not_produced)
    phase11_launches = {k: sum(c[k] for c in phase11.values())
                        for k in kernel_counts()}
    log("phase 11 launches by job: {}; 11b took {:.1f} s, phase 11 {:.1f} "
        "s".format(json.dumps(phase11), time.perf_counter() - t11b,
                   time.perf_counter() - t11))

    # ---- phase 12: the sharded fits over torch.distributed: NCCL at world
    # size 1 in this process (12a), 3 gloo ranks (12b) and a (2, 2) mesh of
    # 4 gloo ranks (12c) sharing the card
    t12 = time.perf_counter()
    phase12_launches = phase12(tmp, phase12_alignment(tmp),
                               common["focus_seq"], full_state, stage_incfg,
                               common["lambda_J"], rows)
    log("phase 12 took {:.1f} s".format(time.perf_counter() - t12))

    for k, row in rows.items():
        row["distributed_launches"] = {
            sub: counts[k] for sub, counts in phase12_launches.items()}
        row["launches"] = launches[k]
        row["pipeline_launches"] = pipeline_launches[k]
        row["compare_job_launches"] = phase8_launches[k]
        row["search_job_launches"] = phase9_launches[k]
        row["fold_job_launches"] = phase10_launches[k]
        row["complex_job_launches"] = phase11_launches[k]
    for item in sorted(not_produced):
        log("phase 6 not produced:", item)
    log(json.dumps({"kernels": [rows[k] for k in ("K1", "K2", "K3", "K4")]}))
    log(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase12-worker"]:
        sys.exit(phase12_worker(*sys.argv[2:]))
    sys.exit(main())
