#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port (evcouplings_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every kernel from the sources in this checkout, holds each kernel
against its plain version on the card, reproduces the golden parity fit,
then drives the port's main path, run_plm (the in-process plmc
replacement), at the full width of the repository's headline shape
(N=16384 sequences, L=160 sites, q=21) in parity and production mode.
Every phase raises on a mismatch; nothing is caught. The last lines are a
JSON object describing each kernel, the card's name and power limit as
nvidia-smi reports them, and {"ok": true, "device": {...}}.

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

# golden-fit gate of the repository (tests/test_golden_regression.py)
RTOL, ATOL = 1e-4, 1e-5


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
                            max_top_l_exempt=0):
    """Every pair of ECs whose golden cn scores differ by more than the
    gate's tolerance must rank the same way in the refit; at most
    max_exempt_frac of all comparisons may be exempt as near-ties, and
    none among the top-L (the rule of the repository's golden gate)."""
    key = list(zip(want.i.values, want.j.values))
    want_cn = dict(zip(key, want.cn.values))
    got_cn = dict(zip(zip(got.i.values, got.j.values), got.cn.values))
    assert set(got_cn) == set(want_cn)
    n_sites = len(set(want.i.values) | set(want.j.values))
    ranked = sorted(key, key=lambda k: -want_cn[k])
    checked = exempt = top_l_exempt = 0
    for idx_a, a in enumerate(ranked):
        for idx_b in range(idx_a + 1, len(ranked)):
            b = ranked[idx_b]
            checked += 1
            gap = want_cn[a] - want_cn[b]
            tol = RTOL * max(abs(want_cn[a]), abs(want_cn[b])) + ATOL
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
    _build.build_all(["reweight", "seqdot", "seqdot_host"])
    log("phase 1 build: {:.1f} s (nvcc/cc, in parallel)".format(
        time.perf_counter() - t))
    rng = np.random.default_rng(SEED)
    rows = {}

    # ---- phase 2: K1 against its plain version, counts exactly equal, at
    # the timed shape, the main path's shape (phase 5) and a ragged one
    for n, L, timed in ((32768, 160, True), (16385, 160, False),
                        (1000, 37, False)):
        codes_np = synthetic_codes(rng, n, L, 21, families=max(8, n // 64),
                                   mutate=0.08, gap_rows=0.2,
                                   missing_rows=0.05)
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
        ms = cuda_ms(lambda: k_reweight.neighbor_counts(codes, min_count), 5)
        with matmul_precision("highest"):
            plain_ms = cuda_ms(
                lambda: _num_cluster_members_plain(codes, min_count), 2)
        oh8 = (codes.long().unsqueeze(-1) == torch.arange(
            21, device=dev)).to(torch.int8).reshape(n, L * 21)
        lib_ms = cuda_ms(lambda: torch._int_mm(oh8, oh8.T), 3)
        del oh8
        ops = 2.0 * n * n * L * 21
        bound = max(ops / INT8_TC_OPS_PER_S, n * L / HBM_BYTES_PER_S) * 1e3
        log("phase 2 K1 N={} L={}: kernel {:.3f} ms, plain {:.3f} ms, "
            "bound {:.3f} ms (int8 tensor-core identity GEMM, 2 N^2 L q "
            "ops), library torch._int_mm identity GEMM alone {:.3f} "
            "ms".format(n, L, ms, plain_ms, bound, lib_ms))
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

    # ---- phase 3b: K4 against its host version, bitwise
    d = lq * lq + lq
    x = torch.as_tensor(rng.normal(size=d).astype(np.float32), device=dev)
    y = torch.as_tensor(rng.normal(size=d).astype(np.float32), device=dev)
    got = k_seqdot.sequential_dot(x, y)
    xc, yc = x.cpu(), y.cpu()
    want = k_seqdot._sequential_dot_plain(xc, yc)
    assert float(got) == float(want), (float(got), float(want))
    ms = cuda_ms(lambda: k_seqdot.sequential_dot(x, y), 3)
    plain_ms = host_ms(lambda: k_seqdot._sequential_dot_plain(xc, yc), 3)
    lib_ms = cuda_ms(lambda: torch.dot(x, y), 20)
    bound = 2 * 4 * d / HBM_BYTES_PER_S * 1e3
    log("phase 3b K4 D={}: bitwise equal to the host chain, kernel {:.3f} "
        "ms, host plain {:.3f} ms, torch.dot {:.4f} ms, bound {:.4f} "
        "ms".format(d, ms, plain_ms, lib_ms, bound))
    rows["K4"] = dict(
        name="K4 sequential float32 dot (parity-mode LBFGS)", route="cuda",
        source="evcouplings_torch/csrc/seqdot.cu",
        replaces="evcouplings_tpu/ops/lbfgs.py:98 (jnp.dot, no Pallas "
                 "kernel)",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="bytes", library_ms=lib_ms)
    del x, y

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
    for counter in (k_reweight.neighbor_counts, k_seqdot.sequential_dot,
                    k_adam.fused_adam_update_cuda,
                    k_adam.fused_adam_update_presym_cuda):
        counter.launches = 0
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
    launches = {
        "K1": k_reweight.neighbor_counts.launches,
        "K2": k_adam.fused_adam_update_cuda.launches,
        "K3": k_adam.fused_adam_update_presym_cuda.launches,
        "K4": k_seqdot.sequential_dot.launches,
    }
    log("phase 5 launches on the main path:", json.dumps(launches))
    for k in ("K1", "K2", "K4"):
        assert launches[k] > 0, (k, launches)

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

    for k, row in rows.items():
        row["launches"] = launches[k]
    log(json.dumps({"kernels": [rows[k] for k in ("K1", "K2", "K3", "K4")]}))
    log(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
