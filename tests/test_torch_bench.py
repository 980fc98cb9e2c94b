"""bench_torch.py, the port's twin of bench.py, held against bench.py and
the JAX package on the CPU: the FLOP and byte accounting, the warm window,
the MFU record (the card's pass model for parity mode), the record keys
(every bench.py key has its twin or is listed by name below), each
record's deterministic content on seeded inputs at a small size against
the JAX package's same functions, and a whole run at SMALL shapes with
JAX blocked from import."""

import ast
import json
import math
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import bench_torch as bt  # noqa: E402

CPU = torch.device("cpu")
GOLDEN_A2M = os.path.join(REPO, "tests", "data", "golden", "golden.a2m")
H100 = "NVIDIA H100 80GB HBM3"

# bench.py keys that bench_torch.py names otherwise (the card's kernel is
# not "pallas", its library route not "xla"; the card's pass model is not
# the TPU's 3 MXU passes)
RENAMED = {
    "reweight_512k_pallas_pairs_per_s": "reweight_512k_kernel_pairs_per_s",
    "reweight_512k_xla_pairs_per_s": "reweight_512k_library_pairs_per_s",
    "reweight_512k_pallas_hbm_bytes": "reweight_512k_kernel_hbm_bytes",
    "reweight_512k_xla_hbm_bytes": "reweight_512k_library_hbm_bytes",
    "parity_mxu_passes": "parity_passes",
    "parity_mxu_duty": "parity_duty",
}
# bench.py keys without a twin: errors are raised, not recorded, and the
# reweighting record runs on any card
DROPPED = {
    "family_fit_error", "pipeline_e2e_error", "reweight_512k_error",
    "reweight_512k_skipped",
}
# keys bench_torch.py adds
ADDED = {
    "device_name", "device_power_limit_w", "vs_measured_cpu_note",
    "production_shape", "production_peak_reserved_bytes",
    "production_peak_allocated_bytes", "parity_lbfgs_window_iterations",
    "mfu_peak_tflops_fp32", "parity_peak_basis", "pipeline_e2e_unit",
    "reweight_512k_counts_equal",
    "reweight_512k_max_count", "reweight_512k_library_block",
}
# the secondary lines, in bench.py's order
SECONDARY_METRICS = ["reweighting_row_pairs_per_s", "lbfgs_iteration_ms",
                     "asym_plm_fit_seq_sites_per_s",
                     "asym_lbfgs_iteration_ms"]


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------

@pytest.mark.parametrize("l,q,block", [
    (160, 21, 8192), (512, 21, 1024), (40, 21, 2048), (18, 21, 512),
    (300, 5, 4096), (96, 21, 128),
])
def test_accounting_matches_bench_py(l, q, block):
    assert bt.plm_flops_per_seq_site(l, q) == bench.plm_flops_per_seq_site(
        l, q)
    for elt in (2, 4):
        assert bt.plm_hbm_bytes_per_row(l, q, block, elt) == \
            bench.plm_hbm_bytes_per_row(l, q, block, elt)


def _stamps(seed, bursts):
    """(time, iter) stamps in `bursts` bursts: callbacks 1e-5 s apart
    within a burst, 5-50 ms between bursts."""
    rng = np.random.default_rng(seed)
    t, it, out = 100.0, 0, []
    for _ in range(bursts):
        for _ in range(int(rng.integers(1, 16))):
            it += 1
            t += 1e-5
            out.append((t, it))
        t += float(rng.uniform(5e-3, 5e-2))
    return out


@pytest.mark.parametrize("seed,bursts", [(0, 1), (1, 2), (2, 4), (3, 7),
                                         (4, 1), (5, 12)])
def test_warm_window_matches_bench_py(seed, bursts):
    stamps = _stamps(seed, bursts)
    got = bt._warm_window(stamps)
    assert got == bench._warm_window(stamps)
    if bursts == 1:
        assert got == (None, 0)
        with pytest.raises(RuntimeError, match="no warm window"):
            bt._window_rate(stamps, "one burst")
    else:
        assert got[1] > 0 and bt._window_rate(stamps, "x") == got


@pytest.mark.parametrize("rates", [(1.2e9, 1.1e8, 2.5e8),
                                   (4.75e8, 1.7e8, None)])
def test_mfu_records_against_bench_py(rates):
    """Production and large-L fields equal bench.py's for the same peak
    dict; parity divides by the fp32 peak of the SIMT cores ("highest" is
    IEEE SGEMM, one pass), not bench.py's bf16 peak times 3 passes."""
    throughput, parity, large_l = rates
    peak = bt.device_peak(H100)
    assert peak == {"device_kind": H100, "bf16_peak_flops": 989.4e12,
                    "fp32_peak_flops": 66.9e12, "int8_peak_ops": 1979e12,
                    "hbm_bytes_per_s": 3.35e12}
    got = bt._mfu_records(throughput, parity, large_l, peak)
    want = bench._mfu_records(throughput, parity, large_l, peak=peak)
    for key in ("mfu_device_kind", "mfu_peak_tflops_bf16",
                "mfu_flop_per_seq_site", "mfu_ai_flop_per_byte",
                "mfu_ridge_flop_per_byte", "mfu_production_tflops",
                "mfu_production", "mfu_parity_tflops", "mfu_large_l_tflops",
                "mfu_large_l"):
        assert (key in got) == (key in want), key
        if key in want:
            assert got[key] == want[key], key
    flop = bench.plm_flops_per_seq_site(160, 21)
    assert got["mfu_peak_tflops_fp32"] == 66.9
    assert got["mfu_parity"] == round(parity * flop / 66.9e12, 3)
    assert got["parity_peak_basis"] == "fp32_simt"
    assert got["parity_passes"] == 1
    assert got["parity_duty"] == got["mfu_parity"]
    # the balanced names run as bf16 limb passes on the tensor cores
    assert bt.gemm_pass_model("high") == ("bf16_tensor", 2)
    assert bt.gemm_pass_model("default") == ("bf16_tensor", 1)


def test_unknown_device_skips_mfu():
    assert bt.device_peak("cpu") is None
    assert bt.device_peak("NVIDIA A100-SXM4-80GB") is None
    assert bt._mfu_records(1e9, 1e8, 1e8, None) == bench._mfu_records(
        1e9, 1e8, 1e8, peak=None)


# ---------------------------------------------------------------------
# record keys
# ---------------------------------------------------------------------

_RECORD_FUNCTIONS = {
    "main", "_mfu_records", "_bench_mi_apc", "_bench_de_scan",
    "_bench_evcomplex", "_bench_fold_prep", "_bench_reweighting_512k",
    "_bench_pipeline_e2e", "_bench_family_fit", "_family_fit_records",
    "_pipeline_e2e_records", "_reweighting_512k_records",
}
# the per-stage keys bench.py formats as "pipeline_{}_s".format(stage)
_STAGES = ("align", "couplings", "compare", "mutate")


def _bench_py_keys():
    """The keys of bench.py's headline record, read from its source: the
    constant keys of the dicts its record functions return, print or
    build as `out`, the constant keys they store into `out`, and the
    per-stage template."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    keys = set()

    def record_dicts(fn):
        for node in ast.walk(fn):
            if isinstance(node, ast.Return) and isinstance(node.value,
                                                           ast.Dict):
                yield node.value
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "attr", None) == "dumps"):
                yield from (a for a in node.args if isinstance(a, ast.Dict))
            elif (isinstance(node, ast.Assign)
                  and isinstance(node.value, ast.Dict)
                  and any(getattr(t, "id", None) == "out"
                          for t in node.targets)):
                yield node.value

    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name in _RECORD_FUNCTIONS):
            continue
        for d in record_dicts(fn):
            keys.update(k.value for k in d.keys
                        if isinstance(k, ast.Constant))
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Subscript)
                    and isinstance(node.ctx, ast.Store)
                    and getattr(node.value, "id", None) == "out"):
                continue
            sl = node.slice
            if isinstance(sl, ast.Constant):
                keys.add(sl.value)
            elif (isinstance(sl, ast.Call)
                  and isinstance(sl.func.value, ast.Constant)):
                assert sl.func.value.value == "pipeline_{}_s"
                keys.update(sl.func.value.value.format(s) for s in _STAGES)
    return keys


def _bench_py_secondary_metrics():
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name.startswith("bench_"):
            for node in ast.walk(fn):
                if isinstance(node, ast.Dict):
                    names += [v.value for k, v in zip(node.keys, node.values)
                              if getattr(k, "value", None) == "metric"]
    return names


def _run_small(args):
    """bench_torch.py as a script in a fresh process with jax,
    evcouplings_tpu and bench blocked from import."""
    code = (
        "import runpy, sys\n"
        "for name in ('jax', 'jaxlib', 'evcouplings_tpu', 'bench'):\n"
        "    sys.modules[name] = None\n"
        "sys.argv = ['bench_torch.py'] + {!r}\n"
        "runpy.run_path({!r}, run_name='__main__')\n".format(
            args, os.path.join(REPO, "bench_torch.py")))
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO,
               MPLBACKEND="Agg")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)


@pytest.fixture(scope="module")
def small_run():
    out = _run_small(["--device", "cpu", "--small", "--all"])
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.splitlines()


def test_small_run_line_layout(small_run):
    """Five lines, each one JSON object: the headline, then the four
    secondaries in bench.py's order; every line names the device, no
    record holds an error, every number is finite."""
    records = [json.loads(line) for line in small_run]
    assert [r["metric"] for r in records] == (
        ["plm_fit_seq_sites_per_s"] + SECONDARY_METRICS)
    assert _bench_py_secondary_metrics() == SECONDARY_METRICS
    for r in records:
        assert r["device_name"] == "cpu"
        assert r["device_power_limit_w"] is None
        assert not [k for k in r if k.endswith("_error")]
        for k, v in r.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                assert math.isfinite(v) and v >= 0, (k, v)
        assert r["value"] > 0
    head = records[0]
    # no device metric from a host run
    assert head["mfu_skipped"] == "unknown device kind"
    assert head["production_peak_reserved_bytes"] is None
    assert head["reweight_512k_kernel_hbm_bytes"] is None
    assert head["unit"] == "seq*site/s on the host"
    assert head["reweight_512k_counts_equal"] is True
    assert head["reweight_512k_max_count"] > 1
    assert head["vs_measured_cpu"] is None
    assert head["family_fit_skipped"] == "reference alignment missing"
    # the job draws no figure on any machine; mutate runs after it
    assert "no figure drawn" in head["pipeline_e2e_unit"]


def test_record_keys_cover_bench_py(small_run):
    """Every key of bench.py's headline record has its twin: the same key,
    or its rename; the dropped and added keys are the named ones."""
    head = json.loads(small_run[0])
    got = (set(head)
           | set(bt._mfu_records(1e9, 1e8, 1e8, bt.device_peak(H100)))
           | set(bt._bench_family_fit(CPU, a2m=GOLDEN_A2M, l_cols=18,
                                      iterations=6)))
    want = _bench_py_keys()
    assert {"metric", "mfu_skipped", "parity_mxu_duty",
            "pipeline_mutate_s", "family_fit_skipped",
            "reweight_512k_xla_hbm_bytes"} <= want
    for key in sorted(want):
        if key in DROPPED:
            assert key not in got, key
        elif key in RENAMED:
            assert RENAMED[key] in got and key not in got, key
        else:
            assert key in got, key
    assert got - want - set(RENAMED.values()) == ADDED


def test_without_a_card_main_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bt.main([])


# ---------------------------------------------------------------------
# each record's deterministic content against the JAX package
# ---------------------------------------------------------------------

def test_mi_apc_content_matches_jax():
    """MI+APC from codes (float32 after exact integer reweighting:
    rtol 1e-5, atol 1e-6, the port's gate for this function), and the
    skew-normal rescoring of one EC table by both packages (the same
    host arithmetic: rtol 1e-9)."""
    from evcouplings_tpu.couplings.pairs import (
        add_mixture_probability as jax_rescore,
    )
    from evcouplings_tpu.ops.scores import mi_apc_from_codes as jax_mi_apc
    from evcouplings_torch.couplings.pairs import add_mixture_probability
    from evcouplings_torch.ops.scores import mi_apc_from_codes

    m = bt.mi_apc_case(600, 96)
    got = mi_apc_from_codes(m, 0.8, num_symbols=21, device="cpu")
    want = jax_mi_apc(m, 0.8, num_symbols=21)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    ecs = bt.mi_apc_ec_table(got[1])
    # the three correlated pairs lead the ranking
    assert set(zip(ecs.i[:3], ecs.j[:3])) == {(4, 51), (11, 78), (21, 32)}
    p_got = add_mixture_probability(ecs, model="skewnormal", score="cn")
    p_want = jax_rescore(ecs, model="skewnormal", score="cn")
    np.testing.assert_allclose(p_got.probability, p_want.probability,
                               rtol=1e-9, atol=1e-12)


def test_de_scan_content_matches_jax():
    """Single and double mutant Delta-E, float64 on both sides: 1e-12."""
    from evcouplings_tpu.ops.hamiltonian import (
        FULL, double_mutant_matrix, single_mutant_hamiltonians,
    )

    J, h, target = bt.de_scan_case(24)
    smm, dmm = bt.de_scan_run(J, h, target)
    want_smm = np.asarray(single_mutant_hamiltonians(target, J, h))
    want_dmm = np.asarray(double_mutant_matrix(want_smm[:, :, FULL], J,
                                               target))
    assert smm.shape == (24, 21, 3) and dmm.shape == (24, 24, 21, 21)
    np.testing.assert_allclose(smm, want_smm, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(dmm, want_dmm, rtol=1e-12, atol=1e-12)


def test_evcomplex_content_matches_jax():
    """EVcomplex probabilities (host scipy on both sides: rtol 1e-9) and
    the inter/intra split (exact counts)."""
    from evcouplings_tpu.couplings.pairs import EVComplexScoreModel

    ecs = bt.evcomplex_case(40)
    scored, inter, intra = bt.evcomplex_run(ecs)
    want = EVComplexScoreModel(ecs.cn.values).probability(ecs.cn.values)
    np.testing.assert_allclose(scored.probability.values, want, rtol=1e-9,
                               atol=1e-12)
    assert (len(inter), len(intra)) == (40 * 40, 2 * 40 * 39 // 2)


def test_fold_prep_content_matches_jax(tmp_path):
    """The restraint file byte for byte and the comparison table exactly
    (the same host code paths in both packages)."""
    from evcouplings_tpu.compare.distances import DistanceMap
    from evcouplings_tpu.compare.ecs import coupling_scores_compared
    from evcouplings_tpu.fold.cns import cns_dist_restraint
    from evcouplings_tpu.fold.restraints import ec_dist_restraints

    ecs, residues, dmat = bt.fold_prep_case(40)
    got = bt.fold_prep_run(ecs, residues, dmat, str(tmp_path / "t.tbl"), 80)
    ec_dist_restraints(ecs.head(80), str(tmp_path / "j.tbl"),
                       cns_dist_restraint)
    want = coupling_scores_compared(
        ecs, DistanceMap(residues, residues, dmat, symmetric=True),
        dist_cutoff=5.0, min_sequence_dist=6)
    assert (tmp_path / "t.tbl").read_bytes() == \
        (tmp_path / "j.tbl").read_bytes()
    n_lines = len((tmp_path / "t.tbl").read_text().splitlines())
    assert n_lines >= 80
    assert len(got) == len(want) == len(ecs)
    pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                  want.reset_index(drop=True))


def test_reweighting_routes_match_jax():
    """Both routes of the reweighting record (K1's plain version on the
    host, the torch._int_mm route) give the JAX package's counts exactly,
    with some rows above 1 (the planted near-copies)."""
    from evcouplings_tpu.ops import weights as jw
    from evcouplings_torch.ops.weights import (
        _identity_count_threshold, _neighbor_counts,
    )

    codes = bt.reweight_case(700, 40)
    want = jw.num_cluster_members(codes, 0.8)
    t = torch.as_tensor(codes)
    k = _identity_count_threshold(40, 0.8)
    kernel = _neighbor_counts(t, k).numpy()
    library = bt.reweight_library_route(t, 21, k, 24).numpy()
    assert np.array_equal(kernel, want) and np.array_equal(library, want)
    assert want.max() > 1
    with pytest.raises(ValueError, match="multiple of 8"):
        bt.reweight_library_route(t, 21, k, 20)


def test_parity_lbfgs_case_planted_pairs():
    """At L=160 the planted columns are bench.py's; at other L they are
    scaled and stay distinct."""
    codes, w = bt.parity_lbfgs_case(400, 160, 21)
    assert codes.shape == (400, 160) and codes.dtype == np.int8
    for a, b, _ in bt._PARITY_PAIRS:
        assert set(np.unique(codes[:, a])) <= {0, 3}
        assert set(np.unique(codes[:, b])) <= {1, 5}
    assert w.min() >= 0.5 and w.max() < 1.0
    cols = [c * 40 // 160 for a, b, _ in bt._PARITY_PAIRS for c in (a, b)]
    assert len(set(cols)) == len(cols)


def test_pipeline_without_figures():
    """The pipeline record's job: compare draws no figure, the mutate
    stage's matrix is written after the job."""
    total, stages = bt._run_pipeline_once(200, 40, CPU)
    assert set(_STAGES) <= set(stages)
    assert stages["mutate"] > 0 and total >= sum(
        stages[s] for s in _STAGES) - 0.05
