"""The hermetic monomer chain through both packages on the same synthetic
focus alignment (tests/test_protocols.write_synthetic_a2m): align
`existing` -> couplings `standard` (skew-normal and logistic-regression
scoring) -> mutate `standard`, the port on the CPU, the JAX package on
its CPU backend.

Tolerances:
- exactly equal: outcfg keys, the focus `.a2m` and target `.fa`, the
  identities, frequencies, alignment-statistics and sequence-weight
  CSVs (as bytes), and the outcfg's non-path values;
- the golden gate (RTOL 1e-4, ATOL 1e-5,
  tests/test_golden_regression.py) with its exact rank-order check:
  `.model` parameters, CN/FN in `_CouplingScores.csv`, enrichment,
  the logistic-regression score and probability, and the frequency and
  conservation columns of `_single_mutant_matrix.csv`; its Delta-E
  columns, each a sum of L + 1 parameter differences, to RTOL and
  (L + 1) ATOL (the same model through both mutate calculations:
  rtol 1e-12);
- skew-normal probabilities: atol 1e-3 (the mixture EM amplifies the
  gate-sized CN differences);
- EVzoom JSON, which rounds to two decimals: equal up to one rounding
  step (0.01 + 1e-9).
"""

import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest

import search_fixtures as sf
from evcouplings_tpu.align import protocol as jax_align
from evcouplings_tpu.couplings import protocol as jax_couplings
from evcouplings_tpu.couplings.model import CouplingsModel as JaxModel
from evcouplings_tpu.mutate import protocol as jax_mutate
from evcouplings_torch.align import protocol as align
from evcouplings_torch.couplings import protocol as couplings
from evcouplings_torch.couplings.model import CouplingsModel
from evcouplings_torch.mutate import protocol as mutate
from evcouplings_torch.align.alignment import Alignment
from test_golden_regression import ATOL, RTOL, assert_exact_rank_order
from test_protocols import ALIGN_KWARGS, COUPLINGS_KWARGS, write_synthetic_a2m
from test_torch_align_search import assert_same_outputs

# 20 iterations: over 40 the fit amplifies the one-ulp differences
# between the port's and XLA's float32 arithmetic past the gate (PR 1,
# tests/test_torch_fitter.py::test_golden_fit_ulp_sensitivity)
FIT_KWARGS = {**COUPLINGS_KWARGS, "iterations": 20}
EVZOOM_TOL = 0.01 + 1e-9
SKEWNORMAL_ATOL = 1e-3

SIDES = {
    "torch": (align, couplings, mutate, {"device": "cpu"}),
    "jax": (jax_align, jax_couplings, jax_mutate, {}),
}


def _chain(root, side):
    """align existing -> couplings standard (skewnormal, then the
    logistic-regression rescoring of the same fit) -> mutate standard."""
    ap, cp, mt, extra = SIDES[side]
    d = root / side
    a2m = str(root / "input.a2m")
    align_out = ap.run(protocol="existing", prefix=str(d / "align" / "job"),
                       input_alignment=a2m, **ALIGN_KWARGS, **extra)
    stage_in = dict(alignment_file=align_out["alignment_file"],
                    focus_sequence=align_out["focus_sequence"],
                    segments=align_out["segments"],
                    frequencies_file=align_out["frequencies_file"],
                    **extra)
    sn_prefix = str(d / "couplings" / "job")
    sn = cp.run(protocol="standard", prefix=sn_prefix, **stage_in,
                **FIT_KWARGS)
    # the logistic-regression run reuses the fit (reuse_ecs) under its
    # own prefix: copy the fit's artifacts there
    lr_prefix = str(d / "couplings_lr" / "job")
    os.makedirs(os.path.dirname(lr_prefix))
    for suffix in (".couplings_standard_plmc.outcfg", "_ECs.txt",
                   ".model"):
        shutil.copy(sn_prefix + suffix, lr_prefix + suffix)
    lr = cp.run(protocol="standard", prefix=lr_prefix, **stage_in,
                **{**FIT_KWARGS, "reuse_ecs": True,
                   "scoring_model": "logistic_regression",
                   "min_sequence_distance": 6})
    mut = mt.run(protocol="standard", prefix=str(d / "mutate" / "job"),
                 model_file=sn["model_file"], mutation_dataset_file=None)
    return {"align": align_out, "skewnormal": sn,
            "logistic_regression": lr, "mutate": mut}


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_protocols")
    write_synthetic_a2m(str(root / "input.a2m"))
    return {side: _chain(root, side) for side in SIDES}


def _read(path, mode="r"):
    with open(path, mode) as f:
        return f.read()


def _is_path(key):
    return key.endswith(("_file", "_files"))


@pytest.mark.parametrize("stage", ["align", "skewnormal",
                                   "logistic_regression", "mutate"])
def test_outcfg_keys_and_values_match(chains, stage):
    got, want = chains["torch"][stage], chains["jax"][stage]
    assert set(got) == set(want)
    for key in got:
        if _is_path(key):
            continue
        if isinstance(want[key], float):
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       err_msg=key)
        else:
            assert got[key] == want[key], key
    for key in got:
        if key.endswith("_file") and got[key] is not None:
            assert os.path.basename(got[key]) == \
                os.path.basename(want[key]), key
            assert os.path.isfile(got[key]), key


@pytest.mark.parametrize("key", [
    "alignment_file", "target_sequence_file", "raw_focus_alignment_file",
    "identities_file", "frequencies_file", "statistics_file",
    "sequence_weights_file",
])
def test_align_artifacts_equal(chains, key):
    got = _read(chains["torch"]["align"][key])
    want = _read(chains["jax"]["align"][key])
    if key == "statistics_file":
        # the prefix column holds each side's own output path
        got = pd.read_csv(chains["torch"]["align"][key]).drop(
            columns="prefix")
        want = pd.read_csv(chains["jax"]["align"][key]).drop(
            columns="prefix")
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    else:
        assert got == want


def test_models_within_gate(chains):
    got = CouplingsModel(chains["torch"]["skewnormal"]["model_file"])
    want = JaxModel(chains["jax"]["skewnormal"]["model_file"])
    assert list(got.index_list) == list(want.index_list)
    assert "".join(got.target_seq) == "".join(want.target_seq)
    np.testing.assert_array_equal(got.weights, want.weights)
    for attr in ("J_ij", "h_i", "f_i", "f_ij"):
        np.testing.assert_allclose(getattr(got, attr), getattr(want, attr),
                                   rtol=RTOL, atol=ATOL, err_msg=attr)
    assert got.N_eff == pytest.approx(want.N_eff, rel=1e-6)


def _scores(chain, scoring, name="ec_file"):
    return pd.read_csv(chain[scoring][name]).sort_values(
        ["i", "j"]).reset_index(drop=True)


@pytest.mark.parametrize("scoring", ["skewnormal", "logistic_regression"])
def test_coupling_scores_within_gate(chains, scoring):
    got = _scores(chains["torch"], scoring)
    want = _scores(chains["jax"], scoring)
    assert list(got.columns) == list(want.columns)
    assert (got[["i", "j", "A_i", "A_j"]].values
            == want[["i", "j", "A_i", "A_j"]].values).all()
    for col in ("cn", "fn", "score"):
        np.testing.assert_allclose(got[col], want[col], rtol=RTOL,
                                   atol=ATOL, err_msg=col)
    if scoring == "skewnormal":
        np.testing.assert_allclose(got.probability, want.probability,
                                   rtol=0, atol=SKEWNORMAL_ATOL)
    else:
        np.testing.assert_allclose(got.probability, want.probability,
                                   rtol=RTOL, atol=ATOL)
    assert_exact_rank_order(got, want)
    got_lr = _scores(chains["torch"], scoring, "ec_longrange_file")
    want_lr = _scores(chains["jax"], scoring, "ec_longrange_file")
    assert (got_lr[["i", "j"]].values == want_lr[["i", "j"]].values).all()


def test_enrichment_within_gate(chains):
    got = pd.read_csv(chains["torch"]["skewnormal"]["enrichment_file"])
    want = pd.read_csv(chains["jax"]["skewnormal"]["enrichment_file"])
    got, want = (t.sort_values("i").reset_index(drop=True)
                 for t in (got, want))
    assert (got.i.values == want.i.values).all()
    np.testing.assert_allclose(got.enrichment, want.enrichment, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("key", ["ec_lines_pml_file", "enrichment_pml_files"])
def test_pymol_scripts_name_the_same_residues(chains, key):
    def residues(paths):
        paths = paths if isinstance(paths, list) else [paths]
        return [sorted(line.split(",")[1] for line in _read(p).splitlines()
                       if line.startswith(("dist", "show")))
                for p in paths]

    assert residues(chains["torch"]["skewnormal"][key]) == \
        residues(chains["jax"]["skewnormal"][key])


def test_evzoom_json_matches(chains):
    got = json.loads(_read(chains["torch"]["skewnormal"]["evzoom_file"]))
    want = json.loads(_read(chains["jax"]["skewnormal"]["evzoom_file"]))
    assert got["map"] == want["map"]
    for row_g, row_w in zip(got["logo"], want["logo"], strict=True):
        assert [c["code"] for c in row_g] == [c["code"] for c in row_w]
        np.testing.assert_allclose([c["bits"] for c in row_g],
                                   [c["bits"] for c in row_w], rtol=0,
                                   atol=EVZOOM_TOL)
    assert [(c["i"], c["j"], c["iC"], c["jC"]) for c in got["couplings"]] \
        == [(c["i"], c["j"], c["iC"], c["jC"]) for c in want["couplings"]]
    for c_g, c_w in zip(got["couplings"], want["couplings"]):
        np.testing.assert_allclose(c_g["matrix"], c_w["matrix"], rtol=0,
                                   atol=EVZOOM_TOL)
        assert abs(c_g["score"] - c_w["score"]) <= EVZOOM_TOL


def test_single_mutant_matrix_within_gate(chains):
    got = pd.read_csv(chains["torch"]["mutate"]["mutation_matrix_file"])
    want = pd.read_csv(chains["jax"]["mutate"]["mutation_matrix_file"])
    assert list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(got[["mutant", "pos", "wt", "subs"]],
                                  want[["mutant", "pos", "wt", "subs"]])
    for col in ("frequency", "column_conservation"):
        np.testing.assert_allclose(got[col], want[col], rtol=RTOL,
                                   atol=ATOL, err_msg=col)
    # a Delta-E sums L coupling and one field difference, each within
    # the gate: the gate's atol, propagated through the L + 1 terms
    n_terms = got.pos.nunique() + 1
    for col in ("prediction_epistatic", "prediction_independent"):
        np.testing.assert_allclose(got[col], want[col], rtol=RTOL,
                                   atol=n_terms * ATOL, err_msg=col)
    for key in ("mutation_matrix_plot_files",
                "mutations_epistatic_pml_files"):
        assert all(os.path.isfile(p)
                   for p in chains["torch"]["mutate"][key]), key


def test_mutate_on_one_model_matches_jax(chains):
    # the same .model through both packages' mutate calculations
    from evcouplings_tpu.mutate.calculations import (
        single_mutant_matrix as jax_single_mutant_matrix,
    )
    from evcouplings_torch.mutate.calculations import single_mutant_matrix

    path = chains["torch"]["skewnormal"]["model_file"]
    got = single_mutant_matrix(CouplingsModel(path))
    want = jax_single_mutant_matrix(JaxModel(path))
    pd.testing.assert_frame_equal(got, want, check_exact=False, rtol=1e-12,
                                  atol=0)


def _search_inputs(tmp):
    """The synthetic focus alignment as a fake jackhmmer's Stockholm
    result (query first, UniProt-style annotation on every 10th row), an
    input alignment for hmmbuild and its fake hmmsearch hits, and the
    full target sequence numbered from 11."""
    a2m = str(tmp / "input.a2m")
    write_synthetic_a2m(a2m)
    sto, hits = sf.as_jackhmmer_result(sf.read_rows(a2m),
                                       annotate_every=10)
    db = tmp / "uniref.fa"
    db.write_text(">x\nACD\n")
    jack = sf.write_outputs(str(tmp), "jack", sto, hits, "TARGET_SEQ", 18)
    target = Alignment.from_path(a2m)
    seq = "".join(target[0])
    (tmp / "target.fa").write_text(">TARGET_SEQ\n" + seq + "\n")
    hmm_rows = [(target.ids[k], "".join(target[k])) for k in range(1, 40)]
    hmm = sf.write_outputs(str(tmp), "hmm",
                           sf.stockholm(hmm_rows, rf="x" * len(seq)),
                           hits[:39], "TARGET_SEQ", 18)
    return {
        "seq_file": str(tmp / "target.fa"), "db": str(db), "a2m": a2m,
        "jackhmmer": sf.fake_search(tmp / "jackhmmer", {str(db): jack}),
        "hmmsearch": sf.fake_search(tmp / "hmmsearch", {str(db): hmm}),
        "hmmbuild": sf.fake_hmmbuild(tmp / "hmmbuild"),
    }


def _search_kwargs(inputs, name, root):
    common = dict(
        prefix=os.path.join(root, "search", "job"), sequence_id="TARGET_SEQ",
        first_index=11, use_bitscores=True, domain_threshold=0.5,
        sequence_threshold=0.5, database="uniref90", uniref90=inputs["db"],
        cpu=None, nobias=False, reuse_alignment=False)
    if name == "standard":
        return {**common, **ALIGN_KWARGS, **{
            "sequence_file": inputs["seq_file"], "region": None,
            "sequence_download_url": "http://invalid.example/{}",
            "iterations": 5, "checkpoints_hmm": False,
            "checkpoints_ali": False, "jackhmmer": inputs["jackhmmer"],
            "extract_annotation": True, "first_index": 11}}
    return dict(common, alignment_file=inputs["a2m"], first_index=None,
                hmmbuild=inputs["hmmbuild"], hmmsearch=inputs["hmmsearch"])


def _search_protocol(name):
    """align `name` through both packages on the fake binaries: the
    outcfgs equal apart from their roots, every file they name equal."""
    def run(tmp):
        inputs = _search_inputs(tmp)
        out = {}
        for tag, (module, _, _, extra) in SIDES.items():
            root = str(tmp / tag)
            out[tag] = (root, module.run(
                protocol=name, **_search_kwargs(inputs, name, root),
                **extra))
        (got_root, got), (want_root, want) = out["torch"], out["jax"]
        assert assert_same_outputs(got, want, got_root, want_root) >= 5
        assert got["focus_mode"] is True
        assert got["segments"][0][3:5] == [11, 28]
    return run


def _complex_inputs(tmp):
    """The TestComplexCouplingsEndToEnd monomers concatenated by the JAX
    package (best_hit), and a 5-iteration couplings `complex` fit of the
    concatenation by the JAX package."""
    import complex_fixtures as cf
    from evcouplings_tpu.complex import protocol as jax_concatenate
    from test_complex import MODIFY_KWARGS

    cf.write_monomers(str(tmp))
    seg = ["aa", "aa", "T", 1, cf.L, list(range(1, cf.L + 1))]
    concat = jax_concatenate.run(
        protocol="best_hit", prefix=str(tmp / "concat" / "cc"),
        first_alignment_file=str(tmp / "m1.fasta"),
        second_alignment_file=str(tmp / "m2.fasta"),
        first_focus_sequence="T1/1-10", second_focus_sequence="T2/1-10",
        first_focus_mode=True, second_focus_mode=True,
        first_region_start=1, second_region_start=1,
        first_segments=[seg], second_segments=[seg],
        first_identities_file=str(tmp / "id1.csv"),
        second_identities_file=str(tmp / "id2.csv"),
        first_annotation_file=str(tmp / "anno1.csv"),
        second_annotation_file=str(tmp / "anno2.csv"),
        use_best_reciprocal=False, paralog_identity_threshold=0.95,
        **MODIFY_KWARGS)
    stage_in = dict(alignment_file=concat["alignment_file"],
                    focus_sequence=concat["focus_sequence"],
                    segments=concat["segments"], frequencies_file=None,
                    **{**COUPLINGS_KWARGS, "iterations": 5,
                       "scoring_model": "skewnormal",
                       "use_all_ecs_for_scoring": False})
    return concat, stage_in


def _complex_protocol(stage):
    """couplings or mutate `complex` (ROADMAP A19c) through both packages
    on the same concatenation (mutate on the JAX fit's model): equal
    outcfg keys, inter-segment outputs in both."""
    def run(tmp):
        concat, stage_in = _complex_inputs(tmp)
        if stage == "mutate":
            model_file = jax_couplings.run(
                protocol="complex", prefix=str(tmp / "fit" / "job"),
                **stage_in)["model_file"]
        out = {}
        for tag, (_, cp, mt, extra) in SIDES.items():
            prefix = str(tmp / tag / stage / "job")
            if stage == "couplings":
                out[tag] = cp.run(protocol="complex", prefix=prefix,
                                  **stage_in, **extra)
            else:
                out[tag] = mt.run(protocol="complex", prefix=prefix,
                                  model_file=model_file,
                                  segments=concat["segments"],
                                  mutation_dataset_file=None)
        got, want = out["torch"], out["jax"]
        assert set(got) == set(want)
        if stage == "couplings":
            inter = pd.read_csv(got["inter_ec_file"])
            assert set(inter.segment_i) == {"A_1"}
            assert set(inter.segment_j) == {"B_1"}
        else:
            table = pd.read_csv(got["mutation_matrix_file"])
            assert "prediction_inter_segment" in table.columns
            assert set(table.segment) == {"A_1", "B_1"}
    return run


# the ids are the cases' ids from when the complex cases were lambdas
# that expected NotImplementedError
@pytest.mark.parametrize("run,item", [
    (_search_protocol("standard"), "A19"),
    (_search_protocol("hmmbuild_and_search"), "A19"),
    (_complex_protocol("couplings"), "A19"),
    (_complex_protocol("mutate"), "A19"),
], ids=["run-A19_0", "run-A19_1", "<lambda>-A19_0", "<lambda>-A19_1"])
def test_unported_protocols_name_their_item(tmp_path, run, item):
    """ROADMAP A19 (`item`) was split, and its protocols are ported: the
    search protocols (A19a) run on fake binaries equal to the JAX
    package's; couplings and mutate `complex` (A19c) run on a
    concatenated alignment in both packages (their numbers are held to
    the JAX package's in tests/test_torch_complex.py)."""
    run(tmp_path)


def test_external_identity_filter_raises(chains, tmp_path):
    """The identity filter was ported after this test was written (ROADMAP
    A19a): `existing` with seqid_filter runs hhfilter (a fake that drops
    every 7th row) in both packages, with equal artifacts."""
    a2m = os.path.join(os.path.dirname(os.path.dirname(
        chains["torch"]["align"]["alignment_file"])), "..", "input.a2m")
    ids = list(Alignment.from_path(a2m).ids)
    drop = [ids[k].split()[0] for k in range(7, len(ids), 7)]
    hhfilter = sf.fake_hhfilter(tmp_path / "hhfilter", drop)
    out = {}
    for tag, (module, _, _, extra) in SIDES.items():
        root = str(tmp_path / tag)
        out[tag] = (root, module.run(
            protocol="existing", prefix=os.path.join(root, "x"),
            input_alignment=a2m, **extra,
            **{**ALIGN_KWARGS, "seqid_filter": 0.9, "hhfilter": hhfilter}))
    (got_root, got), (want_root, want) = out["torch"], out["jax"]
    assert assert_same_outputs(got, want, got_root, want_root) >= 6
    assert got["num_sequences"] < chains["torch"]["align"]["num_sequences"]


@pytest.mark.parametrize("knobs,error,match", [
    ({"fit_devices": 2}, Exception, r"fit_devices must be in \[1, 1\]"),
    ({"model_shards": 2}, Exception, r"\(1\) must be divisible by "
     r"model_shards \(2\)"),
    ({"fit_devices": "many"}, Exception, "fit_devices"),
    ({"parametrization": "sideways"}, Exception, "parametrization"),
    ({"precision": "exact"}, Exception, "precision"),
])
def test_unported_fit_knobs_raise(chains, tmp_path, knobs, error, match):
    a = chains["torch"]["align"]
    with pytest.raises(error, match=match):
        couplings.run(protocol="standard", prefix=str(tmp_path / "c"),
                      alignment_file=a["alignment_file"],
                      focus_sequence=a["focus_sequence"],
                      segments=a["segments"],
                      frequencies_file=a["frequencies_file"],
                      device="cpu", **{**COUPLINGS_KWARGS, **knobs})
