"""The port's complex pipeline (evcouplings_torch/complex, and the complex
protocols of align, couplings, compare and mutate) against the JAX
package's, on the same inputs made from a seed with numpy
(tests/complex_fixtures.py, tests/test_complex.py), the port on the CPU.

Tolerances:
- exactly equal: every complex.similarity, complex.distance and
  complex.alignment result (frames, headers, matrices); the concatenated
  alignments, the alignment CSVs and _concatenation_statistics.csv of
  both concatenation protocols (bytes, each run's root replaced); the
  outcfg keys and non-path values; figures (.pdf) only have to exist;
- the couplings `complex` fit (12 iterations): the golden gate (RTOL
  1e-4, ATOL 1e-5, tests/test_golden_regression.py) on the `.model`
  parameters and the CN/FN scores, with the gate's exact rank-order
  check on the inter-protein ECs; skew-normal probabilities within atol
  1e-3 (the mixture EM amplifies gate-sized CN differences; each subset,
  intra and inter, is fit on its own);
- compare `complex`: CSVs equal except distances, which are float64 on
  both sides and held to 1e-9 A (compare_fixtures.DIST_ATOL), a port
  distance of 0 to 1e-4 A in the JAX GEMM form; PDB files and Pymol
  scripts byte for byte;
- mutate `complex`: the mutant lists equal, the three prediction
  columns (each Delta-E a sum of L + 1 parameter differences) within
  RTOL and (L + 1) ATOL; the same `.model` through both packages within
  rtol 1e-12;
- the protein_complex job through both packages' execute_wrapped (align_1
  through fold `complex_dock`): alignment-stage and concatenation
  artifacts byte-equal, the model within the gate, the JAX compare,
  mutate and fold stages on a copy of the port job's tree equal to the
  port's (compare as above, docking restraint files byte for byte).
"""

import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

import compare_fixtures as ss
import complex_fixtures as cf
from evcouplings_tpu.compare import bcif as jax_bcif
from evcouplings_tpu.compare import protocol as jax_compare
from evcouplings_tpu.complex import alignment as jax_alignment
from evcouplings_tpu.complex import distance as jax_distance
from evcouplings_tpu.complex import protocol as jax_concatenate
from evcouplings_tpu.complex import similarity as jax_similarity
from evcouplings_tpu.couplings import protocol as jax_couplings
from evcouplings_tpu.couplings.model import CouplingsModel as JaxModel
from evcouplings_tpu.mutate import protocol as jax_mutate
from evcouplings_tpu.utils import pipeline as jax_pipeline
from evcouplings_tpu.utils.config import (
    InvalidParameterError as JaxInvalidParameterError,
)
from evcouplings_torch.compare import bcif
from evcouplings_torch.compare import protocol as compare
from evcouplings_torch.complex import alignment, distance, similarity
from evcouplings_torch.complex import protocol as concatenate
from evcouplings_torch.couplings import protocol as couplings
from evcouplings_torch.couplings.model import CouplingsModel
from evcouplings_torch.mutate import protocol as mutate
from evcouplings_torch.utils import pipeline
from evcouplings_torch.utils.config import (
    InvalidParameterError,
    read_config_file,
)
from evcouplings_torch.utils.system import insert_dir
from test_compare_protocol import write_complex_bcif
from test_complex import MODIFY_KWARGS, write_monomer
from test_golden_regression import ATOL, RTOL, assert_exact_rank_order

SKEWNORMAL_ATOL = 1e-3
ZERO_ATOL = 1e-4
ITERATIONS = 12


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread (the test runners share the
    host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fixture_writes_the_jax_tests_generator(tmp_path):
    """complex_fixtures.write_monomers is TestComplexCouplingsEndToEnd's
    generator, file for file."""
    from test_complex import TestComplexCouplingsEndToEnd

    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    cf.write_monomers(str(tmp_path / "a"))
    TestComplexCouplingsEndToEnd()._make_monomers(tmp_path / "b")
    names = sorted(os.listdir(tmp_path / "a"))
    assert names == sorted(os.listdir(tmp_path / "b"))
    assert len(names) == 6
    for name in names:
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes(), name


# --- complex.similarity --------------------------------------------------

def _annotation_cases(tmp_path):
    """Annotation tables: OS only, Tax only, both (OS better populated,
    Tax better populated, tied), and neither."""
    rng = np.random.default_rng(21)
    ids = ["s{}/1-10".format(k) for k in range(12)]
    species = rng.choice(["Sp1", "Sp2", "Sp3", None], size=12)
    cases = {}
    for name, columns in (
            ("os", {"OS": species}),
            ("tax", {"Tax": species}),
            ("os_better", {"OS": species, "Tax": np.where(
                rng.random(12) < 0.5, None, "T")}),
            ("tax_better", {"OS": np.where(rng.random(12) < 0.8, None, "O"),
                            "Tax": species}),
            ("tied", {"OS": species, "Tax": species[::-1]}),
            ("neither", {"GN": species})):
        path = tmp_path / (name + ".csv")
        pd.DataFrame({"id": ids, "name": ids, **columns}).to_csv(
            path, index=False)
        cases[name] = str(path)
    return cases


def test_read_species_annotation_table_matches_jax(tmp_path):
    for name, path in _annotation_cases(tmp_path).items():
        if name == "neither":
            with pytest.raises(InvalidParameterError):
                similarity.read_species_annotation_table(path)
            with pytest.raises(JaxInvalidParameterError):
                jax_similarity.read_species_annotation_table(path)
            continue
        pd.testing.assert_frame_equal(
            similarity.read_species_annotation_table(path),
            jax_similarity.read_species_annotation_table(path))


def _species_tables(seed, n=60, n_species=9):
    """Identity and species tables with ties: identities on a coarse grid
    (equal values within a species), some ids without a species."""
    rng = np.random.default_rng(seed)
    ids = ["T/1-20"] + ["s{}/1-20".format(k) for k in range(n)]
    identities = np.round(rng.integers(0, 8, size=n + 1) / 8, 3)
    identities[0] = 1.0
    species = rng.choice(["Sp{}".format(k) for k in range(n_species)]
                         + [None], size=n + 1)
    species[0] = "Query"
    species[rng.integers(1, n, size=4)] = "Query"
    similarities = pd.DataFrame({"id": ids, "identity_to_query": identities})
    annotation = pd.DataFrame({"id": ids, "name": ids, "species": species})
    return similarities, annotation


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_most_similar_and_paralogs_match_jax(seed):
    """Per-species best hits (ties within a species broken the same way)
    and the target's paralogs, exactly as the JAX package finds them."""
    similarities, annotation = _species_tables(seed)
    pd.testing.assert_frame_equal(
        similarity.most_similar_by_organism(similarities, annotation),
        jax_similarity.most_similar_by_organism(similarities, annotation))
    for threshold in (0.3, 0.95):
        pd.testing.assert_frame_equal(
            similarity.find_paralogs("T/1-20", annotation, similarities,
                                     threshold),
            jax_similarity.find_paralogs("T/1-20", annotation,
                                         similarities, threshold))


@pytest.mark.parametrize("seed", [0, 1])
def test_filter_best_reciprocal_matches_jax(tmp_path, seed):
    """Best reciprocal hits against the paralogs of a seeded alignment
    whose rows are noisy copies of the target and of two paralogs."""
    rng = np.random.default_rng(seed)
    L = 20
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    centres = rng.choice(aa, size=(3, L))
    ids = ["T/1-20"] + ["s{}/1-20".format(k) for k in range(40)]
    rows = [centres[0]]
    for k in range(40):
        row = centres[k % 3].copy()
        flip = rng.random(L) < 0.3
        row[flip] = rng.choice(aa, size=int(flip.sum()))
        rows.append(row)
    path = tmp_path / "ali.fasta"
    path.write_text("".join(">{}\n{}\n".format(i, "".join(r))
                            for i, r in zip(ids, rows)))
    identity = [float((r == rows[0]).mean()) for r in rows]
    similarities = pd.DataFrame({"id": ids, "identity_to_query": identity})
    # one species per row: the best hits of the paralogs' families are
    # closer to a paralog than to the query, and are dropped
    species = ["Query"] + ["Query" if k in (1, 2) else
                           "Sp{}".format(k) for k in range(40)]
    annotation = pd.DataFrame({"id": ids, "name": ids, "species": species})
    paralogs = similarity.find_paralogs("T/1-20", annotation, similarities,
                                        0.95)
    assert len(paralogs) == 2
    best = similarity.most_similar_by_organism(similarities, annotation)
    got = similarity.filter_best_reciprocal(str(path), paralogs, best,
                                            device="cpu")
    want = jax_similarity.filter_best_reciprocal(str(path), paralogs, best)
    pd.testing.assert_frame_equal(got, want)
    assert 0 < len(got) < len(best)


# --- complex.distance ----------------------------------------------------

def _location_tables(seed, n=40, genomes=8):
    """Two CDS location tables on shared genomes, with equal distances
    (ties), overlaps, reversed strands, duplicate rows and missing
    values."""
    rng = np.random.default_rng(seed)

    def table(tag):
        start = rng.integers(0, 40, size=n) * 100
        length = rng.integers(1, 4, size=n) * 100
        flip = rng.random(n) < 0.3
        frame = pd.DataFrame({
            "cds": ["{}{}".format(tag, k) for k in range(n)],
            "genome_id": rng.choice(["g{}".format(k)
                                     for k in range(genomes)], size=n),
            "uniprot_ac": ["{}{}".format(tag.upper(), k) for k in range(n)],
            "gene_start": np.where(flip, start + length, start),
            "gene_end": np.where(flip, start, start + length),
            "full_id": ["{}{}/1-50".format(tag, k) for k in range(n)],
        })
        frame.loc[int(rng.integers(0, n)), "gene_end"] = np.nan
        return pd.concat([frame, frame.iloc[:2]], ignore_index=True)

    return table("x"), table("y")


def test_get_distance_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(200):
        a, b = rng.integers(0, 1000, size=(2, 2))
        assert distance.get_distance(a, b) == \
            jax_distance.get_distance(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partners_and_best_reciprocal_matching_match_jax(seed):
    t1, t2 = _location_tables(seed)
    got = distance.find_possible_partners(t1.copy(), t2.copy())
    want = jax_distance.find_possible_partners(t1.copy(), t2.copy())
    pd.testing.assert_frame_equal(got, want)
    pairing = distance.best_reciprocal_matching(got)
    pd.testing.assert_frame_equal(
        pairing, jax_distance.best_reciprocal_matching(want))
    assert len(pairing) > 0
    empty = distance.find_possible_partners(t1.iloc[:0], t2.iloc[:0])
    assert list(empty.columns) == ["uniprot_id_1", "uniprot_id_2",
                                   "distance"]
    assert len(distance.best_reciprocal_matching(empty)) == 0


def test_plot_distance_distribution(tmp_path):
    pairing = pd.DataFrame({"distance": [10, 300, 5000, 20000]})
    for module, name in ((distance, "torch.pdf"), (jax_distance, "jax.pdf")):
        module.plot_distance_distribution(pairing, str(tmp_path / name))
        assert os.path.getsize(tmp_path / name) > 0
        with pytest.raises(ValueError, match="No valid distances"):
            module.plot_distance_distribution(pairing.iloc[:0], "x.pdf")


# --- complex.alignment ---------------------------------------------------

def test_write_concatenated_alignment_matches_jax(tmp_path):
    """Seeded monomers with lowercase columns and "." inserts, paired in
    a shuffled order with repeats."""
    rng = np.random.default_rng(9)
    sym = np.array(list("ACDEFGHIKLMNPQRSTVWY-acdefg."))
    paths, ids = [], []
    for tag, length in (("a", 12), ("b", 9)):
        names = ["{}T/1-{}".format(tag, length)] + [
            "{}{}/3-{}".format(tag, k, length + 2) for k in range(25)]
        rows = ["".join(rng.choice(sym[:20], size=length))] + [
            "".join(rng.choice(sym, size=length)) for _ in range(25)]
        path = tmp_path / (tag + ".a2m")
        path.write_text("".join(">{}\n{}\n".format(n, r)
                                for n, r in zip(names, rows)))
        paths.append(str(path))
        ids.append(names)
    pick = rng.integers(1, 26, size=(30, 2))
    pairing = pd.DataFrame({"id_1": [ids[0][k] for k in pick[:, 0]],
                            "id_2": [ids[1][k] for k in pick[:, 1]]})
    got = alignment.write_concatenated_alignment(
        pairing, *paths, ids[0][0], ids[1][0], device="cpu")
    want = jax_alignment.write_concatenated_alignment(
        pairing, *paths, ids[0][0], ids[1][0])
    assert got[:2] == want[:2] == ("aT_bT/1-21", 0)
    for g, w in zip(got[2:], want[2:]):
        assert list(g.ids) == list(w.ids)
        assert (g.matrix == w.matrix).all()
        assert g.device == "cpu"


# --- complex.protocol ----------------------------------------------------

def _jax_test_inputs(tmp_path, case):
    """The inputs of tests/test_complex.py's TestBestHitProtocol and
    TestGenomeDistanceProtocol, as protocol settings."""
    if case == "jax_best_hit":
        ids_1 = ["a{}/1-8".format(i) for i in range(4)]
        ids_2 = ["b{}/1-8".format(i) for i in range(4)]
        write_monomer(str(tmp_path / "a1.fasta"), ids_1, seed=3,
                      target="T1/1-8")
        write_monomer(str(tmp_path / "a2.fasta"), ids_2, seed=4,
                      target="T2/1-8")
        for tag, target, ids in (("1", "T1/1-8", ids_1),
                                 ("2", "T2/1-8", ids_2)):
            pd.DataFrame({"id": [target] + ids, "name": [target] + ids,
                          "OS": ["Query", "SpA", "SpB", "SpC", "SpD"]}
                         ).to_csv(tmp_path / ("anno" + tag + ".csv"),
                                  index=False)
            pd.DataFrame({"id": [target] + ids,
                          "identity_to_query": [1.0, 0.9, 0.8, 0.7, 0.6]}
                         ).to_csv(tmp_path / ("id" + tag + ".csv"),
                                  index=False)
        return dict(protocol="best_hit", use_best_reciprocal=False,
                    paralog_identity_threshold=0.95, L=8)
    (tmp_path / "a1.fasta").write_text(
        ">T1/1-6\nMKTAYI\n>A1\nMKSAYL\n>A2\nMRTAYI\n>A3\nMKTAYV\n")
    (tmp_path / "a2.fasta").write_text(
        ">T2/1-6\nWFQHRE\n>B1\nWFQHKE\n>B2\nWYQHRE\n>B3\nWFEHRD\n")
    for tag, full_ids, genomes, starts, ends in (
            ("1", ["A1", "A2", "A3"], ["g1", "g1", "g2"],
             [100, 5000, 100], [400, 5300, 500]),
            ("2", ["B1", "B2", "B3"], ["g1", "g1", "g3"],
             [600, 5400, 100], [900, 5600, 200])):
        pd.DataFrame({"cds": ["c" + tag + x for x in "123"],
                      "genome_id": genomes,
                      "uniprot_ac": ["P" + tag + x for x in "123"],
                      "gene_start": starts, "gene_end": ends,
                      "full_id": full_ids}).to_csv(
            tmp_path / ("loc" + tag + ".csv"), index=False)
        pd.DataFrame({"id": ["T{}/1-6".format(tag)] + full_ids,
                      "name": ["T{}/1-6".format(tag)] + full_ids,
                      "OS": ["spX"] * 4}).to_csv(
            tmp_path / ("anno" + tag + ".csv"), index=False)
    return dict(protocol="genome_distance", genome_distance_threshold=1000,
                first_genome_location_file=str(tmp_path / "loc1.csv"),
                second_genome_location_file=str(tmp_path / "loc2.csv"),
                L=6)


def _seeded_inputs(tmp_path, case):
    """The TestComplexCouplingsEndToEnd monomers with seeded location
    tables (write_genome_tables' pairings, as the align stage would
    annotate them) and, for the best-reciprocal case, annotation tables
    in which every 17th row shares the targets' species (paralogs)."""
    cf.write_monomers(str(tmp_path))
    if case == "genome_distance":
        kinds = cf.write_genome_tables(
            str(tmp_path / "embl.txt"), str(tmp_path / "ena.tsv"),
            ["a{}".format(k) for k in range(cf.N)],
            ["b{}".format(k) for k in range(cf.N)])
        # the align stage's genome_location tables, written here from the
        # ENA rows directly (full_id = the alignment header)
        ena = pd.read_csv(tmp_path / "ena.tsv", sep="\t", header=None,
                          names=["cds", "genome_id", "uniprot_ac",
                                 "gene_start", "gene_end"])
        ambiguous = {"a{}".format(k) for k in kinds["ambiguous"]}
        ena = ena[~ena.uniprot_ac.isin(ambiguous)]
        for tag, letter in (("1", "a"), ("2", "b")):
            part = ena[ena.uniprot_ac.str.startswith(letter)]
            part.assign(full_id=part.uniprot_ac + "/1-{}".format(cf.L)
                        ).to_csv(tmp_path / ("loc" + tag + ".csv"))
        return dict(protocol="genome_distance",
                    genome_distance_threshold=10000,
                    first_genome_location_file=str(tmp_path / "loc1.csv"),
                    second_genome_location_file=str(tmp_path / "loc2.csv"),
                    L=cf.L)
    reciprocal = case == "best_hit_reciprocal"
    if reciprocal:
        for tag in ("1", "2"):
            anno = pd.read_csv(tmp_path / ("anno" + tag + ".csv"))
            anno.loc[1::17, "OS"] = "Query"
            anno.to_csv(tmp_path / ("anno" + tag + ".csv"), index=False)
    return dict(protocol="best_hit", use_best_reciprocal=reciprocal,
                paralog_identity_threshold=0.95, L=cf.L)


PROTOCOL_CASES = ["jax_best_hit", "jax_genome_distance", "best_hit",
                  "best_hit_reciprocal", "genome_distance"]


@pytest.mark.parametrize("case", PROTOCOL_CASES)
def test_concatenation_protocols_match_jax(tmp_path, case):
    """Both concatenation protocols through both packages: the outcfg,
    the raw, monomer and filtered concatenated alignments, the alignment
    CSVs and the statistics CSV equal byte for byte."""
    inputs = tmp_path / "in"
    inputs.mkdir()
    settings = (_jax_test_inputs if case.startswith("jax_")
                else _seeded_inputs)(inputs, case)
    L = settings.pop("L")
    seg = ["aa", "aa", "T", 1, L, list(range(1, L + 1))]
    kwargs = dict(
        first_alignment_file=str(inputs / "a1.fasta"),
        second_alignment_file=str(inputs / "a2.fasta"),
        first_focus_sequence="T1/1-{}".format(L),
        second_focus_sequence="T2/1-{}".format(L),
        first_focus_mode=True, second_focus_mode=True,
        first_region_start=1, second_region_start=1,
        first_segments=[seg], second_segments=[seg],
        first_annotation_file=str(inputs / "anno1.csv"),
        second_annotation_file=str(inputs / "anno2.csv"),
        **settings, **MODIFY_KWARGS)
    if not case.startswith("jax_"):
        kwargs.update(first_alignment_file=str(inputs / "m1.fasta"),
                      second_alignment_file=str(inputs / "m2.fasta"))
    if settings["protocol"] == "best_hit":
        kwargs.update(first_identities_file=str(inputs / "id1.csv"),
                      second_identities_file=str(inputs / "id2.csv"))
    kwargs["compute_num_effective_seqs"] = True
    out = {}
    for tag, module, extra in (("torch", concatenate, {"device": "cpu"}),
                               ("jax", jax_concatenate, {})):
        root = str(tmp_path / tag)
        out[tag] = (root, module.run(prefix=os.path.join(root, "cc"),
                                     **kwargs, **extra))
    (got_root, got), (want_root, want) = out["torch"], out["jax"]
    assert cf.assert_same_outputs(got, want, got_root, want_root) >= 9
    assert [s[0] for s in got["segments"]] == ["A_1", "B_1"]
    assert got["focus_sequence"] == "T1_T2/1-{}".format(2 * L)
    stats = pd.read_csv(got["concatentation_statistics_file"])
    assert stats.num_seqs_1.iloc[0] > 0
    if case == "best_hit":
        assert got["num_sequences"] == cf.N + 2
    if case == "best_hit_reciprocal":
        assert got["num_sequences"] < cf.N + 2 - 18


def test_unknown_concatenation_protocol_raises():
    with pytest.raises(InvalidParameterError, match="Valid protocols"):
        concatenate.run(protocol="by_operon")


# --- couplings complex, compare complex, mutate complex -------------------

COUPLINGS_COMPLEX = dict(
    focus_mode=True, theta=0.8, alphabet=None, ignore_gaps=False,
    iterations=ITERATIONS, lambda_h=0.01, lambda_J=0.01, lambda_group=None,
    lambda_J_times_Lq=True, scale_clusters=None, cpu=None, reuse_ecs=False,
    min_sequence_distance=3, scoring_model="skewnormal",
    use_all_ecs_for_scoring=False)


@pytest.fixture(scope="module")
def complex_fits(tmp_path_factory):
    """The TestComplexCouplingsEndToEnd slice: best_hit concatenation
    (JAX), then couplings `complex` through both packages on it."""
    root = tmp_path_factory.mktemp("complex_fits")
    cf.write_monomers(str(root))
    seg = ["aa", "aa", "T", 1, cf.L, list(range(1, cf.L + 1))]
    concat = jax_concatenate.run(
        protocol="best_hit", prefix=str(root / "concat" / "cc"),
        first_alignment_file=str(root / "m1.fasta"),
        second_alignment_file=str(root / "m2.fasta"),
        first_focus_sequence="T1/1-10", second_focus_sequence="T2/1-10",
        first_focus_mode=True, second_focus_mode=True,
        first_region_start=1, second_region_start=1,
        first_segments=[seg], second_segments=[seg],
        first_identities_file=str(root / "id1.csv"),
        second_identities_file=str(root / "id2.csv"),
        first_annotation_file=str(root / "anno1.csv"),
        second_annotation_file=str(root / "anno2.csv"),
        use_best_reciprocal=False, paralog_identity_threshold=0.95,
        **MODIFY_KWARGS)
    fits = {}
    for tag, module, extra in (("torch", couplings, {"device": "cpu"}),
                               ("jax", jax_couplings, {})):
        fits[tag] = module.run(
            protocol="complex", prefix=str(root / tag / "cplx"),
            alignment_file=concat["alignment_file"],
            focus_sequence=concat["focus_sequence"],
            segments=concat["segments"], **COUPLINGS_COMPLEX, **extra)
    return root, fits


def test_complex_couplings_outcfg_matches_jax(complex_fits):
    _, fits = complex_fits
    got, want = fits["torch"], fits["jax"]
    assert set(got) == set(want)
    for key, value in want.items():
        if key.endswith(("_file", "_files")):
            assert os.path.basename(got[key]) == os.path.basename(value)
        elif isinstance(value, float):
            assert got[key] == pytest.approx(value, rel=RTOL), key
        else:
            assert got[key] == value, key
    assert got["inter_ec_file"].endswith("_CouplingScores_inter.csv")


def test_complex_model_within_gate(complex_fits):
    _, fits = complex_fits
    got = CouplingsModel(fits["torch"]["model_file"])
    want = JaxModel(fits["jax"]["model_file"])
    assert list(got.index_list) == list(want.index_list)
    np.testing.assert_array_equal(got.weights, want.weights)
    for attr in ("J_ij", "h_i", "f_i", "f_ij"):
        np.testing.assert_allclose(getattr(got, attr), getattr(want, attr),
                                   rtol=RTOL, atol=ATOL, err_msg=attr)


def test_complex_ec_tables_within_gate(complex_fits):
    """Every EC file: the same pairs and segments, CN/FN in the gate,
    probabilities within atol 1e-3; the inter ECs in the same order
    (exact rank order on CN), and the two strong planted inter pairs
    first in both packages (the weak one, concordance 0.68, reaches the
    top L only at the 50 iterations of tests/test_complex.py)."""
    _, fits = complex_fits
    for key in ("ec_file", "ec_longrange_file", "inter_ec_file"):
        got, want = (pd.read_csv(f[key]).sort_values(["i", "j",
                                                      "segment_i"])
                     .reset_index(drop=True)
                     for f in (fits["torch"], fits["jax"]))
        assert list(got.columns) == list(want.columns)
        cols = ["i", "j", "A_i", "A_j", "segment_i", "segment_j"]
        assert (got[cols].values == want[cols].values).all(), key
        for col in ("cn", "fn"):
            np.testing.assert_allclose(got[col], want[col], rtol=RTOL,
                                       atol=ATOL, err_msg=col)
        np.testing.assert_allclose(got.probability, want.probability,
                                   rtol=0, atol=SKEWNORMAL_ATOL)
    expected = [(ci + 1, cj + 1) for ci, cj, _ in cf.INTER_PLANTED]
    inter = {tag: pd.read_csv(f["inter_ec_file"])
             for tag, f in fits.items()}
    assert_exact_rank_order(inter["torch"], inter["jax"])
    for table in inter.values():
        ranked = list(zip(table.i, table.j))
        assert ranked[:2] == expected[:2]
        assert len(table) == cf.L * cf.L


def test_complex_probability_matches_jax(complex_fits):
    """complex_probability on one EC table: each subset's mixture fit, and
    use_all_ecs, through both packages (within rtol 1e-9: the same
    scores through the same EM in float64)."""
    _, fits = complex_fits
    ecs = pd.read_csv(fits["jax"]["ec_file"]).drop(columns="probability")
    for use_all in (False, True):
        got = couplings.complex_probability(ecs, "skewnormal", use_all)
        want = jax_couplings.complex_probability(ecs, "skewnormal", use_all)
        assert (got.index == want.index).all()
        np.testing.assert_allclose(got.probability, want.probability,
                                   rtol=1e-9, atol=1e-12)
    assert couplings.SCORING_MODELS == jax_couplings.SCORING_MODELS


class _Fitted(Exception):
    pass


@pytest.mark.parametrize("given,expected", [({}, True),
                                            ({"focus_mode": False}, False)])
def test_complex_couplings_focus_mode_defaults_to_true(
        monkeypatch, given, expected):
    """couplings `complex` fits in focus mode where the config leaves
    focus_mode out (the concatenation's outcfg has no such key), and keeps
    a setting the config gives."""
    seen = {}

    def fit(**kwargs):
        seen.update(kwargs)
        raise _Fitted

    monkeypatch.setattr(couplings, "infer_plmc", fit)
    kwargs = {k: v for k, v in COUPLINGS_COMPLEX.items()
              if k != "focus_mode"}
    with pytest.raises(_Fitted):
        couplings.run(protocol="complex", prefix="unused", **kwargs,
                      **given)
    assert seen["focus_mode"] is expected


def test_complex_mutate_matches_jax(complex_fits, tmp_path):
    """mutate `complex` through both packages on their own models, with a
    mutation dataset that has a segment column."""
    root, fits = complex_fits
    data_file = str(tmp_path / "data.csv")
    pd.DataFrame({"mutant": ["A4W", "R8D", "C7Y", "A4W,K3E"],
                  "segment": ["A_1", "A_1", "B_1", "A_1,B_1"]}).to_csv(
        data_file, index=False)
    segments = fits["jax"]["segments"]
    out = {}
    for tag, module, model_file in (
            ("torch", mutate, fits["torch"]["model_file"]),
            ("jax", jax_mutate, fits["jax"]["model_file"])):
        out[tag] = module.run(protocol="complex",
                              prefix=str(tmp_path / tag / "mut"),
                              model_file=model_file, segments=segments,
                              mutation_dataset_file=data_file)
    assert set(out["torch"]) == set(out["jax"])
    got, want = (pd.read_csv(o["mutation_matrix_file"])
                 for o in (out["torch"], out["jax"]))
    assert list(got.columns) == list(want.columns)
    assert (got.mutant.values == want.mutant.values).all()
    assert (got.segment.values == want.segment.values).all()
    n_terms = 2 * cf.L + 1
    for col in ("prediction_epistatic", "prediction_independent",
                "prediction_inter_segment"):
        np.testing.assert_allclose(got[col], want[col], rtol=RTOL,
                                   atol=n_terms * ATOL, err_msg=col)
    for key in ("mutation_matrix_plot_files", "mutations_epistatic_pml_files"):
        assert len(out["torch"][key]) == len(out["jax"][key]) == 3
    got, want = (pd.read_csv(o["mutation_dataset_predicted_file"])
                 for o in (out["torch"], out["jax"]))
    assert list(got.columns) == list(want.columns)
    assert "inter_segment" in got.columns
    for col in ("prediction_epistatic", "prediction_independent",
                "inter_segment"):
        np.testing.assert_allclose(got[col], want[col], rtol=RTOL,
                                   atol=n_terms * ATOL, err_msg=col)


def test_complex_mutate_on_one_model_matches_jax(complex_fits, tmp_path):
    """The same .model through both packages' complex mutate: the matrix
    within rtol 1e-12, the Pymol scripts byte for byte."""
    _, fits = complex_fits
    out = {}
    for tag, module in (("torch", mutate), ("jax", jax_mutate)):
        out[tag] = module.run(protocol="complex",
                              prefix=str(tmp_path / tag / "mut"),
                              model_file=fits["torch"]["model_file"],
                              segments=fits["torch"]["segments"],
                              mutation_dataset_file=None)
    got, want = (pd.read_csv(o["mutation_matrix_file"])
                 for o in (out["torch"], out["jax"]))
    pd.testing.assert_frame_equal(got, want, check_exact=False, rtol=1e-12,
                                  atol=0)
    for a, b in zip(out["torch"]["mutations_epistatic_pml_files"],
                    out["jax"]["mutations_epistatic_pml_files"]):
        with open(a) as x, open(b) as y:
            assert x.read() == y.read()
    with pytest.raises(ValueError, match="segment"):
        mutate.run(protocol="complex", prefix=str(tmp_path / "bad" / "m"),
                   model_file=fits["torch"]["model_file"],
                   segments=fits["torch"]["segments"],
                   mutation_dataset_file=_no_segment_dataset(tmp_path))


def _no_segment_dataset(tmp_path):
    path = tmp_path / "no_segment.csv"
    pd.DataFrame({"mutant": ["A4W"]}).to_csv(path, index=False)
    return str(path)


def _compare_complex_kwargs(prefix, ec_file, structure_dir, sifts_table,
                            seq_files, ids, multimer, **overrides):
    """compare `complex` with tests/test_compare_protocol.py
    TestCompareComplex's settings."""
    n = overrides.pop("n_res", cf.L)
    segments = [["A_1", "aa", ids[0], 1, n, list(range(1, n + 1))],
                ["B_1", "aa", ids[1], 1, n, list(range(1, n + 1))]]
    kwargs = dict(
        protocol="complex", prefix=prefix, ec_file=ec_file,
        min_sequence_distance=2, pdb_mmtf_dir=structure_dir,
        atom_filter=None, first_compare_multimer=multimer,
        second_compare_multimer=multimer, distance_cutoff=5,
        segments=segments, first_sequence_id=ids[0],
        second_sequence_id=ids[1], first_sequence_file=None,
        second_sequence_file=None, first_target_sequence_file=seq_files[0],
        second_target_sequence_file=seq_files[1],
        first_alignment_file=None, second_alignment_file=None,
        raise_missing=False, first_raw_focus_alignment_file=None,
        second_raw_focus_alignment_file=None, scale_sizes=True,
        plot_probability_cutoffs=[0.9], boundaries="union",
        plot_lowest_count=2, plot_highest_count=3, plot_increase=1,
        draw_secondary_structure=False, pdb_ids=None, max_num_hits=25,
        max_num_structures=10, sifts_mapping_table=sifts_table,
        sifts_sequence_db=None, by_alignment=False,
        pdb_alignment_method="jackhmmer", alignment_min_overlap=20,
        region=None, use_bitscores=True, domain_threshold=0.5,
        sequence_threshold=0.5)
    kwargs.update(overrides)
    return kwargs


def _run_compare_both(tmp_path, kwargs_for):
    out = {}
    for tag, module, extra in (("torch", compare, {"device": "cpu"}),
                               ("jax", jax_compare, {})):
        root = str(tmp_path / tag)
        out[tag] = (root, module.run(**kwargs_for(root), **extra))
    (got_root, got), (want_root, want) = out["torch"], out["jax"]
    compared, _ = ss.assert_same_compare_artifacts(
        got, want, got_root, want_root, zero_atol=ZERO_ATOL)
    return got, compared


def test_compare_complex_fixture_matches_jax(tmp_path):
    """TestCompareComplex's structure (two CA-only chains, one planted
    inter contact) and EC table through both packages."""
    n = 10
    structure_dir = tmp_path / "structures"
    structure_dir.mkdir()
    write_complex_bcif(str(structure_dir / "2xyz.bcif"), n_res=n)
    sifts_table = tmp_path / "sifts.csv"
    pd.DataFrame([ss.sifts_row("2xyz", ch, ac, (1, n), (1, n))
                  for ch, ac in (("A", "PROT1"), ("B", "PROT2"))]
                 ).to_csv(sifts_table, index=False)
    pd.DataFrame({
        "i": [4, 2, 2], "A_i": ["A"] * 3,
        "segment_i": ["A_1", "A_1", "A_1"], "j": [7, 9, 5],
        "A_j": ["A"] * 3, "segment_j": ["B_1", "B_1", "A_1"],
        "fn": [1.5, 0.5, 0.8], "cn": [1.2, 0.4, 0.6],
        "probability": [0.99, 0.5, 0.8], "score": [1.2, 0.4, 0.6],
    }).to_csv(tmp_path / "ECs.csv", index=False)
    seq_files = []
    for k in (1, 2):
        path = tmp_path / "p{}.fa".format(k)
        path.write_text(">PROT{}/1-{}\n{}\n".format(k, n, "A" * n))
        seq_files.append(str(path))
    got, compared = _run_compare_both(tmp_path, lambda root: (
        _compare_complex_kwargs(
            os.path.join(root, "out", "cpx"), str(tmp_path / "ECs.csv"),
            str(structure_dir), str(sifts_table), seq_files,
            ("PROT1", "PROT2"), False, n_res=n)))
    assert compared >= 12
    inter = pd.read_csv(got["ec_compared_inter_file"])
    top = inter.sort_values("cn", ascending=False).iloc[0]
    assert (top.i, top.j) == (4, 7) and top.dist == pytest.approx(3.5)


@pytest.fixture(scope="module")
def seeded_structures(tmp_path_factory):
    """complex_structure_set's structures for the fixture monomers (the
    planted inter and intra pairs in contact), written as BinaryCIF."""
    d = tmp_path_factory.mktemp("complex_structures")
    structures, rows = cf.complex_structure_set(
        cf.L, cf.L, [(i, j) for i, j, _ in cf.INTER_PLANTED],
        [cf.INTRA_PLANTED_1[:2]], [cf.INTRA_PLANTED_2[:2]])
    (d / "structures").mkdir()
    for pdb_id, cats in structures.items():
        bcif.write_bcif(str(d / "structures" / (pdb_id + ".bcif")), cats)
    pd.DataFrame(rows).to_csv(d / "sifts.csv", index=False)
    return d


@pytest.mark.parametrize("multimer", [False, True])
def test_compare_complex_seeded_structures_match_jax(
        complex_fits, seeded_structures, tmp_path, multimer):
    """The port's complex ECs against the seeded heterodimer, homodimer
    and monomer structures (ragged all-heavy-atom residues) through both
    packages; the planted inter pairs are the closest inter ECs."""
    _, fits = complex_fits
    d = seeded_structures
    seq_files = []
    for k in (1, 2):
        path = tmp_path / "t{}.fa".format(k)
        path.write_text(">T{}/1-{}\n{}\n".format(k, cf.L, "A" * cf.L))
        seq_files.append(str(path))
    got, compared = _run_compare_both(tmp_path, lambda root: (
        _compare_complex_kwargs(
            os.path.join(root, "out", "cpx"), fits["torch"]["ec_file"],
            str(d / "structures"), str(d / "sifts.csv"), seq_files,
            ("T1", "T2"), multimer)))
    assert compared >= (20 if multimer else 17)
    # without multimer comparison each structure keeps one chain per
    # target, so the homodimer's second copy pairs no more
    assert len(got["complex_remapped_pdb_files"]) == (3 if multimer else 2)
    inter = pd.read_csv(got["ec_compared_inter_file"]).sort_values(
        "cn", ascending=False)
    assert (inter.dist.iloc[:2] < 5).all()
    assert (multimer and got["first_distmap_multimer"] is not None) or \
        (not multimer and got["first_distmap_multimer"] is None)


def test_compare_complex_needs_two_segments(seeded_structures, complex_fits,
                                            tmp_path):
    _, fits = complex_fits
    d = seeded_structures
    kwargs = _compare_complex_kwargs(
        str(tmp_path / "cpx"), fits["torch"]["ec_file"],
        str(d / "structures"), str(d / "sifts.csv"), [None, None],
        ("T1", "T2"), False)
    kwargs["segments"] = kwargs["segments"][:1]
    with pytest.raises(InvalidParameterError, match="two segments"):
        compare.run(**kwargs, device="cpu")


def test_compare_complex_fractional_highest_count(
        complex_fits, seeded_structures, tmp_path):
    """The sample config's plot_highest_count (1.0, a fraction) crashes
    the JAX package's inter-EC Pymol script (a positional slice by a
    float); the port takes the fraction of the segments' covered sites,
    as the contact maps' count ramp does: 20 inter ECs here."""
    _, fits = complex_fits
    d = seeded_structures
    seq_files = []
    for k in (1, 2):
        path = tmp_path / "t{}.fa".format(k)
        path.write_text(">T{}/1-{}\n{}\n".format(k, cf.L, "A" * cf.L))
        seq_files.append(str(path))
    kwargs = dict(_compare_complex_kwargs(
        str(tmp_path / "torch" / "cpx"), fits["torch"]["ec_file"],
        str(d / "structures"), str(d / "sifts.csv"), seq_files,
        ("T1", "T2"), False), plot_probability_cutoffs=[],
        plot_lowest_count=0.5, plot_highest_count=1.0, plot_increase=0.5)
    got = compare.run(**kwargs, device="cpu")
    with open(got["ec_lines_compared_pml_file"]) as f:
        lines = [x for x in f if x.startswith("dist")]
    assert len(lines) == 2 * cf.L
    with pytest.raises(TypeError):
        jax_compare.run(**dict(kwargs, prefix=str(tmp_path / "jax" / "c")))


# --- the protein_complex pipeline ----------------------------------------

@pytest.fixture(scope="module")
def complex_jobs(tmp_path_factory):
    """The seven-stage protein_complex job (complex_fixtures.job_config:
    align `complex` over `existing` with EMBL and ENA tables, best_hit
    with the best-reciprocal filter, couplings `complex` at 12
    iterations, compare against the seeded structures, mutate, fold
    `complex_dock`) through both packages from scratch, and the JAX
    compare, mutate and fold stages on a copy of the port job's tree."""
    out = {}
    for tag, runtime, write_bcif, device in (
            ("torch", pipeline, bcif.write_bcif, "cpu"),
            ("jax", jax_pipeline, jax_bcif.write_bcif, None)):
        d = tmp_path_factory.mktemp("complex_job_" + tag)
        config = cf.job_config(str(d / "out" / "job"),
                               cf.write_job_inputs(str(d / "in"),
                                                   write_bcif),
                               device=device)
        out[tag] = (config, runtime.execute_wrapped(**config))
    config, _ = out["torch"]
    src = os.path.dirname(config["global"]["prefix"])
    dst = str(tmp_path_factory.mktemp("jax_on_torch_complex_job") / "out")
    shutil.copytree(src, dst)
    glob = {k: v for k, v in config["global"].items() if k != "device"}
    again = dict(config, stages=["compare", "mutate", "fold"],
                 **{"global": dict(glob, prefix=os.path.join(dst, "job"))})
    out["jax on torch"] = (again, jax_pipeline.execute_wrapped(**again))
    return out


def _stage_outcfg(config, stage):
    return read_config_file("{}_{}.outcfg".format(
        insert_dir(config["global"]["prefix"], stage), stage))


def _root(config):
    return os.path.dirname(config["global"]["prefix"])


def test_complex_job_runs_every_stage(complex_jobs):
    (config, state), (_, want) = complex_jobs["torch"], complex_jobs["jax"]
    assert set(state) - {"device"} == set(want)
    runtime = pd.read_csv(state["runtime_file"])
    assert list(runtime.scope) == cf.COMPLEX_STAGES
    assert os.path.isfile(config["global"]["prefix"] + ".done")
    assert [s[0] for s in state["segments"]] == ["A_1", "B_1"]
    assert state["docking_restraint_files"]
    inter = pd.read_csv(state["inter_ec_file"])
    expected = [(ci + 1, cj + 1) for ci, cj, _ in cf.INTER_PLANTED]
    assert list(zip(inter.i, inter.j))[:2] == expected[:2]


@pytest.mark.parametrize("stage", ["align_1", "align_2", "concatenate"])
def test_complex_job_alignment_stages_equal_jax(complex_jobs, stage):
    """align `complex` (the genome-location table from the EMBL and ENA
    tables) and the concatenation: every artifact byte-equal."""
    (config, _), (jax_config, _) = complex_jobs["torch"], complex_jobs["jax"]
    got, want = _stage_outcfg(config, stage), _stage_outcfg(jax_config,
                                                             stage)
    # each job's directory holds its inputs (in/) and its outputs (out/)
    assert cf.assert_same_outputs(got, want, os.path.dirname(_root(config)),
                             os.path.dirname(_root(jax_config))) >= 5


def test_complex_job_models_within_gate(complex_jobs):
    (_, state), (_, jax_state) = complex_jobs["torch"], complex_jobs["jax"]
    got_m, want_m = CouplingsModel(state["model_file"]), JaxModel(
        jax_state["model_file"])
    for attr in ("J_ij", "h_i", "f_i", "f_ij"):
        np.testing.assert_allclose(getattr(got_m, attr),
                                   getattr(want_m, attr), rtol=RTOL,
                                   atol=ATOL, err_msg=attr)
    got, want = (pd.read_csv(s["inter_ec_file"])
                 for s in (state, jax_state))
    assert_exact_rank_order(got, want)
    got, want = (pd.read_csv(s["ec_file"]).sort_values(
        ["i", "j", "segment_i"]).reset_index(drop=True)
        for s in (state, jax_state))
    np.testing.assert_allclose(got.probability, want.probability, rtol=0,
                               atol=SKEWNORMAL_ATOL)


def test_complex_job_compare_artifacts_equal_jax_on_the_port_job(
        complex_jobs):
    """The JAX compare stage on the port job's tree writes what the
    port's wrote (hits, contacts, intra, multimer and inter maps, the
    compared ECs, remapped one- and two-chain PDB files, the .pml)."""
    (config, _), (again, _) = complex_jobs["torch"], \
        complex_jobs["jax on torch"]
    compared, err = ss.assert_same_compare_artifacts(
        _stage_outcfg(config, "compare"), _stage_outcfg(again, "compare"),
        _root(config), _root(again), zero_atol=ZERO_ATOL)
    assert compared >= 25
    assert err <= ss.DIST_ATOL


def test_complex_job_mutate_and_docking_equal_jax_on_the_port_job(
        complex_jobs):
    (config, _), (again, _) = complex_jobs["torch"], \
        complex_jobs["jax on torch"]
    got, want = (_stage_outcfg(c, "mutate") for c in (config, again))
    a, b = (pd.read_csv(o["mutation_matrix_file"]) for o in (got, want))
    pd.testing.assert_frame_equal(a, b, check_exact=False, rtol=1e-12,
                                  atol=0)
    got, want = (_stage_outcfg(c, "fold") for c in (config, again))
    assert len(got["docking_restraint_files"]) == 8
    for a, b in zip(got["docking_restraint_files"],
                    want["docking_restraint_files"], strict=True):
        assert os.path.relpath(a, _root(config)) == \
            os.path.relpath(b, _root(again))
        with open(a, "rb") as x, open(b, "rb") as y:
            assert x.read() == y.read(), a


def test_sample_complex_config_from_the_command_line(tmp_path):
    """config/sample_config_complex.txt with local inputs
    (complex_fixtures.sample_job_config; 12 iterations, and one
    count-ramp figure: plot_lowest_count 1.0) through the port's command
    line on the CPU: all seven stages run, the inter ECs' Pymol script
    takes the fractional plot_highest_count (1.0: the segments' 20
    covered sites), the archive is written. The JAX package's pipeline
    stops at its couplings stage on the same config: its couplings
    `complex` requires focus_mode, which the config leaves out."""
    from click.testing import CliRunner

    from evcouplings_torch.utils.config import write_config_file
    from evcouplings_tpu.utils.config import (
        MissingParameterError as JaxMissingParameterError,
    )

    inputs = cf.write_job_inputs(str(tmp_path / "in"), bcif.write_bcif)
    config = cf.sample_job_config(str(tmp_path / "out" / "job"), inputs,
                                  iterations=ITERATIONS, device="cpu")
    config["compare"].update(plot_lowest_count=1.0, plot_increase=0.5)
    cfg_file = str(tmp_path / "job.yml")
    write_config_file(cfg_file, config)
    result = CliRunner().invoke(pipeline.app, [cfg_file])
    assert result.exit_code == 0, result.output
    prefix = config["global"]["prefix"]
    state = read_config_file(prefix + "_final.outcfg")
    assert list(pd.read_csv(state["runtime_file"]).scope) == \
        cf.COMPLEX_STAGES
    assert os.path.isfile(state["archive_file"])
    with open(state["ec_lines_compared_pml_file"]) as f:
        assert sum(line.startswith("dist") for line in f) == 2 * cf.L
    assert len(state["contact_map_files"]) == 3
    jax_config = dict(config, **{"global": dict(
        config["global"], prefix=str(tmp_path / "jax" / "job"))})
    del jax_config["global"]["device"]
    with pytest.raises(JaxMissingParameterError, match="focus_mode"):
        jax_pipeline.execute_wrapped(**jax_config)
