"""The port's compare stage (evcouplings_torch/compare/protocol.py)
against the JAX package's, on the same inputs: the fixture of
tests/test_compare_protocol.py (one straight chain, one planted contact)
and seeded structures with ragged all-heavy-atom residues, a homodimer,
two-segment SIFTS mappings and sub-range chains (tests/compare_fixtures.py).
Every file the outcfg names is compared
(compare_fixtures.assert_same_compare_artifacts): CSVs equal except the
distance columns (atol 1e-9 A), remapped and renumbered PDB files and
the Pymol script byte for byte, figures for existence. Then the
branches: no hits, structures that fail to load; structures found by
sequence search (by_alignment, jackhmmer and hmmbuild + hmmsearch, fake
binaries from tests/search_fixtures.py), whose hit tables and per-hit
mapping CSVs must equal the JAX package's too; and the complex protocol,
which is not ported and raises naming ROADMAP A19c.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import compare_fixtures as ss
import search_fixtures as sf
from evcouplings_tpu.compare import protocol as jax_protocol
from evcouplings_tpu.compare import sifts as jax_sifts
from evcouplings_tpu.utils.config import (
    InvalidParameterError as JaxInvalidParameterError,
)
from evcouplings_torch.compare import bcif
from evcouplings_torch.compare import protocol, sifts
from evcouplings_torch.utils.config import InvalidParameterError
from test_compare_protocol import compare_setup  # noqa: F401 (fixture)

# a distance of 0 from the port may be this far from 0 in the JAX
# package's GEMM form (~sqrt(|x|^2 eps))
ZERO_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread (the test runners share the
    host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def compare_kwargs(prefix, ec_file, structure_dir, sifts_table,
                   target_seq_file, sequence_id, **overrides):
    """The standard protocol's settings (tests/test_compare_protocol.py's
    test_standard_protocol)."""
    kwargs = dict(
        protocol="standard", prefix=prefix, ec_file=ec_file,
        min_sequence_distance=5, pdb_mmtf_dir=structure_dir,
        atom_filter=None, compare_multimer=False, distance_cutoff=5,
        target_sequence_file=target_seq_file, scale_sizes=True,
        pdb_ids=None, max_num_hits=25, max_num_structures=10,
        sifts_mapping_table=sifts_table, sifts_sequence_db=None,
        by_alignment=False, pdb_alignment_method="jackhmmer",
        alignment_min_overlap=20, sequence_id=sequence_id,
        sequence_file=None, region=None, use_bitscores=True,
        domain_threshold=0.5, sequence_threshold=0.5,
        plot_probability_cutoffs=[0.9], boundaries="union",
        plot_lowest_count=2, plot_highest_count=3, plot_increase=1,
        draw_secondary_structure=False,
    )
    kwargs.update(overrides)
    return kwargs


def assert_same_as_jax(got, want, got_root, want_root):
    """The port's compare outcfg and artifacts against the JAX
    package's; returns the number of files compared."""
    return ss.assert_same_compare_artifacts(got, want, got_root, want_root,
                                            zero_atol=ZERO_ATOL)[0]


def run_both(tmp_path, kwargs_for):
    """The standard protocol through both packages; kwargs_for(root)
    gives the settings with outputs under root."""
    out = {}
    for tag, runner, extra in (("torch", protocol, {"device": "cpu"}),
                               ("jax", jax_protocol, {})):
        root = str(tmp_path / tag)
        out[tag] = (root, runner.run(**kwargs_for(root), **extra))
    return out


def test_fixture_standard_protocol_matches_jax(compare_setup, tmp_path):
    s = compare_setup
    out = run_both(tmp_path, lambda root: compare_kwargs(
        os.path.join(root, "cmp"), s["ec_file"], s["structure_dir"],
        s["sifts_table"], s["target_seq_file"], "TESTPROT"))
    (got_root, got), (want_root, want) = out["torch"], out["jax"]
    assert assert_same_as_jax(got, want, got_root, want_root) >= 10
    top = pd.read_csv(got["ec_compared_longrange_file"]).iloc[0]
    assert (top.i, top.j, top.precision) == (13, 20, 1.0)
    assert top.dist == pytest.approx(3.8, abs=1e-12)


@pytest.fixture(scope="module")
def seeded_inputs(tmp_path_factory):
    """The three seeded structures (tests/compare_fixtures.py) as
    BinaryCIF, their SIFTS table, an EC table over TARGET_SEQ/11-28 whose
    top three pairs are the planted contacts, and the target sequence."""
    d = tmp_path_factory.mktemp("seeded")
    structures, rows = ss.small_structure_set()
    structure_dir = d / "structures"
    structure_dir.mkdir()
    for pdb_id, cats in structures.items():
        bcif.write_bcif(str(structure_dir / (pdb_id + ".bcif")), cats)
    pd.DataFrame(rows).to_csv(d / "sifts.csv", index=False)

    rng = np.random.default_rng(3)
    pairs = [(i, j) for i in range(11, 29) for j in range(i + 1, 29)]
    planted = [(13, 20), (15, 26), (17, 23)]
    score = rng.random(len(pairs))
    for k, p in enumerate(pairs):
        if p in planted:
            score[k] = 2.0 + planted.index(p)
    ecs = pd.DataFrame({
        "i": [p[0] for p in pairs], "A_i": "A",
        "j": [p[1] for p in pairs], "A_j": "C",
        "fn": score, "cn": score, "score": score,
        "probability": np.clip(score, 0, 1),
    }).sort_values("cn", ascending=False)
    ecs.to_csv(d / "ECs.csv", index=False)
    (d / "target.fa").write_text(
        ">TARGET_SEQ/11-28\n" + ("ACDEFGHIKL" * 2)[:18] + "\n")
    return {"root": d, "structure_dir": str(structure_dir),
            "sifts_table": str(d / "sifts.csv"),
            "ec_file": str(d / "ECs.csv"),
            "target_seq_file": str(d / "target.fa")}


def _seeded_kwargs(inputs, sequence_id="TARGET_SEQ", **overrides):
    def kwargs_for(root):
        return compare_kwargs(
            os.path.join(root, "cmp"), inputs["ec_file"],
            inputs["structure_dir"], inputs["sifts_table"],
            inputs["target_seq_file"], sequence_id, **overrides)
    return kwargs_for


@pytest.mark.parametrize("multimer,figures", [(True, True), (False, False)])
def test_seeded_structures_match_jax(seeded_inputs, tmp_path, multimer,
                                     figures):
    plots = {} if figures else dict(plot_probability_cutoffs=[],
                                    plot_lowest_count=4,
                                    plot_highest_count=3)
    out = run_both(tmp_path, _seeded_kwargs(
        seeded_inputs, compare_multimer=multimer,
        draw_secondary_structure=True, **plots))
    (got_root, got), (want_root, want) = out["torch"], out["jax"]
    assert assert_same_as_jax(got, want, got_root, want_root) >= 12
    assert bool(got["contact_map_files"]) == figures
    hits = pd.read_csv(got["pdb_structure_hits_file"])
    assert list(hits.pdb_id) == (["1aaa", "2bbb", "2bbb", "3ccc"]
                                 if multimer else ["1aaa", "2bbb", "3ccc"])
    assert len(got["remapped_pdb_files"]) == len(hits)
    assert (got["distmap_multimer"] is not None) == multimer
    # the planted pairs lead the long-range table, all true contacts
    top = pd.read_csv(got["ec_compared_longrange_file"]).iloc[:3]
    assert set(zip(top.i, top.j)) == {(13, 20), (15, 26), (17, 23)}
    assert (top.dist <= 5).all() and (top.precision == 1.0).all()


def test_no_structure_hits(seeded_inputs, tmp_path):
    out = run_both(tmp_path, _seeded_kwargs(
        seeded_inputs, sequence_id="UNKNOWN_PROTEIN",
        plot_probability_cutoffs=None, plot_lowest_count=2,
        plot_highest_count=2))
    (got_root, got), (want_root, want) = out["torch"], out["jax"]
    assert assert_same_as_jax(got, want, got_root, want_root) >= 2
    for key in ("distmap_monomer", "ec_compared_all_file",
                "remapped_pdb_files"):
        assert got[key] is None
    assert len(got["contact_map_files"]) == 1


def test_structures_that_fail_to_load_are_skipped(seeded_inputs, tmp_path):
    """A truncated BinaryCIF file and a structure that was not loaded at
    all: both packages skip them (raise_missing=False) and agree on the
    rest. (An absent file would be fetched from the RCSB servers.)"""
    src = seeded_inputs["structure_dir"]
    broken = tmp_path / "structures"
    broken.mkdir()
    for name in ("1aaa", "2bbb", "3ccc"):
        data = open(os.path.join(src, name + ".bcif"), "rb").read()
        (broken / (name + ".bcif")).write_bytes(
            data[:200] if name == "2bbb" else data)
    out = run_both(tmp_path, _seeded_kwargs(
        seeded_inputs, pdb_mmtf_dir=str(broken), compare_multimer=True))
    (got_root, got), (want_root, want) = out["torch"], out["jax"]
    assert_same_as_jax(got, want, got_root, want_root)
    assert sorted(os.path.basename(f).split("_")[2]
                  for f in got["remapped_pdb_files"]) == ["1aaa", "3ccc"]
    assert got["distmap_multimer"] is None


def test_every_structure_missing(seeded_inputs, tmp_path, monkeypatch):
    """Every fetch failing (tests/test_compare_protocol.py's case): the
    stage completes without distance maps, in both packages."""
    for module in (protocol, jax_protocol):
        monkeypatch.setattr(module, "load_structures",
                            lambda *args, **kwargs: {})
    out = run_both(tmp_path, _seeded_kwargs(seeded_inputs))
    (got_root, got), (want_root, want) = out["torch"], out["jax"]
    assert_same_as_jax(got, want, got_root, want_root)
    assert got["distmap_monomer"] is None
    assert got["ec_compared_all_file"] is None


@pytest.fixture(scope="module")
def search_inputs(seeded_inputs, tmp_path_factory):
    """The seeded structures found by sequence search: a SIFTS table with
    3ccc reassigned to a homolog numbered +90 that lacks target residue 16
    (search_fixtures.SMALL_HOMOLOG), the SIFTS sequence file, fake
    jackhmmer, hmmbuild and hmmsearch returning the prepared hits, and a
    raw focus alignment of the target for hmmbuild."""
    d = tmp_path_factory.mktemp("search")
    _, rows = ss.small_structure_set()
    header, seq = "TARGET_SEQ/11-28", ("ACDEFGHIKL" * 2)[:18]
    rows, seqs, outputs = sf.small_sifts_search(str(d), rows, header, seq)
    pd.DataFrame(rows).to_csv(d / "sifts_search.csv", index=False)
    focus = d / "raw_focus.fasta"
    focus.write_text(">{}\n{}\n>hom1/1-18\n{}\n".format(header, seq,
                                                        seq[::-1]))
    return dict(
        seeded_inputs, sifts_table=str(d / "sifts_search.csv"),
        sifts_sequence_db=seqs, raw_focus_alignment_file=str(focus),
        jackhmmer=sf.fake_search(d / "jackhmmer",
                                 {seqs: outputs["jackhmmer"]}),
        hmmsearch=sf.fake_search(d / "hmmsearch",
                                 {seqs: outputs["hmmsearch"]}),
        hmmbuild=sf.fake_hmmbuild(d / "hmmbuild"))


SEARCH_KEYS = ("sifts_sequence_db", "raw_focus_alignment_file", "jackhmmer",
               "hmmsearch", "hmmbuild")


def _search_kwargs(inputs, method, **overrides):
    """compare `standard` with by_alignment: the search's query is the
    target sequence file, numbered from 11."""
    return _seeded_kwargs(
        inputs, by_alignment=True, pdb_alignment_method=method,
        alignment_min_overlap=10, sequence_file=inputs["target_seq_file"],
        first_index=11, compare_multimer=True,
        **{k: inputs[k] for k in SEARCH_KEYS}, **overrides)


@pytest.mark.parametrize("method", ["jackhmmer", "hmmsearch"])
def test_by_alignment_matches_jax(search_inputs, tmp_path, method):
    out = run_both(tmp_path, _search_kwargs(search_inputs, method))
    (got_root, got), (want_root, want) = out["torch"], out["jax"]
    assert assert_same_as_jax(got, want, got_root, want_root) >= 12
    hits = pd.read_csv(got["pdb_structure_hits_file"])
    assert list(hits.pdb_id) == ["1aaa", "2bbb", "2bbb", "3ccc"]
    assert list(hits.uniprot_ac) == ["TARGET_SEQ"] * 3 + ["HOM_ONE"]
    # one mapping CSV per hit, as the JAX package writes them
    aux = os.path.join(got_root, "aux")
    mappings = sorted(f for f in os.listdir(aux)
                      if f.startswith("cmp_mapping"))
    assert len(mappings) == 4
    for name in mappings:
        ss.assert_same_compare_file(os.path.join(aux, name),
                                    os.path.join(want_root, "aux", name))
    top = pd.read_csv(got["ec_compared_longrange_file"]).iloc[:3]
    assert set(zip(top.i, top.j)) == {(13, 20), (15, 26), (17, 23)}
    assert (top.dist <= 5).all() and (top.precision == 1.0).all()


@pytest.mark.parametrize("method", ["jackhmmer", "hmmsearch"])
def test_find_homologs_matches_jax(search_inputs, tmp_path, method):
    kwargs = dict(sequence_id="TARGET_SEQ", first_index=11,
                  sequence_file=search_inputs["target_seq_file"],
                  sequence_database=search_inputs["sifts_sequence_db"],
                  **{k: search_inputs[k] for k in SEARCH_KEYS[1:]})
    got_ali, got = sifts.find_homologs(
        method, prefix=str(tmp_path / "torch" / "fh"), **kwargs)
    want_ali, want = jax_sifts.find_homologs(
        method, prefix=str(tmp_path / "jax" / "fh"), **kwargs)
    pd.testing.assert_frame_equal(got, want)
    assert list(got.alignment_id) == ["sp|TARGET_SEQ|TGT_SEQ/11-28",
                                      "tr|HOM_ONE|HOM1_XENLA/101-117"]
    assert list(got_ali.ids) == list(want_ali.ids)
    assert (got_ali.matrix == want_ali.matrix).all()


def test_invalid_search_method_raises(search_inputs, tmp_path):
    for module, error in ((protocol, InvalidParameterError),
                          (jax_protocol, JaxInvalidParameterError)):
        with pytest.raises(error, match="pdb search method"):
            module.run(**_search_kwargs(search_inputs, "blast")(
                str(tmp_path)), device="cpu")
    for module, error in ((sifts, InvalidParameterError),
                          (jax_sifts, JaxInvalidParameterError)):
        with pytest.raises(error, match="pdb_alignment_method"):
            module.find_homologs("blast", prefix=str(tmp_path / "x"))


@pytest.mark.parametrize("edit", [{"by_alignment": True},
                                  {"protocol": "complex"}])
def test_unported_parts_raise_naming_a19(search_inputs, tmp_path, edit):
    """ROADMAP A19 was split: the sequence search (by_alignment, A19a) is
    ported and finds the seeded structures; the complex protocol (A19c)
    still raises naming its item."""
    if "by_alignment" in edit:
        out = protocol.run(**_search_kwargs(search_inputs, "jackhmmer")(
            str(tmp_path)), device="cpu")
        hits = pd.read_csv(out["pdb_structure_hits_file"])
        assert set(hits.pdb_id) == {"1aaa", "2bbb", "3ccc"}
        return
    kwargs = _seeded_kwargs(search_inputs, **edit)(str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP A19c"):
        protocol.run(**kwargs, device="cpu")


def test_no_device_without_a_card_raises(seeded_inputs, tmp_path,
                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kwargs = _seeded_kwargs(seeded_inputs)(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        protocol.run(**kwargs)
    assert not os.path.exists(str(tmp_path / "cmp_structure_hits.csv"))


def test_unknown_protocol_raises(tmp_path):
    from evcouplings_torch.utils.config import InvalidParameterError

    with pytest.raises(InvalidParameterError):
        protocol.run(protocol="nope")


def test_ten_structure_set_matches_jax(tmp_path):
    """chip_smoke.py phase 8c's structure set at L=40: ten structures
    (homodimers, sub-ranges, a two-segment mapping, a chain named "NA",
    a truncated file that is skipped) under the sample config's compare
    settings (multimer on, min_sequence_distance 6)."""
    contacts = [(3, 20), (8, 33), (12, 38)]
    structures, rows = ss.full_structure_set(40, contacts)
    structure_dir = tmp_path / "structures"
    structure_dir.mkdir()
    for pdb_id, cats in structures.items():
        path = str(structure_dir / (pdb_id + ".bcif"))
        bcif.write_bcif(path, cats)
        if pdb_id == "1t10":
            data = open(path, "rb").read()
            open(path, "wb").write(data[:len(data) // 2])
    pd.DataFrame(rows).to_csv(tmp_path / "sifts.csv", index=False)
    rng = np.random.default_rng(4)
    pairs = [(i, j) for i in range(1, 41) for j in range(i + 1, 41)]
    score = rng.random(len(pairs))
    for i, j in contacts:
        score[pairs.index((i + 1, j + 1))] += 2.0
    pd.DataFrame({"i": [p[0] for p in pairs], "A_i": "A",
                  "j": [p[1] for p in pairs], "A_j": "C", "cn": score,
                  "score": score, "probability": score / 3}).sort_values(
        "score", ascending=False).to_csv(tmp_path / "ECs.csv", index=False)
    (tmp_path / "target.fa").write_text(
        ">TARGET/1-40\n" + "ACDEFGHIKLMNPQRSTVWY" * 2 + "\n")
    out = run_both(tmp_path, lambda root: compare_kwargs(
        os.path.join(root, "cmp"), str(tmp_path / "ECs.csv"),
        str(structure_dir), str(tmp_path / "sifts.csv"),
        str(tmp_path / "target.fa"), "TARGET", compare_multimer=True,
        min_sequence_distance=6, plot_probability_cutoffs=[],
        plot_lowest_count=2, plot_highest_count=1))
    (got_root, got), (want_root, want) = out["torch"], out["jax"]
    assert assert_same_as_jax(got, want, got_root, want_root) >= 30
    hits = pd.read_csv(got["pdb_structure_hits_file"],
                       keep_default_na=False)
    assert len(hits) == 13 and "NA" in set(hits.pdb_chain)
    assert len(got["remapped_pdb_files"]) == 12          # 1t10 skipped
    top = pd.read_csv(got["ec_compared_longrange_file"]).iloc[:3]
    assert set(zip(top.i, top.j)) == {(i + 1, j + 1) for i, j in contacts}
    assert (top.precision == 1.0).all()


@pytest.mark.parametrize("selection,want", [
    (dict(pdb_ids=["3CCC", "2bbb"]), ["2bbb", "2bbb", "3ccc"]),
    (dict(pdb_ids="2BBB", max_num_hits=1), ["2bbb"]),
    (dict(max_num_structures=2), ["1aaa", "2bbb", "2bbb"])])
def test_structure_selection_matches_jax(seeded_inputs, tmp_path, selection,
                                         want):
    out = run_both(tmp_path, _seeded_kwargs(
        seeded_inputs, compare_multimer=True, plot_probability_cutoffs=[],
        plot_lowest_count=2, plot_highest_count=1, **selection))
    (got_root, got), (want_root, jax_out) = out["torch"], out["jax"]
    assert assert_same_as_jax(got, jax_out, got_root, want_root) >= 10
    hits = pd.read_csv(got["pdb_structure_hits_file"])
    assert list(hits.pdb_id) == want
    assert len(pd.read_csv(got["pdb_structure_hits_unfiltered_file"])) == 4
