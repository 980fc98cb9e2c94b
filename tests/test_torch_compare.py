"""The port's compare modules (evcouplings_torch/compare, ops/distances,
the contact-map half of visualize/pairs) against the JAX package's on the
same seeded inputs: the minimum-atom-distance contraction (float64, held
to 1e-9 A against the JAX function and a literal loop), the BinaryCIF
codec both ways, structure readers and writers byte for byte, SIFTS
lookups, DistanceMap I/O, contacts, aggregation and coverage, and the
EC comparison tables."""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import compare_fixtures as ss
from evcouplings_tpu.compare import bcif as jax_bcif
from evcouplings_tpu.compare import distances as jax_distances
from evcouplings_tpu.compare import ecs as jax_ecs
from evcouplings_tpu.compare import mapping as jax_mapping
from evcouplings_tpu.compare import pdb as jax_pdb
from evcouplings_tpu.compare import sifts as jax_sifts
from evcouplings_tpu.ops.distances import (
    min_atom_distances as jax_min_atom_distances,
)
from evcouplings_tpu.utils import helpers as jax_helpers
from evcouplings_tpu.visualize import pairs as jax_pairs
from evcouplings_torch.compare import bcif, distances, ecs, mapping, pdb
from evcouplings_torch.compare import sifts
from evcouplings_torch.ops import distances as ops_distances
from evcouplings_torch.utils import helpers
from evcouplings_torch.utils.config import InvalidParameterError
from evcouplings_torch.visualize import pairs
from test_compare import o_min_atom_distances, random_chain_arrays

ATOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread (the test runners share the
    host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# ops/distances.min_atom_distances
# ---------------------------------------------------------------------------

def _seeded_chain(n_res, seed, shift=0.0):
    chain = ss.make_chain(np.random.default_rng(seed), n_res,
                          single_atom=n_res // 2)
    return ss.atom_ranges(chain), chain["xyz"] + shift


@pytest.mark.parametrize("case", [
    "random ragged 7x5", "random ragged 20x9 blocks of 3",
    "heavy atoms 40x40 far from the origin", "heavy atoms 33x12",
    "one residue each"])
def test_min_atom_distances_matches_jax_and_the_loop(case):
    block = 3 if "blocks" in case else 512
    if case.startswith("random"):
        n_i, n_j = (7, 5) if "7x5" in case else (20, 9)
        (ri, ci), (rj, cj) = (random_chain_arrays(n_i, seed=1),
                              random_chain_arrays(n_j, seed=2))
    elif case.startswith("heavy atoms 40"):
        ri, ci = rj, cj = _seeded_chain(40, 4, shift=80.0)
    elif case.startswith("heavy atoms 33"):
        (ri, ci), (rj, cj) = _seeded_chain(33, 5), _seeded_chain(12, 6)
    else:
        ri, ci, rj, cj = [[0, 0]], [[1.0, 2.0, 3.0]], [[0, 0]], [[4, 6, 3]]
    got = ops_distances.min_atom_distances(ri, ci, rj, cj, block_rows=block,
                                           device="cpu")
    loop = o_min_atom_distances(np.asarray(ri), np.asarray(ci),
                                np.asarray(rj), np.asarray(cj))
    want = jax_min_atom_distances(ri, ci, rj, cj)
    assert got.dtype == np.float64 and got.shape == loop.shape
    np.testing.assert_allclose(got, loop, rtol=0, atol=ATOL)
    # the JAX GEMM form is within 1e-9 except at distance 0, where its
    # cancellation leaves ~sqrt(|x|^2 eps); the port returns 0 there
    off = loop > 0
    np.testing.assert_allclose(got[off], want[off], rtol=0, atol=ATOL)
    assert np.all(got[~off] == 0.0) and np.all(want[~off] < 1e-4)


def test_padding_is_one_scatter_of_the_loop():
    ranges, xyz = _seeded_chain(25, 7)
    padded, mask = ops_distances._pad_atoms(ranges, xyz)
    for k, (first, last) in enumerate(ranges):
        n = last - first + 1
        assert np.array_equal(padded[k, :n], xyz[first:last + 1])
        assert not mask[k, :n].any() and mask[k, n:].all()
        assert np.all(padded[k, n:] == 0.0)
    assert mask.shape == (25, 14) and (~mask).sum(1).min() == 1


def test_block_bytes():
    assert ops_distances.block_bytes(512, 14, 1000, 14) == 802816000


# ---------------------------------------------------------------------------
# BinaryCIF and the structure readers
# ---------------------------------------------------------------------------

def _categories():
    structures, _ = ss.small_structure_set()
    return structures["2bbb"]


def _read_categories(path):
    import msgpack

    with open(path, "rb") as f:
        raw = msgpack.unpack(f, use_list=True)
    return {cat["name"]: {c["name"]: c for c in cat["columns"]}
            for cat in raw["dataBlocks"][0]["categories"]}


@pytest.mark.parametrize("writer,reader", [
    (jax_bcif, bcif), (bcif, jax_bcif)], ids=["jax->torch", "torch->jax"])
def test_bcif_codec_both_ways(tmp_path, writer, reader):
    cats = dict(_categories(), _test={
        "ints": np.arange(-3, 7), "floats": np.linspace(-1, 1, 10),
        "strings": ["a", "bb", "a", "", "ccc"] * 2})
    path = str(tmp_path / "x.bcif")
    writer.write_bcif(path, cats)
    raw = _read_categories(path)
    assert set(raw) == set(cats)
    for cat, columns in cats.items():
        assert set(raw[cat]) == set(columns)
        for name, values in columns.items():
            got = reader.decode_column(raw[cat][name])
            values = np.asarray(values)
            if values.dtype.kind == "f":
                np.testing.assert_allclose(got, values, rtol=0, atol=5e-4)
            else:
                assert list(got) == list(values), (cat, name)


def test_bcif_decoders_match_jax():
    rng = np.random.default_rng(5)
    for dtype, unsigned in ((np.uint8, True), (np.int16, False)):
        info = np.iinfo(dtype)
        data = rng.integers(0 if unsigned else info.min, info.max,
                            size=3000, endpoint=True).astype(dtype)
        enc = {"isUnsigned": unsigned, "srcSize": 3000}
        assert np.array_equal(bcif._decode_integer_packing(data, enc),
                              jax_bcif._decode_integer_packing(data, enc))
    for chain in (
            [{"kind": "Delta", "origin": 4, "srcType": 3},
             {"kind": "ByteArray", "type": 3}],
            [{"kind": "RunLength", "srcType": 3, "srcSize": 9},
             {"kind": "ByteArray", "type": 3}],
            [{"kind": "IntervalQuantization", "min": -1.0, "max": 2.0,
              "numSteps": 7, "srcType": 33},
             {"kind": "ByteArray", "type": 3}]):
        data = np.array([7, 3, 9, 2, 1, 4], dtype="<i4").tobytes()
        assert np.array_equal(bcif.decode_data(data, chain),
                              jax_bcif.decode_data(data, chain))


@pytest.fixture(scope="module")
def structure_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("structures")
    structures, rows = ss.small_structure_set()
    for pdb_id, cats in structures.items():
        jax_bcif.write_bcif(str(d / (pdb_id + ".bcif")), cats)
    return d, rows


def _frames_equal(a, b):
    pd.testing.assert_frame_equal(a, b, check_exact=True)


@pytest.mark.parametrize("pdb_id,chain_id", [
    ("1aaa", "A"), ("2bbb", "A"), ("2bbb", "B"), ("3ccc", "A")])
def test_pdb_chain_remap_and_files_match_jax(structure_files, tmp_path,
                                             pdb_id, chain_id):
    d, _ = structure_files
    path = str(d / (pdb_id + ".bcif"))
    got, want = pdb.PDB.from_file(path), jax_pdb.PDB.from_file(path)
    assert got.models == want.models
    assert got.model_to_chains == want.model_to_chains
    _frames_equal(got.atom_table, want.atom_table)
    ch, wch = got.get_chain(chain_id), want.get_chain(chain_id)
    _frames_equal(ch.residues, wch.residues)
    _frames_equal(ch.coords, wch.coords)

    texts = {}
    for tag, chain in (("torch", ch), ("jax", wch)):
        remapped = chain.remap({(1, 7): (12, 18), (9, 16): (20, 27)})
        backbone = remapped.filter_atoms(("N", "CA", "C", "O"))
        out = str(tmp_path / (tag + ".pdb"))
        with open(out, "w") as f:
            backbone.to_file(f, chain_id="B", first_atom_id=5)
            chain.to_file(f, chain_id="A")
        with open(out) as f:
            texts[tag] = f.read()
    assert texts["torch"] == texts["jax"]

    # the classic reader on that text, both packages
    path = str(tmp_path / "torch.pdb")
    c_got = pdb.ClassicPDB.from_file(path)
    c_want = jax_pdb.ClassicPDB.from_file(path)
    assert c_got.models == c_want.models
    for chain in ("A", "B"):
        _frames_equal(c_got.get_chain(chain).residues,
                      c_want.get_chain(chain).residues)
        _frames_equal(c_got.get_chain(chain).coords,
                      c_want.get_chain(chain).coords)


def test_load_structures_reads_local_files(structure_files, tmp_path):
    d, _ = structure_files
    (tmp_path / "9zzz.bcif").write_bytes(
        open(d / "1aaa.bcif", "rb").read()[:150])
    for name in ("1aaa", "3ccc"):
        (tmp_path / (name + ".bcif")).write_bytes(
            open(d / (name + ".bcif"), "rb").read())
    with open(tmp_path / "4ddd.pdb", "w") as f:
        pdb.PDB.from_file(str(d / "2bbb.bcif")).get_chain("B").to_file(f)
    got = pdb.load_structures(["1AAA", "3ccc", "4ddd", "9zzz"],
                              str(tmp_path), raise_missing=False)
    assert sorted(got) == ["1aaa", "3ccc", "4ddd"]
    assert isinstance(got["4ddd"], pdb.ClassicPDB)
    with pytest.raises(pdb.ResourceError):
        pdb.load_structures(["9zzz"], str(tmp_path))


# ---------------------------------------------------------------------------
# SIFTS and index mapping
# ---------------------------------------------------------------------------

@pytest.fixture
def sifts_files(structure_files, tmp_path):
    _, rows = structure_files
    rows = rows + [
        ss.sifts_row("5eee", "NA", "OTHER", (1, 10), (101, 110)),
        ss.sifts_row("5eee", "B", "TARGET_SEQ", (1, 10), (11, 20)),
        ss.sifts_row("6fff", "A", "OTHER", (1, 10), (1, 12)),  # dropped
    ]
    table = tmp_path / "sifts.csv"
    pd.DataFrame(rows).to_csv(table, index=False)
    seqs = tmp_path / "pdb_seqs.fa"
    seqs.write_text(">sp|TARGET_SEQ|TGT_HUMAN d\nACD\n"
                    ">sp|OTHER|OTH_HUMAN d\nACD\n")
    return str(table), str(seqs)


@pytest.mark.parametrize("with_sequences", [False, True])
def test_sifts_lookups_match_jax(sifts_files, with_sequences):
    table, seqs = sifts_files
    seqs = seqs if with_sequences else None
    got, want = sifts.SIFTS(table, seqs), jax_sifts.SIFTS(table, seqs)
    _frames_equal(got.table, want.table)
    assert "NA" in set(got.table.pdb_chain)
    queries = [("TARGET_SEQ", False), ("TARGET_SEQ", True), ("NOPE", False),
               ("OTHER", False)]
    if with_sequences:
        queries += [("TGT_HUMAN", False), ("OTH_HUMAN", True)]
    for uniprot_id, reduce_chains in queries:
        g = got.by_uniprot_id(uniprot_id, reduce_chains=reduce_chains)
        w = want.by_uniprot_id(uniprot_id, reduce_chains=reduce_chains)
        _frames_equal(g.hits, w.hits)
        assert g.mapping == w.mapping
    for args in (("1AAA",), ("2bbb", "B"), ("5eee", "NA"),
                 ("5eee", None, "TARGET_SEQ")):
        g, w = got.by_pdb_id(*args), want.by_pdb_id(*args)
        _frames_equal(g.hits, w.hits)
        assert g.mapping == w.mapping
    with pytest.raises(ValueError, match="Multiple Uniprot"):
        got.by_pdb_id("5eee")


def test_sifts_search_is_not_ported(sifts_files):
    table, seqs = sifts_files
    with pytest.raises(NotImplementedError, match="ROADMAP A19"):
        sifts.SIFTS(table, seqs).by_alignment(sequence_id="TARGET_SEQ")
    with pytest.raises(NotImplementedError, match="ROADMAP A19"):
        sifts.find_homologs()


def test_fetch_uniprot_mapping_streams_results(monkeypatch):
    """The port's UniProt mapping flow, with urlopen replaced (no request
    leaves the process): it rewrites the result URL to the stream
    endpoint."""
    import urllib.request

    fetched = []

    class FakeResponse:
        def __init__(self, payload):
            self.payload = payload
            self.headers = {}

        def read(self):
            return self.payload.encode()

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def fake_urlopen(url, data=None):
        fetched.append(url)
        if url.endswith("/idmapping/run"):
            return FakeResponse('{"jobId": "J1"}')
        if "/idmapping/status/" in url:
            return FakeResponse('{"jobStatus": "FINISHED"}')
        if "/idmapping/details/" in url:
            return FakeResponse(
                '{"redirectURL": "https://rest.uniprot.org/'
                'idmapping/uniprotkb/results/J1"}')
        return FakeResponse(">sp|P1|X\nACDEF\n")

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    text = sifts.fetch_uniprot_mapping(["P1"])
    assert text.startswith(">sp|P1|X")
    assert "/results/stream/" in fetched[-1]
    assert fetched[-1].endswith("?format=fasta&includeIsoform=true")


def test_map_indices_and_alignment_mapping_match_jax(tmp_path):
    for args in (("AC-DE", 1, 4, "A-GDE", 10, 13),
                 ("--AC.D", 5, 7, "GGA-.D", 1, 4)):
        _frames_equal(mapping.map_indices(*args),
                      jax_mapping.map_indices(*args))
    path = tmp_path / "ali.fa"
    path.write_text(">T/3-7\nAC-DEF\n>a/1-5\nACGD-F\n>b/10-12\n-C--EF\n")
    _frames_equal(mapping.alignment_index_mapping(str(path), "fasta", "T"),
                  jax_mapping.alignment_index_mapping(str(path), "fasta",
                                                      "T"))


def test_helpers_match_jax():
    for a, b in (((1, 5), (3, 9)), ((1, 2), (2, 3)), ((0, 10), (2, 4))):
        assert helpers.range_overlap(a, b) == jax_helpers.range_overlap(a, b)
    with pytest.raises(InvalidParameterError):
        helpers.range_overlap((3, 3), (1, 2))
    for data in ([], [4], [1, 2, 3, 7, 8, 10], range(5, 9)):
        assert helpers.find_segments(data) == jax_helpers.find_segments(data)


# ---------------------------------------------------------------------------
# distance maps and EC comparison
# ---------------------------------------------------------------------------

def _chains(structure_files):
    d, rows = structure_files
    got = {name: pdb.PDB.from_file(str(d / (name + ".bcif")))
           for name in ("1aaa", "2bbb", "3ccc")}
    want = {name: jax_pdb.PDB.from_file(str(d / (name + ".bcif")))
            for name in ("1aaa", "2bbb", "3ccc")}
    return got, want, rows


def _assert_same_map(got, want):
    _frames_equal(got.residues_i, want.residues_i)
    _frames_equal(got.residues_j, want.residues_j)
    assert got.symmetric == want.symmetric
    off = ~(want.dist_matrix < 1e-4)
    np.testing.assert_allclose(got.dist_matrix[off], want.dist_matrix[off],
                               rtol=0, atol=ATOL)
    assert np.all(got.dist_matrix[~off] == 0.0)


def test_distance_map_io_contacts_and_aggregation(structure_files,
                                                  tmp_path):
    got_s, want_s, _ = _chains(structure_files)
    maps = {}
    for tag, module, structs, kw in (
            ("torch", distances, got_s, {"device": "cpu"}),
            ("jax", jax_distances, want_s, {})):
        a = structs["2bbb"].get_chain("A")
        b = structs["2bbb"].get_chain("B")
        intra = module.DistanceMap.from_coords(a, **kw)
        inter = module.DistanceMap.from_coords(a, b, **kw)
        other = module.DistanceMap.from_coords(
            structs["1aaa"].get_chain("A").remap(
                {(1, 18): (1, 18)}), **kw)
        intra.id, other.id = "x", "y"
        maps[tag] = (intra, inter, other,
                     module.DistanceMap.aggregate(intra, other),
                     module.DistanceMap.aggregate(intra, other,
                                                  intersect=True))
    for g, w in zip(maps["torch"], maps["jax"]):
        _assert_same_map(g, w)
    intra, inter, _, agg, _ = maps["torch"]
    assert sorted(agg.structure_coverage()) == sorted(
        maps["jax"][3].structure_coverage())
    for dm, want in ((intra, maps["jax"][0]), (inter, maps["jax"][1])):
        for cutoff, min_dist in ((5.0, None), (8.0, 3.0)):
            g = dm.contacts(cutoff, min_dist)
            w = want.contacts(cutoff, min_dist)
            np.testing.assert_allclose(g.pop("dist"), w.pop("dist"),
                                       rtol=0, atol=ATOL)
            _frames_equal(g, w)
        for name in ("sym", "asym"):
            prefix = str(tmp_path / name)
            m = intra if name == "sym" else inter
            m.to_file(prefix)
            back = distances.DistanceMap.from_file(prefix)
            jback = jax_distances.DistanceMap.from_file(prefix)
            _frames_equal(back.residues_i, jback.residues_i)
            _frames_equal(back.residues_j, jback.residues_j)
            assert np.array_equal(back.dist_matrix, m.dist_matrix)
            assert back.symmetric == (name == "sym")
    assert intra.dist("3", "3") == 0.0
    with pytest.raises(KeyError):
        intra.dist(999, 1)


@pytest.mark.parametrize("kind", ["intra", "multimer", "inter", "remap"])
def test_structure_hit_functions_match_jax(structure_files, tmp_path,
                                           kind):
    got_s, want_s, rows = _chains(structure_files)
    rows = pd.DataFrame(rows)
    results = {}
    for tag, module, smod, structs, kw in (
            ("torch", distances, sifts, got_s, {"device": "cpu"}),
            ("jax", jax_distances, jax_sifts, want_s, {})):
        table = str(tmp_path / "sifts.csv")
        rows.to_csv(table, index=False)
        hits = smod.SIFTS(table).by_uniprot_id("TARGET_SEQ")
        prefix = str(tmp_path / tag / "out")
        if kind == "intra":
            results[tag] = module.intra_dists(
                hits, structs, output_prefix=prefix, **kw)
        elif kind == "multimer":
            results[tag] = module.multimer_dists(
                hits, structs, output_prefix=prefix, **kw)
        elif kind == "inter":
            first = smod.SIFTSResult(hits.hits.iloc[[1]], hits.mapping)
            second = smod.SIFTSResult(hits.hits.iloc[[2]], hits.mapping)
            results[tag] = module.inter_dists(first, second, structs, **kw)
        else:
            seq = {k: "ACDEFGHIKLMNPQRSTV"[k - 11] for k in range(11, 29)}
            results[tag] = {k: open(v).read() for k, v in
                            module.remap_chains(hits, prefix, seq,
                                                structs).items()}
    got, want = results["torch"], results["jax"]
    if kind == "remap":
        assert got == want and len(got) == 4
        return
    _assert_same_map(got, want)
    if kind == "intra":
        _frames_equal(got.aggregated_residue_maps,
                      want.aggregated_residue_maps)
    if kind != "inter":
        g, w = (m.individual_distance_map_table for m in (got, want))
        assert [os.path.basename(p) for p in g.residue_table] == \
            [os.path.basename(p) for p in w.residue_table]


def test_coupling_scores_compared_match_jax(structure_files, tmp_path):
    got_s, want_s, _ = _chains(structure_files)
    rng = np.random.default_rng(8)
    ec = pd.DataFrame([(i, j) for i in range(1, 19) for j in range(i + 1, 19)],
                      columns=["i", "j"])
    ec["cn"] = rng.random(len(ec))
    ec["score"] = ec.cn
    out = {}
    for tag, module, emod, structs, kw in (
            ("torch", distances, ecs, got_s, {"device": "cpu"}),
            ("jax", jax_distances, jax_ecs, want_s, {})):
        a = structs["2bbb"].get_chain("A")
        b = structs["2bbb"].get_chain("B")
        intra = module.DistanceMap.from_coords(a, **kw)
        multi = module.DistanceMap.from_coords(a, b, **kw)
        path = str(tmp_path / (tag + ".csv"))
        emod.coupling_scores_compared(ec, intra, multi, dist_cutoff=8,
                                      output_file=path, score="score",
                                      min_sequence_dist=3)
        with_dist = emod.add_distances(ec, intra)
        out[tag] = (pd.read_csv(path), with_dist,
                    emod.add_precision(with_dist, dist_cutoff=8))
    for g, w in zip(out["torch"], out["jax"]):
        for col in ("dist", "dist_intra", "dist_multimer"):
            if col in g:
                np.testing.assert_allclose(g.pop(col), w.pop(col),
                                           rtol=0, atol=ATOL)
        _frames_equal(g, w)


# ---------------------------------------------------------------------------
# contact maps
# ---------------------------------------------------------------------------

def test_secondary_structure_segments_and_boundaries_match_jax(
        structure_files):
    for s in ("HHHCCEEE--HC", "", "E"):
        assert pairs.find_secondary_structure_segments(s, offset=4) == \
            jax_pairs.find_secondary_structure_segments(s, offset=4)
    got_s, want_s, _ = _chains(structure_files)
    ec = pd.DataFrame({"i": [2, 5, 30], "j": [9, 12, 40]})
    dm = distances.DistanceMap.from_coords(got_s["1aaa"].get_chain("A"),
                                           device="cpu")
    jdm = jax_distances.DistanceMap.from_coords(
        want_s["1aaa"].get_chain("A"))
    for mode in ("union", "intersection", "ecs", "structure", (1, 9),
                 [(1, 9), (2, 8)]):
        assert pairs.find_boundaries(mode, ec, dm, None, True) == \
            jax_pairs.find_boundaries(mode, ec, jdm, None, True)


def test_contact_map_draws_like_jax(structure_files):
    """The contact-map half draws the same artists as the JAX package's
    (matplotlib is imported on use, and is installed here)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    got_s, want_s, _ = _chains(structure_files)
    ec = pd.DataFrame({"i": [102, 105, 104], "j": [109, 112, 117],
                       "score": [1.0, 0.5, 0.2]})
    drawn = []
    for module, structs, kw in ((distances, got_s, {"device": "cpu"}),
                                (jax_distances, want_s, {})):
        mod_pairs = pairs if module is distances else jax_pairs
        chain = structs["1aaa"].get_chain("A")
        dm = module.DistanceMap.from_coords(chain, **kw)
        fig = plt.figure()
        ax = mod_pairs.plot_contact_map(ec, dm, dm, show_secstruct=True,
                                        show_structure_coverage=True)
        drawn.append((len(ax.collections), len(ax.patches),
                      len(ax.lines), ax.get_xlim(), ax.get_ylim()))
        plt.close(fig)
    assert drawn[0] == drawn[1]
    assert drawn[0][0] >= 3


def test_get_turns_transport_failures_into_resource_errors(monkeypatch,
                                                           tmp_path):
    """utils/system.get, which PDB.from_id and ClassicPDB.from_id call
    for a structure without a local file, with the transport replaced (no
    request leaves the process): through requests where it is installed,
    else urllib."""
    import sys
    import urllib.error
    import urllib.request

    from evcouplings_torch.utils import system

    class Body:
        status = 200

        def read(self):
            return b"ATOM"

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    class Opener:
        def __init__(self, *handlers):
            self.handlers = handlers

        def open(self, request):
            if "bad" in request.full_url:
                raise urllib.error.URLError("refused")
            return Body()

    monkeypatch.setitem(sys.modules, "requests", None)   # ImportError
    monkeypatch.setattr(urllib.request, "build_opener", Opener)
    r = system.get("https://example.invalid/ok")
    assert (r.status_code, r.content, r.text) == (200, b"ATOM", "ATOM")
    system.get("https://example.invalid/ok", str(tmp_path / "x"))
    assert (tmp_path / "x").read_bytes() == b"ATOM"
    with pytest.raises(system.ResourceError, match="refused"):
        system.get("https://example.invalid/bad")


def test_complex_contact_map_and_axis_helpers_draw_like_jax(structure_files):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    got_s, want_s, _ = _chains(structure_files)
    intra1 = pd.DataFrame({"i": [2, 3], "j": [9, 12], "cn": [1.0, 0.4]})
    intra2 = pd.DataFrame({"i": [1, 4], "j": [8, 15], "cn": [0.7, 0.2]})
    inter = pd.DataFrame({"i": [2, 5], "j": [3, 7], "cn": [0.9, 0.1]})
    drawn = []
    for mod_pairs, module, structs, kw in (
            (pairs, distances, got_s, {"device": "cpu"}),
            (jax_pairs, jax_distances, want_s, {})):
        a = structs["2bbb"].get_chain("A").remap({(1, 16): (1, 16)})
        b = structs["2bbb"].get_chain("B").remap({(1, 16): (1, 16)})
        d_a = module.DistanceMap.from_coords(a, **kw)
        d_b = module.DistanceMap.from_coords(b, **kw)
        d_ab = module.DistanceMap.from_coords(a, b, **kw)
        fig = plt.figure()
        ax = mod_pairs.complex_contact_map(intra1, intra2, inter, d_a, None,
                                           d_b, None, d_ab)
        row = [len(ax.collections), len(ax.patches), len(ax.lines),
               ax.get_xlim(), ax.get_ylim()]
        mod_pairs.plot_ec_coverage(intra1, True, ax=ax)
        mod_pairs.plot_structure_coverage(d_a.structure_coverage(), ax=ax)
        row += [len(ax.patches),
                mod_pairs.set_range(intra1, x=(0, 20), y=(0, 30), ax=ax,
                                    margin=2)]
        drawn.append(row)
        plt.close(fig)
    assert drawn[0] == drawn[1]
    assert drawn[0][0] >= 5
