"""The port's annotation utilities around the align stage
(evcouplings_torch/align/{ids,ena,pfam}.py) against the JAX package's:
the cases of tests/test_align_annotation.py through both packages, every
returned list and table exactly equal; then pfam_hits with a fake hmmscan
(a bash script that writes a prepared domain table) and the star-exports
of the align package."""

import gzip

import pandas as pd
import pytest

import search_fixtures as sf
from evcouplings_tpu import align as jax_align_package
from evcouplings_tpu.align import ena as jax_ena
from evcouplings_tpu.align import ids as jax_ids
from evcouplings_tpu.align import pfam as jax_pfam
from evcouplings_torch import align as align_package
from evcouplings_torch.align import ena, ids, pfam
from test_align_annotation import ena_setup  # noqa: F401 (fixture)

HEADERS = (
    ">UniRef100_P12345/1-100 some description\nAC\n"
    ">tr|Q99999|Q99999_HUMAN/5-50\nAC\n"
    ">P55555/2-30 OS=Bacterium\nAC\n"
    ">UniRef100_P1/1-10\nAC\n>UniRef100_P1/20-30\nAC\n"
    ">Q60019|NQO8_THET8/1-365\nAC\n>gene123|rest\nAC\n>nomatch\nAC\n")


@pytest.mark.parametrize("regex", [None, [r"^(\w+)\|"]])
def test_retrieve_sequence_ids_matches_jax(tmp_path, regex):
    f = tmp_path / "a.fasta"
    f.write_text(HEADERS)
    with open(f) as a, open(f) as b:
        got = ids.retrieve_sequence_ids(a, regex=regex)
        want = jax_ids.retrieve_sequence_ids(b, regex=regex)
    assert got[0] == want[0]
    assert dict(got[1]) == dict(want[1])
    if regex is None:
        assert got[0][:4] == ["P12345", "Q99999", "P55555", "P1"]
        assert len(got[1]["P1"]) == 2


def test_ena_tables_match_jax(ena_setup, tmp_path):
    ali, mapping, locations = ena_setup
    pairs = ena.extract_cds_ids(ali, mapping)
    assert pairs == jax_ena.extract_cds_ids(ali, mapping)
    assert ("P1", "cds1") in pairs and ("P2", "cds3") in pairs
    table = ena.extract_embl_annotation(pairs, locations,
                                        str(tmp_path / "out.csv"))
    pd.testing.assert_frame_equal(table, jax_ena.extract_embl_annotation(
        pairs, locations, str(tmp_path / "out.csv")))
    assert set(table.cds) == {"cds1", "cds3"}
    expanded = ena.add_full_header(table, ali)
    pd.testing.assert_frame_equal(expanded,
                                  jax_ena.add_full_header(table, ali))
    assert set(expanded.full_id) == {"UniRef100_P1/1-4", "UniRef100_P2/1-4"}


def test_family_size_table_matches_jax(tmp_path):
    pfam_full = tmp_path / "Pfam-A.full.gz"
    with gzip.open(pfam_full, "wt") as f:
        for ac, name, n in (("PF00001.21", "fam1", 100),
                            ("PF00002.5", "fam2", 50),
                            ("PF00003.1", "fam3", 7)):
            f.write("# STOCKHOLM 1.0\n#=GF AC   {}\n#=GF ID   {}\n"
                    "#=GF SQ   {}\n//\n".format(ac, name, n))
    got = pfam.create_family_size_table(str(pfam_full),
                                        str(tmp_path / "a.csv"))
    want = jax_pfam.create_family_size_table(str(pfam_full),
                                             str(tmp_path / "b.csv"))
    pd.testing.assert_frame_equal(got, want)
    assert open(tmp_path / "a.csv").read() == open(tmp_path / "b.csv").read()
    assert dict(zip(got.pfam_id, got.num_seqs))["PF00001"] == 100


def _hits():
    return pd.DataFrame({
        "query_name": ["q1"] * 5 + ["q2"],
        "pfam_id": ["PF00001", "PF00002", "PF00003", "PF00004", "PF00005",
                    "PF00002"],
        "clan_id": ["CL0001", "CL0001", None, "CL0001", "CL0001", "CL0001"],
        "ali_from": [10, 20, 5, 200, 75, 20],
        "ali_to": [80, 90, 50, 280, 210, 90],
        "domain_score": [50.0, 30.0, 10.0, 7.0, 7.0, 30.0],
    })


def test_remove_clan_overlaps_matches_jax():
    got = pfam.remove_clan_overlaps(_hits())
    pd.testing.assert_frame_equal(got, jax_pfam.remove_clan_overlaps(_hits()))
    assert list(got.pfam_id) == ["PF00001", "PF00003", "PF00004", "PF00002"]


@pytest.mark.parametrize("resolve", [True, False])
def test_pfam_hits_match_jax(tmp_path, resolve):
    """pfam_hits through a fake hmmscan (prepared domain table, hits of
    one clan overlapping), clan and size tables attached."""
    dom = sf.hit_tables([("PF00001.21", 300, 10, 80, 50.0),
                         ("PF00002.5", 250, 20, 90, 30.0),
                         ("PF00003.1", 120, 100, 150, 12.5)], "q1", 160)[1]
    prepared = tmp_path / "prepared.dom"
    prepared.write_text(dom.replace(" - 300", " PF00001.21 300")
                        .replace(" - 250", " PF00002.5 250")
                        .replace(" - 120", " PF00003.1 120"))
    hmmscan = sf._script(tmp_path / "hmmscan", (
        "args=(\"$@\")\n"
        "for ((k=0; k<$#; k++)); do\n"
        "  case \"${args[k]}\" in\n"
        "    --domtblout) cp " + str(prepared) + " \"${args[k+1]}\";;\n"
        "    -o|--tblout|--pfamtblout) echo x > \"${args[k+1]}\";;\n"
        "  esac\n"
        "done\n"))
    query = tmp_path / "q.fa"
    query.write_text(">q1\n" + "A" * 160 + "\n")
    (tmp_path / "Pfam-A.hmm").write_text("HMMER3/f\n")
    clans = tmp_path / "clans.tsv"
    clans.write_text("PF00001\tCL0001\tclan1\tfam1\tone\n"
                     "PF00002\tCL0001\tclan1\tfam2\ttwo\n"
                     "PF00003\t\t\tfam3\tthree\n")
    sizes = tmp_path / "sizes.csv"
    sizes.write_text("pfam_id,num_seqs\nPF00001,100\nPF00002,50\n"
                     "PF00003,7\n")
    out = {}
    for tag, module in (("torch", pfam), ("jax", jax_pfam)):
        out[tag] = module.pfam_hits(
            str(query), str(tmp_path / "Pfam-A.hmm"),
            str(tmp_path / tag / "scan"), str(clans), str(sizes),
            resolve_overlaps=resolve, binary=hmmscan)
    pd.testing.assert_frame_equal(out["torch"], out["jax"])
    want = (["PF00001", "PF00003"] if resolve
            else ["PF00001", "PF00002", "PF00003"])
    assert list(out["torch"].pfam_id) == want
    with pytest.raises(ValueError, match="clan_table_file"):
        pfam.pfam_hits(str(query), str(tmp_path / "Pfam-A.hmm"),
                       str(tmp_path / "x"), None, None)


def test_align_package_star_exports_as_jax():
    want = {n for n in vars(jax_align_package) if not n.startswith("_")}
    got = {n for n in vars(align_package) if not n.startswith("_")}
    # the JAX package's own imports (jax, its helpers) aside, every public
    # name of the JAX align package is one of the port's
    for name in ("Alignment", "read_fasta", "frequencies",
                 "num_cluster_members", "run_jackhmmer", "run_hhfilter",
                 "read_hmmer_domtbl", "pfam_hits", "remove_clan_overlaps",
                 "standard", "jackhmmer_search", "hmmbuild_and_search",
                 "existing", "search_thresholds", "extract_cds_ids",
                 "add_full_header", "PROTOCOLS", "run"):
        assert name in want and name in got, name
    defined = {n for n in want
               if getattr(getattr(jax_align_package, n), "__module__", "")
               .startswith("evcouplings_tpu.align")}
    assert defined <= got, defined - got
