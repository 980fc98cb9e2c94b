"""The port's search protocols and tool wrappers (evcouplings_torch/align/
{tools,protocol}.py) against the JAX package's, with the fake binaries of
tests/test_align_search.py (bash scripts that keep the CLI contract and
write prepared outputs) and of tests/search_fixtures.py.

Every case runs through both packages on the same inputs, each under its
own root. Exactly equal: the command lines the wrappers build, the
outcfgs apart from the root of their paths, and every file an outcfg
names, as bytes (with each root replaced by a placeholder: the statistics
CSV and the saved search outcfgs hold absolute paths), which includes the
focus .a2m, the identities, frequencies, statistics and sequence-weight
(num_cluster_members) CSVs.
"""

import os

import pandas as pd
import pytest
import torch

import search_fixtures as sf
from evcouplings_tpu.align import protocol as jax_protocol
from evcouplings_tpu.align import tools as jax_tools
from evcouplings_tpu.align.alignment import Alignment as JaxAlignment
from evcouplings_tpu.utils.system import ExternalToolError as JaxToolError
from evcouplings_torch import BailoutException
from evcouplings_torch.align import protocol, tools
from evcouplings_torch.align.alignment import Alignment
from evcouplings_torch.utils.config import (
    InvalidParameterError, MissingParameterError,
)
from evcouplings_torch.utils.system import ExternalToolError, ResourceError
from test_align_search import (  # noqa: F401 (fixtures)
    HMMSEARCH_STO, QUERY_SEQ, STOCKHOLM, fake_jackhmmer, make_kwargs,
    seq_and_db,
)

SIDES = {"torch": (protocol, {"device": "cpu"}),
         "jax": (jax_protocol, {})}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _relative(value, root):
    if isinstance(value, str) and value.startswith(root):
        return os.path.relpath(value, root)
    if isinstance(value, (list, tuple)):
        return [_relative(v, root) for v in value]
    if isinstance(value, dict):
        return {k: _relative(v, root) for k, v in value.items()}
    return value


def _text(path, root):
    with open(path) as f:
        return f.read().replace(root, "<root>")


def assert_same_outputs(got, want, got_root, want_root, min_files=1):
    """Outcfgs equal apart from their roots, and the files they name
    equal as text with each root replaced; returns the files compared."""
    assert _relative(got, got_root) == _relative(want, want_root)
    compared = 0
    for key, value in got.items():
        if isinstance(value, str) and os.path.isfile(value):
            assert _text(value, got_root) == _text(want[key], want_root), key
            compared += 1
    assert compared >= min_files, compared
    return compared


def run_both(tmp_path, name, kwargs_for):
    """protocol `name` through both packages; kwargs_for(root) gives its
    settings with outputs under root."""
    out = {}
    for tag, (module, extra) in SIDES.items():
        root = str(tmp_path / tag)
        out[tag] = (root, module.run(protocol=name, **kwargs_for(root),
                                     **extra))
    return out


# --- the wrappers -----------------------------------------------------------

RECORDER = """args=("$@")
printf '%s\\n' "$@" > {record}
for ((k=0; k<$#; k++)); do
  case "${{args[k]}}" in
    -A|-o|--tblout|--domtblout|--pfamtblout) echo x > "${{args[k+1]}}";;
    *.hmm) echo x > "${{args[k]}}";;
  esac
done
"""


def _wrapper_cases(root, binary):
    query, db = root + "/q.fa", root + "/db.fa"
    prefix = root + "/out/run"
    return {
        "jackhmmer bitscores": lambda t: t.run_jackhmmer(
            query, db, prefix, True, "11.0", "12.0", iterations=3,
            nobias=True, cpu=2, checkpoints_hmm=True, checkpoints_ali=True,
            binary=binary),
        "jackhmmer evalues": lambda t: t.run_jackhmmer(
            query, db, prefix, False, "1E-3", "1E-2", binary=binary),
        "hmmbuild": lambda t: t.run_hmmbuild(
            query, prefix, cpu=1, symfrac=0.0, binary=binary),
        "hmmsearch": lambda t: t.run_hmmsearch(
            query, db, prefix, False, "1E-5", "1E-4", nobias=False, cpu=4,
            binary=binary),
        "hmmscan model cutoffs": lambda t: t.run_hmmscan(
            query, db, prefix, threshold_type="cut_tc", binary=binary),
        "hmmscan thresholds": lambda t: t.run_hmmscan(
            query, db, prefix, use_model_threshold=False,
            domain_threshold=10, seq_threshold=20, cpu=1, binary=binary),
        "hhfilter": lambda t: t.run_hhfilter(
            query, root + "/out/filtered.a3m", threshold=90,
            columns="first", binary=binary),
    }


@pytest.mark.parametrize("case", list(_wrapper_cases("", "")))
def test_wrapper_command_lines_match_jax(tmp_path, case):
    seen = {}
    for tag, module in (("torch", tools), ("jax", jax_tools)):
        root = tmp_path / tag
        root.mkdir()
        for name in ("q.fa", "db.fa"):
            (root / name).write_text(">q\nMKT\n")
        record = root / "argv.txt"
        binary = sf._script(root / "tool", RECORDER.format(record=record))
        result = _wrapper_cases(str(root), binary)[case](module)
        seen[tag] = (_relative(list(result) if isinstance(result, tuple)
                               else result, str(root)),
                     _text(record, str(root)))
    assert seen["torch"] == seen["jax"]


@pytest.mark.parametrize("case", list(_wrapper_cases("", "")))
def test_missing_binary_raises(tmp_path, case):
    for name in ("q.fa", "db.fa"):
        (tmp_path / name).write_text(">q\nMKT\n")
    for module, error in ((tools, ExternalToolError),
                          (jax_tools, JaxToolError)):
        with pytest.raises(error):
            _wrapper_cases(str(tmp_path), "/nonexistent/tool")[case](module)


def test_wrapper_produces_result_files(fake_jackhmmer, seq_and_db,
                                       tmp_path):
    query, db = seq_and_db
    result = tools.run_jackhmmer(
        query, db, str(tmp_path / "out" / "search"), use_bitscores=True,
        domain_threshold=0.5, seq_threshold=0.5, binary=fake_jackhmmer)
    assert open(result.alignment).read() == STOCKHOLM
    assert os.path.isfile(result.domtblout)


def test_empty_output_raises_resource_error(seq_and_db, tmp_path):
    query, db = seq_and_db
    silent = sf._script(tmp_path / "jackhmmer", "exit 0\n")
    with pytest.raises(ResourceError, match="jackhmmer returned empty"):
        tools.run_jackhmmer(query, db, str(tmp_path / "x"), True, 1, 1,
                            binary=silent)


def test_hmmer_tables_match_jax(tmp_path):
    hits = [("sp|P1|A_B", 120, 3, 90, 88.5), ("tr|Q9|C_D", 80, 1, 80, 40.0)]
    tbl, dom = sf.hit_tables(hits, "TARGET", 90)
    (tmp_path / "t.tbl").write_text(tbl)
    (tmp_path / "t.dom").write_text(dom)
    for reader in ("read_hmmer_tbl", "read_hmmer_domtbl"):
        path = str(tmp_path / ("t.tbl" if reader.endswith("_tbl")
                               else "t.dom"))
        got = getattr(tools, reader)(path)
        pd.testing.assert_frame_equal(got, getattr(jax_tools, reader)(path))
        assert list(got.target_name) == ["sp|P1|A_B", "tr|Q9|C_D"]


# --- the sequence helpers ---------------------------------------------------

@pytest.mark.parametrize("args", [
    (True, 0.5, 0.3, 100), (True, None, 0.3, 37), (True, 25, "30", 10),
    (False, 3, 5, 10), (False, None, 1e-4, 10), (False, "1e-3", None, 10),
])
def test_search_thresholds_match_jax(args):
    if args[2] is None:
        for module, error in ((protocol, MissingParameterError),
                              (jax_protocol, Exception)):
            with pytest.raises(error):
                module.search_thresholds(*args)
        return
    assert protocol.search_thresholds(*args) == \
        jax_protocol.search_thresholds(*args)


@pytest.mark.parametrize("region,first_index", [
    (None, None), (None, 5), ((5, 15), None), ((7, 12), 3), ((1, 30), 1),
])
def test_cut_sequence_matches_jax(tmp_path, region, first_index):
    out = {}
    for tag, module in (("torch", protocol), ("jax", jax_protocol)):
        path = str(tmp_path / (tag + ".fa"))
        try:
            result = module.cut_sequence(QUERY_SEQ, "TARGET", region,
                                         first_index, path)
        except Exception as e:          # both must refuse alike
            out[tag] = type(e).__name__
            continue
        out[tag] = (result, open(path).read())
    if region == (1, 30):
        assert out["torch"] == "InvalidParameterError"
        assert out["jax"] == "InvalidParameterError"
    assert out["torch"] == out["jax"]


def test_fetch_sequence_reads_a_local_file(seq_and_db, tmp_path):
    seq_file, _ = seq_and_db
    got = protocol.fetch_sequence("TARGET", seq_file, "http://x/{}",
                                  str(tmp_path / "a.fa"))
    want = jax_protocol.fetch_sequence("TARGET", seq_file, "http://x/{}",
                                       str(tmp_path / "b.fa"))
    assert got[1] == want[1] == ("TARGET", QUERY_SEQ)
    with pytest.raises(ResourceError):
        protocol.fetch_sequence("TARGET", str(tmp_path / "absent.fa"),
                                "http://x/{}", str(tmp_path / "c.fa"))


# --- the protocols ----------------------------------------------------------

def _standard_kwargs(tmp_path, fake_jackhmmer, seq_and_db, **extra):
    seq_file, db_file = seq_and_db

    def kwargs_for(root):
        return make_kwargs(tmp_path, fake_jackhmmer, seq_file, db_file,
                           prefix=os.path.join(root, "run", "job"), **extra)
    return kwargs_for


@pytest.mark.parametrize("extra", [{}, {"compute_num_effective_seqs": False,
                                        "extract_annotation": False}])
def test_standard_protocol_matches_jax(tmp_path, fake_jackhmmer, seq_and_db,
                                       extra):
    out = run_both(tmp_path, "standard", _standard_kwargs(
        tmp_path, fake_jackhmmer, seq_and_db, **extra))
    (got_root, got), (want_root, want) = out["torch"], out["jax"]
    assert assert_same_outputs(got, want, got_root, want_root) >= 8
    ali = Alignment.from_path(got["alignment_file"])
    assert (ali.N, ali.L) == (4, len(QUERY_SEQ))
    assert got["focus_sequence"] == "TARGET/1-22"
    assert got["num_sites"] == len(QUERY_SEQ)
    if extra:
        assert got["effective_sequences"] is None
        assert "annotation_file" not in got
    else:
        assert got["effective_sequences"] > 0
        weights = pd.read_csv(got["sequence_weights_file"])
        pd.testing.assert_frame_equal(
            weights, pd.read_csv(want["sequence_weights_file"]),
            check_exact=True)
        assert len(pd.read_csv(got["annotation_file"])) == 4


def test_reuse_alignment_skips_search(tmp_path, fake_jackhmmer, seq_and_db):
    kwargs_for = _standard_kwargs(tmp_path, fake_jackhmmer, seq_and_db)
    first = run_both(tmp_path, "standard", kwargs_for)

    # a second run with a broken binary must restart from the saved
    # search outcfg and not call it
    def again(root):
        return dict(kwargs_for(root), reuse_alignment=True,
                    jackhmmer="/nonexistent/jackhmmer")
    out = run_both(tmp_path, "standard", again)
    (got_root, got), (want_root, want) = out["torch"], out["jax"]
    assert assert_same_outputs(got, want, got_root, want_root) >= 8
    assert _relative(got, got_root) == _relative(first["torch"][1], got_root)


def test_region_cut(tmp_path, fake_jackhmmer, seq_and_db):
    out = run_both(tmp_path, "jackhmmer_search", _standard_kwargs(
        tmp_path, fake_jackhmmer, seq_and_db, region=(5, 15)))
    (got_root, got), (want_root, want) = out["torch"], out["jax"]
    assert assert_same_outputs(got, want, got_root, want_root) >= 4
    assert QUERY_SEQ[4:15] in open(got["target_sequence_file"]).read()
    assert got["segments"][0][3:5] == [5, 15]


def test_standard_bails_out_without_homologs(tmp_path, seq_and_db):
    seq_file, db_file = seq_and_db
    sto, tbl, dom = sf.write_outputs(
        str(tmp_path), "alone", sf.stockholm([("TARGET/1-22", QUERY_SEQ)]),
        [], "TARGET", 22)
    binary = sf.fake_search(tmp_path / "jackhmmer",
                            {db_file: (sto, tbl, dom)})
    kwargs = make_kwargs(tmp_path, binary, seq_file, db_file,
                         prefix=str(tmp_path / "run" / "job"))
    with pytest.raises(BailoutException, match="No sequences"):
        protocol.run(protocol="standard", device="cpu", **kwargs)
    assert os.path.isfile(str(tmp_path / "run" / "job.align_standard.outcfg"))


FOCUS = {"TARGET/1-8": "MKTAYIAK", "h1": "MKSAYIGK", "h2": "MRTAYLAK",
         "h3": "MKTAYIAK"}


@pytest.mark.parametrize("drop", [["h3"], ["h1", "h2"]])
def test_seqid_filter_runs_hhfilter(tmp_path, drop):
    """seqid_filter routes through run_hhfilter (tests/test_align_search.py
    TestSeqidFilter); the fake drops named records, so the filter's effect
    is observable."""
    hhfilter = sf.fake_hhfilter(tmp_path / "hhfilter", drop)
    out = {}
    for tag, module, ali in (
            ("torch", protocol, Alignment.from_dict(FOCUS, device="cpu")),
            ("jax", jax_protocol, JaxAlignment.from_dict(FOCUS))):
        root = str(tmp_path / tag)
        out[tag] = (root,) + module.modify_alignment(
            ali, 0, "TARGET", 1, prefix=root + "/job", seqid_filter=95,
            hhfilter=hhfilter, minimum_sequence_coverage=0,
            minimum_column_coverage=0, compute_num_effective_seqs=True,
            theta=0.8)
    (got_root, got, got_ali), (want_root, want, want_ali) = (
        out["torch"], out["jax"])
    assert got_ali.N == want_ali.N == 4 - len(drop)
    assert list(got_ali.ids) == list(want_ali.ids)
    assert got_ali.device == "cpu"
    assert assert_same_outputs(got, want, got_root, want_root) >= 6
    for name in ("_filtered.a3m", "_raw_focus_filtered.fasta"):
        assert _text(got_root + "/job" + name, got_root) == \
            _text(want_root + "/job" + name, want_root)


def _hmmsearch_kwargs(tmp_path, seq_and_db, sto_text=HMMSEARCH_STO,
                      header="TARGET/1-8", first_index=1):
    _, db_file = seq_and_db
    outputs = sf.write_outputs(str(tmp_path), "hits", sto_text,
                               [("hitA", 8, 1, 8, 50.0)], "TARGET", 8)
    hmmbuild = sf.fake_hmmbuild(tmp_path / "hmmbuild")
    hmmsearch = sf.fake_search(tmp_path / "hmmsearch", {db_file: outputs})
    input_ali = tmp_path / "input.fasta"
    input_ali.write_text(">{}\nMKTAYIAK\n>other\nMKSAYIGK\n".format(header))

    def kwargs_for(root):
        return dict(
            prefix=os.path.join(root, "run", "hb"), sequence_id="TARGET",
            alignment_file=str(input_ali), first_index=first_index,
            use_bitscores=True, domain_threshold=0.3,
            sequence_threshold=0.3, database="seqdb", seqdb=db_file, cpu=1,
            nobias=False, reuse_alignment=False, hmmbuild=hmmbuild,
            hmmsearch=hmmsearch, extract_annotation=False,
            seqid_filter=None, hhfilter=None, minimum_sequence_coverage=0,
            minimum_column_coverage=0, compute_num_effective_seqs=False,
            theta=0.8)
    return kwargs_for


@pytest.mark.parametrize("header,first_index,want_region", [
    ("TARGET/1-8", 1, (1, 8)), ("TARGET/5-12", 1, (5, 12)),
    ("TARGET", 3, (3, 10))])
def test_hmmbuild_and_search_matches_jax(tmp_path, seq_and_db, header,
                                         first_index, want_region):
    """The header's range wins over first_index (prefer_header)."""
    out = run_both(tmp_path, "hmmbuild_and_search", _hmmsearch_kwargs(
        tmp_path, seq_and_db, header=header, first_index=first_index))
    (got_root, got), (want_root, want) = out["torch"], out["jax"]
    assert assert_same_outputs(got, want, got_root, want_root) >= 5
    raw = Alignment.from_path(got["raw_focus_alignment_file"], "fasta")
    assert raw.N == 4 and "".join(raw[0]) == "MKTAYIAK"
    assert got["focus_sequence"] == "TARGET/{}-{}".format(*want_region)
    assert got["segments"][0][3:5] == list(want_region)


def test_hmmsearch_result_needs_rf_columns(tmp_path, seq_and_db):
    bad = HMMSEARCH_STO.replace("#=GC RF xxxxxxxx", "#=GC RF xxxxxx..")
    kwargs = _hmmsearch_kwargs(tmp_path, seq_and_db, sto_text=bad)(
        str(tmp_path / "torch"))
    with pytest.raises(ValueError, match="one-to-one"):
        protocol.hmmbuild_and_search(**kwargs)


def test_complex_protocol_names_its_item(tmp_path):
    """The complex protocol (ROADMAP A19c) is ported: `existing` inside
    it, then the genome-location table from seeded UniProt-to-EMBL and
    ENA tables (tests/complex_fixtures.py), equal to the JAX package's
    outputs byte for byte; with override_annotation_file, the annotation
    table is the override's. An unknown inner or outer protocol raises."""
    import complex_fixtures as cf

    cf.write_monomers(str(tmp_path))
    embl, ena = str(tmp_path / "embl.txt"), str(tmp_path / "ena.tsv")
    kinds = cf.write_genome_tables(
        embl, ena, ["a{}".format(k) for k in range(cf.N)],
        ["b{}".format(k) for k in range(cf.N)])

    def kwargs_for(override):
        def settings(root):
            return dict(
                prefix=os.path.join(root, "c"), alignment_protocol="existing",
                input_alignment=str(tmp_path / "m1.fasta"), sequence_id="T1",
                first_index=None, extract_annotation=False,
                override_annotation_file=override, seqid_filter=None,
                hhfilter=None, minimum_sequence_coverage=50,
                minimum_column_coverage=0, compute_num_effective_seqs=True,
                theta=0.8, uniprot_to_embl_table=embl,
                ena_genome_location_table=ena)
        return settings

    for override in (None, str(tmp_path / "anno1.csv")):
        out = run_both(tmp_path / str(override is None), "complex",
                       kwargs_for(override))
        (got_root, got), (want_root, want) = out["torch"], out["jax"]
        assert assert_same_outputs(got, want, got_root, want_root) >= 7
        locations = pd.read_csv(got["genome_location_file"])
        assert len(locations) == cf.N - len(kinds["missing"]) - len(
            kinds["ambiguous"])
        assert ("annotation_file" in got) == (override is not None)
    with pytest.raises(InvalidParameterError, match="alignment protocol"):
        protocol.run(protocol="complex", **dict(
            kwargs_for(None)(str(tmp_path / "bad")),
            alignment_protocol="nope"), device="cpu")
    with pytest.raises(InvalidParameterError):
        protocol.run(protocol="nope")
