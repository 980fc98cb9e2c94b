"""The port's alignment container (evcouplings_torch/align/alignment.py)
against the JAX package's on the same files: format detection, the
pure-Python fasta/a2m/a3m/Stockholm readers, the writers, the string
operations, and the numeric members on the CPU.

Tolerances: integer outputs (cluster counts, identity counts) and
everything string-valued must be exactly equal; frequencies agree to
atol 1e-6 (both sides sum float32 in different orders, then normalize),
and conservation to atol 1e-5 (entropy of those frequencies).
"""

import io
import os

import numpy as np
import pytest

from evcouplings_tpu.align import alignment as jax_aln
from evcouplings_torch.align import alignment as aln

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(os.path.dirname(HERE), "examples", "data")
DEMOS = ["demo_monomer.a2m", "demo_chain_a.a2m", "demo_chain_b.a2m"]

STOCKHOLM = """# STOCKHOLM 1.0
#=GF ID   TEST_FAMILY
#=GF DE   a small test family
#=GS seqA/1-12 DE first sequence n=3 Tax=Homo RepID=A_HUMAN
#=GS seqB/3-14 DE second sequence
seqA/1-12     ACDEF-GHIKLM
seqB/3-14     ACDQF-GHIRLM
#=GR seqA/1-12 SS HHHH--EEEECC
seqC/2-11     A-DEFWGH-KLM
#=GC SS_cons  HHHH--EEEECC

seqA/1-12     NPQR
seqB/3-14     NPQK
#=GR seqA/1-12 SS CCHH
seqC/2-11     N-QR
#=GC SS_cons  CCHH
//
"""

A3M = """>target/1-10
ACDefGHIKLmn
>hit1
ACDGHIKL
>hit2
AC-qGHIkK-
>hit3
-CDGHwIKLy
"""


def _demo(name):
    return os.path.join(DATA, name)


def _both_from_text(text, fmt, **kw):
    return (aln.Alignment.from_file(io.StringIO(text), fmt, **kw),
            jax_aln.Alignment.from_file(io.StringIO(text), fmt, **kw))


def _same_container(got, want):
    np.testing.assert_array_equal(got.matrix, want.matrix)
    assert list(got.ids) == list(want.ids)
    assert (got.N, got.L) == (want.N, want.L)


@pytest.mark.parametrize("text,path,fmt", [
    (STOCKHOLM, "x.sto", "stockholm"),
    (A3M, "x.a3m", "a3m"),
    (A3M, "x.a2m", "fasta"),
    ("; comment\n\n>a\nAC\n", "x.fa", "fasta"),
    ("not an alignment\n", "x.txt", None),
])
def test_detect_format_matches_jax(text, path, fmt):
    got = aln.detect_format(io.StringIO(text), filepath=path)
    assert got == jax_aln.detect_format(io.StringIO(text), filepath=path)
    assert got == fmt


@pytest.mark.parametrize("name", DEMOS)
def test_fasta_reader_matches_jax(name):
    with open(_demo(name)) as f:
        got = list(aln.read_fasta(f))
    with open(_demo(name)) as f:
        assert got == list(jax_aln.read_fasta(f))
    ours = aln.Alignment.from_path(_demo(name), device="cpu")
    with open(_demo(name)) as f:
        # the JAX package's Python reader (from_path may take its C one)
        theirs = jax_aln.Alignment.from_file(f, "fasta")
    _same_container(ours, theirs)


@pytest.mark.parametrize("inserts", ["first", "delete"])
def test_a3m_reader_matches_jax(inserts):
    got, want = _both_from_text(A3M, "a3m", a3m_inserts=inserts)
    _same_container(got, want)
    with pytest.raises(ValueError):
        aln.read_a3m(io.StringIO(A3M), inserts="keep")


def test_stockholm_reader_matches_jax():
    got, want = _both_from_text(STOCKHOLM, "stockholm")
    _same_container(got, want)
    for ns in ("GF", "GC", "GS", "GR"):
        assert got.annotation[ns] == want.annotation[ns], ns
    blocks = list(aln.read_stockholm(io.StringIO(STOCKHOLM * 2)))
    assert len(blocks) == 2
    with pytest.raises(ValueError, match="Header missing"):
        next(aln.read_stockholm(io.StringIO(">a\nAC\n")))
    prefixed = STOCKHOLM.replace(
        "#=GF ID", aln.HMMER_PREFIX_WARNING + "\n#=GF ID")
    with pytest.raises(ValueError, match="HMMER"):
        next(aln.read_stockholm(io.StringIO(prefixed)))


@pytest.mark.parametrize("text,name", [(STOCKHOLM, "family.sto"),
                                       (A3M, "family.a3m")])
def test_from_path_detects_the_format(tmp_path, text, name):
    path = tmp_path / name
    path.write_text(text)
    ours = aln.Alignment.from_path(str(path), device="cpu")
    fmt = jax_aln.detect_format(io.StringIO(text), filepath=name)
    _same_container(ours, jax_aln.Alignment.from_file(io.StringIO(text),
                                                      fmt))
    # an a3m file read as fasta is ragged: both packages refuse it
    if name.endswith(".a3m"):
        with pytest.raises(ValueError, match="differing lengths"):
            aln.Alignment.from_path(str(path), format="fasta")


@pytest.mark.parametrize("fmt", ["fasta", "a3m", "aln"])
def test_writers_match_jax(fmt):
    got, want = _both_from_text(A3M, "a3m")
    out_got, out_want = io.StringIO(), io.StringIO()
    got.write(out_got, fmt, width=5)
    want.write(out_want, fmt, width=5)
    assert out_got.getvalue() == out_want.getvalue()
    with pytest.raises(ValueError):
        got.write(io.StringIO(), "stockholm")


@pytest.fixture(scope="module")
def demo_pair():
    ours = aln.Alignment.from_path(_demo("demo_monomer.a2m"), device="cpu")
    with open(_demo("demo_monomer.a2m")) as f:
        theirs = jax_aln.Alignment.from_file(f, "fasta")
    return ours, theirs


def test_string_operations_match_jax(demo_pair):
    ours, theirs = demo_pair
    cols = np.zeros(ours.L, dtype=bool)
    cols[[0, 3, 7, 29]] = True
    rows = np.arange(0, ours.N, 3)
    for axis in ("pos", "seq"):
        for norm in (True, False):
            np.testing.assert_array_equal(ours.count("-", axis, norm),
                                          theirs.count("-", axis, norm))
    _same_container(ours.select(columns=cols, sequences=rows),
                    theirs.select(columns=cols, sequences=rows))
    _same_container(ours.lowercase_columns(cols),
                    theirs.lowercase_columns(cols))
    _same_container(ours.replace("A", "x", sequences=rows),
                    theirs.replace("A", "x", sequences=rows))
    assert ours.select(columns=cols).device == "cpu"
    np.testing.assert_array_equal(
        aln.map_matrix(ours.matrix, ours.alphabet_map),
        jax_aln.map_matrix(theirs.matrix, theirs.alphabet_map))
    np.testing.assert_array_equal(ours["seq7"], theirs["seq7"])
    np.testing.assert_array_equal(ours[5], theirs[5])
    with pytest.raises(KeyError):
        ours["no such id"]


@pytest.mark.parametrize("theta", [0.8, 0.5])
def test_set_weights_counts_equal_jax(demo_pair, theta):
    ours, theirs = demo_pair
    lowered = ours.lowercase_columns(np.arange(ours.L) % 7 == 0)
    ours.set_weights(theta)
    theirs.set_weights(theta)
    np.testing.assert_array_equal(ours.num_cluster_members,
                                  theirs.num_cluster_members)
    np.testing.assert_array_equal(ours.weights, theirs.weights)
    # lowercase columns map to the gap code on both sides
    lowered.set_weights(theta, device="cpu")
    lowered_j = theirs.lowercase_columns(np.arange(ours.L) % 7 == 0)
    lowered_j.set_weights(theta)
    np.testing.assert_array_equal(lowered.num_cluster_members,
                                  lowered_j.num_cluster_members)


def test_numeric_members_match_jax(demo_pair):
    ours, theirs = demo_pair
    ours.set_weights(0.8)
    theirs.set_weights(0.8)
    np.testing.assert_allclose(ours.frequencies, theirs.frequencies,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.pair_frequencies,
                               theirs.pair_frequencies, rtol=0, atol=1e-6)
    for norm in (True, False):
        np.testing.assert_allclose(ours.conservation(norm),
                                   theirs.conservation(norm),
                                   rtol=0, atol=1e-5)
    for target in (ours[0], ours[17], "".join(ours[3][::-1])):
        for norm in (True, False):
            np.testing.assert_array_equal(
                ours.identities_to(target, norm),
                theirs.identities_to(target, norm))


def test_numeric_members_need_a_device(monkeypatch, demo_pair):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with open(_demo("demo_monomer.a2m")) as f:
        fresh = aln.Alignment.from_file(f, "fasta")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fresh.set_weights(0.8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fresh.frequencies
    # a device given for the call wins over the container's
    fresh.set_weights(0.8, device="cpu")
    np.testing.assert_array_equal(fresh.num_cluster_members,
                                  demo_pair[1].num_cluster_members)
