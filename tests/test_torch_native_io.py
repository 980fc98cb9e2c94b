"""The port's C alignment readers (evcouplings_torch/native, csrc/
fasta_io.c and stockholm_io.c) on every case of tests/test_native_io.py:
the C readers against the port's own Python readers (ids, matrix,
annotation: exactly equal), the port's Alignment.from_path against the
JAX package's (exactly equal), the strict input guard and the fallback
to the Python reader, the readers' exceptions, the build key of their
header, and the refusal to swap in the Python reader where the C readers
cannot be built.
"""

import os
import shutil

import numpy as np
import pytest

from evcouplings_tpu.align.alignment import Alignment as JaxAlignment
from evcouplings_torch.align import alignment as port_alignment
from evcouplings_torch.align.alignment import (
    Alignment, read_fasta, read_stockholm,
)
from evcouplings_torch.kernels import _build
from evcouplings_torch.native import (
    HAVE_NATIVE, HAVE_NATIVE_STOCKHOLM, _parse_fasta, parse_fasta_native,
    parse_stockholm_native,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plain(annotation):
    """Nested (Default)OrderedDicts as plain dicts."""
    if isinstance(annotation, dict):
        return {k: _plain(v) for k, v in annotation.items()}
    return annotation


def assert_same_alignment(got, want):
    assert list(got.ids) == list(want.ids)
    assert got.matrix.dtype == want.matrix.dtype
    assert got.matrix.shape == want.matrix.shape
    assert (got.matrix == want.matrix).all()
    assert _plain(got.annotation) == _plain(want.annotation)


def check_fasta(path):
    """The C reader against the port's Python reader, and from_path
    against the JAX package's."""
    ids, mat = parse_fasta_native(str(path))
    with open(path) as f:
        items = list(read_fasta(f))
    assert ids == [i for i, _ in items]
    want = np.array([list(s) for _, s in items], dtype="U1")
    assert mat.shape == want.shape and (mat == want).all()
    assert_same_alignment(Alignment.from_path(str(path), device="cpu"),
                          JaxAlignment.from_path(str(path)))


def check_stockholm(path):
    ids, mat, anno = parse_stockholm_native(str(path))
    with open(path) as f:
        ref = next(read_stockholm(f, read_annotation=True))
    assert ids == list(ref.seqs.keys())
    assert ["".join(r) for r in mat] == list(ref.seqs.values())
    assert _plain(anno) == _plain({"GF": ref.gf, "GC": ref.gc,
                                   "GS": ref.gs, "GR": ref.gr})
    assert_same_alignment(
        Alignment.from_path(str(path), "stockholm", device="cpu"),
        JaxAlignment.from_path(str(path), "stockholm"))


def random_fasta(path):
    """test_native_io.py's random round trip: 97 x 53, wrapped at 17."""
    rng = np.random.default_rng(0)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY-acdefg."))
    N, L = 97, 53
    mat = rng.choice(aa, size=(N, L))
    with open(path, "w") as f:
        for k in range(N):
            f.write(">seq{} OS=Sp{}\n".format(k, k))
            row = "".join(mat[k])
            for j in range(0, L, 17):
                f.write(row[j:j + 17] + "\n")


FASTA_CASES = {
    "basic": b">s1/1-4 desc here\nACDE\n>s2\nWY-k\n",
    "wrapped_lines_and_crlf":
        b">s1\r\nACDE\r\nFGHI\r\n>s2 x\t\r\nKLMN\r\nPQRS\r\n",
    "comment_lines_empty_lines_no_trailing_newline":
        b"; file comment\n>s1\nAC\n\nDE\n;mid\n>s2\nFGH\nI",
    "lowercase_a2m_kept": b">s1\nAc-.E\n>s2\ngY-wk\n",
    "empty_sequences": b">s1\n>s2\n",
    "duplicate_headers": b">s1\nACDE\n>s2\nWYKL\n>s1\nGGGG\n",
}


@pytest.mark.parametrize("name", list(FASTA_CASES))
def test_fasta_cases(name, tmp_path):
    p = tmp_path / "a.fasta"
    p.write_bytes(FASTA_CASES[name])
    if name == "duplicate_headers":
        # the reader keeps both rows; from_path dedups as the Python path
        ids, _ = parse_fasta_native(str(p))
        assert ids == ["s1", "s2", "s1"]
        ali = Alignment.from_path(str(p), device="cpu")
        assert list(ali.ids) == ["s1", "s2"]
        assert "".join(ali.matrix[0]) == "GGGG"
        assert_same_alignment(ali, JaxAlignment.from_path(str(p)))
        return
    check_fasta(p)


def test_fasta_reader_tuples(tmp_path):
    """The raw results: CRLF and tab stripped from headers, wrapped rows
    joined, and zero-length rows legal (L = 0)."""
    p = tmp_path / "a.fasta"
    p.write_bytes(FASTA_CASES["wrapped_lines_and_crlf"])
    ids, mat = parse_fasta_native(str(p))
    assert ids == ["s1", "s2 x"]
    assert ["".join(r) for r in mat] == ["ACDEFGHI", "KLMNPQRS"]
    p.write_bytes(FASTA_CASES["empty_sequences"])
    ids, seq_bytes, n, L = _parse_fasta(str(p))
    assert (ids, seq_bytes, n, L) == (["s1", "s2"], b"", 2, 0)


def test_fasta_random_roundtrip(tmp_path):
    p = tmp_path / "r.fasta"
    random_fasta(p)
    check_fasta(p)


@pytest.mark.parametrize("text,match,error", [
    (">s1\nACDE\n>s2\nWY\n", "Unequal", ValueError),
    ("just text\nno headers\n", "No FASTA", ValueError),
    (None, "nope.fasta", OSError),
], ids=["ragged", "no_records", "missing_file"])
def test_fasta_reader_errors(tmp_path, text, match, error):
    p = tmp_path / "nope.fasta"
    if text is not None:
        p = tmp_path / "a.fasta"
        p.write_text(text)
    with pytest.raises(error, match=match):
        parse_fasta_native(str(p))


@pytest.mark.parametrize("seed", range(12))
def test_fasta_differential(seed, tmp_path):
    """test_native_io.py's structural fuzz: wrap widths, CRLF, comments,
    blank lines, header annotation, trailing newline."""
    rng = np.random.default_rng(1000 + seed)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWYX-acdefg.*"))
    N = int(rng.integers(1, 40))
    L = int(rng.integers(1, 120))
    mat = rng.choice(aa, size=(N, L))

    wrap = int(rng.integers(1, L + 30))
    crlf = bool(rng.integers(2))
    comments = bool(rng.integers(2))
    blanks = bool(rng.integers(2))
    annotate = bool(rng.integers(2))
    trailing_nl = bool(rng.integers(2))
    eol = "\r\n" if crlf else "\n"

    lines = []
    if comments:
        lines.append("; leading comment")
    for k in range(N):
        header = "seq{}/{}-{}".format(k, k + 1, k + L)
        if annotate and rng.integers(2):
            header += " OS=Species{} n={}".format(k, k)
        lines.append(">" + header)
        row = "".join(mat[k])
        for j in range(0, L, wrap):
            lines.append(row[j:j + wrap])
        if blanks and rng.integers(2):
            lines.append("")
    text = eol.join(lines) + (eol if trailing_nl else "")

    p = tmp_path / "fuzz.fasta"
    p.write_bytes(text.encode())
    check_fasta(p)


STOCKHOLM_CASES = {
    "interleaved_blocks_and_annotation": (
        "# STOCKHOLM 1.0\n"
        "#=GF ID family1\n"
        "#=GF AC PF00000\n"
        "#=GS seq1 DE first seq description\n"
        "#=GS seq2 DE second one\n"
        "\n"
        "seq1 ACDE\n"
        "seq2 FGHI\n"
        "#=GR seq1 PP 8899\n"
        "#=GC SS_cons HHHH\n"
        "\n"
        "seq1 KLMN\n"
        "seq2 PQRS\n"
        "#=GR seq1 PP 7766\n"
        "#=GC SS_cons EEEE\n"
        "//\n"),
    "crlf_and_trailing_ws":
        "# STOCKHOLM 1.0\r\nseq1 ACDE  \r\nseq2 -GH.\r\n//\r\n",
    "indented_sequence_lines": (
        "# STOCKHOLM 1.0\n"
        "  seq1  ACDE\n"
        "seq2  FGHI\n"
        "  seq1  KLMN\n"
        "seq2  PQRS\n"
        "//\n"),
    "only_first_alignment":
        "# STOCKHOLM 1.0\nseq1 ACDE\n//\n# STOCKHOLM 1.0\nother WXYZ\n//\n",
    "from_path_uses_annotation": (
        "# STOCKHOLM 1.0\n"
        "#=GS s1 DE my target protein\n"
        "s1 ACDE\ns2 FGHI\n//\n"),
    "plain": "# STOCKHOLM 1.0\ns1  ACDE\ns2  WYKL\n//\n",
}


@pytest.mark.parametrize("name", list(STOCKHOLM_CASES))
def test_stockholm_cases(name, tmp_path):
    p = tmp_path / "a.sto"
    p.write_text(STOCKHOLM_CASES[name])
    check_stockholm(p)
    ids, mat, anno = parse_stockholm_native(str(p))
    if name == "indented_sequence_lines":
        assert ids == ["seq1", "seq2"]
        assert "".join(mat[0]) == "ACDEKLMN"
    elif name == "only_first_alignment":
        assert ids == ["seq1"]
    elif name == "from_path_uses_annotation":
        ali = Alignment.from_path(str(p), "stockholm", device="cpu")
        assert ali.annotation["GS"]["s1"]["DE"] == "my target protein"


@pytest.mark.parametrize("text,match", [
    ("seq1 ACDE\n//\n", "Header missing"),
    ("# STOCKHOLM 1.0\nseq1 ACDE\n", "Truncated"),
    ("# STOCKHOLM 1.0\nseq1 ACDE\nseq2 FG\n//\n", "unequal"),
], ids=["missing_header", "truncated", "ragged"])
def test_stockholm_reader_errors(tmp_path, text, match):
    p = tmp_path / "a.sto"
    p.write_text(text)
    with pytest.raises(ValueError, match=match):
        parse_stockholm_native(str(p))
    with pytest.raises(OSError):
        parse_stockholm_native(str(tmp_path / "nope.sto"))


def test_stockholm_hmmer_prefix_warning(tmp_path):
    """The reader raises on HMMER's prefix warning unless told not to;
    from_path re-raises it instead of falling back, as in JAX."""
    p = tmp_path / "a.sto"
    p.write_text(
        "# STOCKHOLM 1.0\n"
        "# WARNING: seq names have been made unique by adding "
        "a prefix of X\n"
        "seq1 ACDE\n//\n"
    )
    with pytest.raises(ValueError, match="HMMER"):
        parse_stockholm_native(str(p))
    ids, _, _ = parse_stockholm_native(str(p), raise_hmmer_prefixes=False)
    assert ids == ["seq1"]
    for cls in (Alignment, JaxAlignment):
        with pytest.raises(ValueError, match="HMMER added identifier"):
            cls.from_path(str(p), "stockholm")
    assert_same_alignment(
        Alignment.from_path(str(p), "stockholm", raise_hmmer_prefixes=False,
                            device="cpu"),
        JaxAlignment.from_path(str(p), "stockholm",
                               raise_hmmer_prefixes=False))


def test_stockholm_random_interleaved_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY-."))
    N, L, width = 61, 140, 37
    mat = rng.choice(aa, size=(N, L))
    p = tmp_path / "r.sto"
    with open(p, "w") as f:
        f.write("# STOCKHOLM 1.0\n")
        for start in range(0, L, width):
            for k in range(N):
                f.write("sq{}/1-{} {}\n".format(
                    k, L, "".join(mat[k][start:start + width])
                ))
            f.write("\n")
        f.write("//\n")
    check_stockholm(p)


@pytest.mark.parametrize("seed", range(8))
def test_stockholm_differential(seed, tmp_path):
    rng = np.random.default_rng(2000 + seed)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY-."))
    N = int(rng.integers(1, 20))
    L = int(rng.integers(4, 80))
    mat = rng.choice(aa, size=(N, L))
    interleave = bool(rng.integers(2))
    gc_line = bool(rng.integers(2))
    gs_lines = bool(rng.integers(2))
    gr_lines = bool(rng.integers(2))

    ids = ["s{}/1-{}".format(k, L) for k in range(N)]
    body = ["# STOCKHOLM 1.0"]
    if gs_lines:
        for k in range(0, N, 2):
            body.append("#=GS {} DE fuzz description {}".format(ids[k], k))
    n_chunks = 2 if (interleave and L >= 8) else 1
    chunk = -(-L // n_chunks)
    for c in range(n_chunks):
        for k in range(N):
            seq = "".join(mat[k])[c * chunk:(c + 1) * chunk]
            body.append("{}  {}".format(ids[k], seq))
            if gr_lines and k == 0:
                body.append("#=GR {} PP {}".format(ids[k], "*" * len(seq)))
        if gc_line:
            body.append("#=GC RF {}".format("x" * min(chunk, L - c * chunk)))
        if c + 1 < n_chunks:
            body.append("")
    body.append("//")

    p = tmp_path / "fuzz.sto"
    p.write_text("\n".join(body) + "\n")
    check_stockholm(p)


@pytest.mark.parametrize("text,kwargs,fmt", [
    (">s1/1-4 OS=X\nACDE\n>s2/1-4\nWYKL\n", {}, None),
    (">s1/1-4 OS=X\nACDE\n>s2/1-4 OS=Y\nWYKL\n", {"split_header": True},
     None),
    (">s1 a\nACDE\n>s1 b\nWYKL\n>s2\nGGGG\n", {"split_header": True}, None),
    (">s1\nACDE\n>s2\nWYKL\n", {"raise_hmmer_prefixes": False,
                                "a3m_inserts": "first"}, "fasta"),
    (">s1\nACDE\n>s2\nWYkKL\n", {}, "a3m"),
], ids=["matches_from_file", "split_header", "split_header_dedup",
        "from_file_only_kwargs", "ragged_a3m_fallback"])
def test_from_path_matches_jax(tmp_path, text, kwargs, fmt):
    """from_path equals the JAX package's and the port's own from_file on
    an open handle; the device keyword reaches the alignment."""
    p = tmp_path / ("a.a3m" if fmt == "a3m" else "a.fasta")
    p.write_text(text)
    got = Alignment.from_path(str(p), fmt, device="cpu", **kwargs)
    assert got.device == "cpu"
    assert_same_alignment(got, JaxAlignment.from_path(str(p), fmt, **kwargs))
    with open(p) as f:
        assert_same_alignment(got, Alignment.from_file(
            f, fmt or "fasta", **kwargs))


GUARD_CASES = {
    "bare_cr_mid_line": b">a\nAC\rGT\n>b\nAC\rGT\n",
    "form_feed": b">a\nACGT\x0c\n>b\nACGT\x0c\n",
    "vertical_tab": b">a\nAC\x0bGT\n>b\nAC\x0bGT\n",
    "utf8_residue": ">a\nACÄT\n>b\nACÄT\n".encode(),
    "invalid_utf8_header": b">seq\xff1\nACGT\n",
}


@pytest.mark.parametrize("name", list(GUARD_CASES))
def test_guard_raises_and_from_path_falls_back(name, tmp_path, monkeypatch):
    """The C reader refuses each guard input with ValueError; from_path
    then reads it with the Python reader (counted), and answers as the
    JAX package's from_path does (the same alignment, or for the invalid
    UTF-8 header the same UnicodeDecodeError)."""
    p = tmp_path / "g.fasta"
    p.write_bytes(GUARD_CASES[name])
    with pytest.raises(ValueError):
        parse_fasta_native(str(p))

    calls = []

    def counted_read_fasta(fileobj):
        calls.append(1)
        return read_fasta(fileobj)

    monkeypatch.setattr(port_alignment, "read_fasta", counted_read_fasta)
    if name == "invalid_utf8_header":
        for cls in (Alignment, JaxAlignment):
            with pytest.raises(UnicodeDecodeError):
                cls.from_path(str(p), "fasta")
        assert calls == [1]
        return
    got = Alignment.from_path(str(p), "fasta", device="cpu")
    assert calls == [1]
    assert_same_alignment(got, JaxAlignment.from_path(str(p), "fasta"))
    if name == "bare_cr_mid_line":
        # universal newlines split AC\rGT into two lines -> "ACGT"
        assert got.L == 4 and "".join(got.matrix[0]) == "ACGT"


def test_stockholm_guard_falls_back(tmp_path):
    p = tmp_path / "g.sto"
    p.write_bytes(b"# STOCKHOLM 1.0\nseq1\x0cACGT\nseq2 ACGT\n//\n")
    with pytest.raises(ValueError):
        parse_stockholm_native(str(p))
    got = Alignment.from_path(str(p), "stockholm", device="cpu")
    assert got.N == 2
    assert_same_alignment(got, JaxAlignment.from_path(str(p), "stockholm"))


def test_cr_only_file_falls_back(tmp_path):
    p = tmp_path / "cr.fasta"
    p.write_bytes(b">s1\rACDE\r>s2\rWYKL\r")
    got = Alignment.from_path(str(p), "fasta", device="cpu")
    assert got.N == 2 and got.L == 4 and "".join(got.matrix[0]) == "ACDE"
    assert_same_alignment(got, JaxAlignment.from_path(str(p), "fasta"))


def test_in_repo_alignments_match_jax():
    """The golden and example alignments, through both packages."""
    paths = [os.path.join(REPO, "tests", "data", "golden", "golden.a2m")]
    paths += [os.path.join(REPO, "examples", "data", n)
              for n in sorted(os.listdir(os.path.join(REPO, "examples",
                                                      "data")))
              if n.endswith(".a2m")]
    for path in paths:
        assert_same_alignment(Alignment.from_path(path, device="cpu"),
                              JaxAlignment.from_path(path))


def test_native_flags_report_the_c_route():
    assert HAVE_NATIVE and HAVE_NATIVE_STOCKHOLM


@pytest.mark.parametrize("fmt", ["fasta", "stockholm"])
def test_no_compiler_raises_instead_of_python_reader(fmt, tmp_path,
                                                     monkeypatch):
    """Where the readers are not built and no C compiler is found,
    from_path raises KernelBuildError naming what is missing; it does
    not read the file with the Python reader."""
    p = tmp_path / "a.sto"
    p.write_text(STOCKHOLM_CASES["plain"] if fmt == "stockholm"
                 else FASTA_CASES["basic"].decode())
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.delenv("CC", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path / "no_tools"))
    with pytest.raises(_build.KernelBuildError, match="no C compiler"):
        Alignment.from_path(str(p), fmt, device="cpu")


def test_header_edit_changes_the_build_key(tmp_path, monkeypatch):
    """csrc/*.h and *.cuh are part of every library's build key, so an
    edited io_common.h rebuilds the readers."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    names = ("fasta_io", "stockholm_io", "seqdot_host", "reweight")
    before = {n: _build.library_path(n) for n in names}
    assert {n: _build.library_path(n) for n in names} == before
    with open(csrc / "io_common.h", "a") as f:
        f.write("/* edited */\n")
    after_h = {n: _build.library_path(n) for n in names}
    assert all(after_h[n] != before[n] for n in names)
    (csrc / "extra.cuh").write_text("// new header\n")
    assert all(_build.library_path(n) != after_h[n] for n in names)
