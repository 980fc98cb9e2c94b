"""The port's bundled CNS protocol templates (evcouplings_torch/fold/
cns_templates through fold/cns.py's renderers) against the JAX package's,
through the cases of tests/test_cns_templates.py that
tests/test_torch_fold.py (test_rendered_cns_scripts_equal) does not hold:
each public renderer at its defaults and at the other settings its
arguments allow, and each template through the template renderer with the
variables the public renderers pin (hydrogens, atom naming, the crystal
block, the hydrogen-bond class), every rendering checked for the JAX
file's contract (fully substituted, ending the CNS session) and compared
byte for byte with the JAX package's.
"""

import pandas as pd
import pytest

from evcouplings_tpu.fold import cns as jax_cns
from evcouplings_torch.fold import cns

DGSA = dict(pdb_infile="e.pdb", mtf_infile="t.mtf", num_structures=3,
            ec_pair_tbl_infile="a.tbl", ss_dist_tbl_infile="b.tbl",
            ss_angle_tbl_infile="c.tbl", pdb_outfile_basename="t",
            hbond_tbl_infile="", log_level="quiet",
            md_cool_noe_scale_factor=5, ss_dist_noe_avg_mode="cent",
            ec_pair_noe_avg_mode="cent")
EASY = dict(pdb_infile="m.pdb", mtf_outfile="m_h.mtf",
            pdb_outfile="m_h.pdb", hydrogen_flag="true",
            pdb_o_format="false", ile_cd_becomes="", ot1_becomes="")
MINIMIZE = dict(pdb_infile="m_h.pdb", mtf_infile="m_h.mtf",
                pdb_outfile="m_hMIN.pdb", num_cycles=5, use_cryst="false",
                space_group="")

RENDERS = {
    # the public renderers at their defaults and other arguments
    "generate_seq defaults": lambda m: m.cns_mtf_inp("a.seq", "a.mtf"),
    "generate_seq first_index": lambda m: m.cns_mtf_inp(
        "s.seq", "s.mtf", first_index=-3),
    "generate_seq one disulfide": lambda m: m.cns_mtf_inp(
        "s.seq", "s.mtf", first_index=2, disulfide_bridges=[(4, 19)]),
    "generate_seq empty disulfides": lambda m: m.cns_mtf_inp(
        "s.seq", "s.mtf", disulfide_bridges=[]),
    "generate_seq table without cysteine pairs": lambda m: m.cns_mtf_inp(
        "s.seq", "s.mtf", disulfide_bridges=pd.DataFrame({
            "i": [3], "j": [30], "A_i": ["C"], "A_j": ["A"]})),
    "generate_extended": lambda m: m.cns_extended_inp("a.mtf", "a.pdb"),
    "dg_sa defaults": lambda m: m.cns_dgsa_inp(
        "a.pdb", "a.mtf", "a", "x.tbl", "y.tbl", "z.tbl"),
    "dg_sa one structure": lambda m: m.cns_dgsa_inp(
        "a.pdb", "a.mtf", "out/a", "x.tbl", "y.tbl", "z.tbl",
        num_structures=1, log_level="verbose"),
    "generate_easy": lambda m: m.cns_generate_easy_inp(
        "a.pdb", "b.pdb", "b.mtf"),
    "model_minimize defaults": lambda m: m.cns_minimize_inp(
        "a.pdb", "a.mtf", "b.pdb"),
    "model_minimize one cycle": lambda m: m.cns_minimize_inp(
        "a.pdb", "a.mtf", "b.pdb", num_cycles=1),
    # the variables the public renderers pin, through the template
    "dg_sa hbond class": lambda m: m._cns_render_template(
        "dg_sa", **dict(DGSA, hbond_tbl_infile="hb.tbl")),
    "dg_sa averaging modes": lambda m: m._cns_render_template(
        "dg_sa", **dict(DGSA, ss_dist_noe_avg_mode="sum",
                        ec_pair_noe_avg_mode="r-6",
                        md_cool_noe_scale_factor=2)),
    "generate_easy without hydrogens": lambda m: m._cns_render_template(
        "generate_easy", **dict(EASY, hydrogen_flag="false")),
    "generate_easy renamed atoms": lambda m: m._cns_render_template(
        "generate_easy", **dict(EASY, pdb_o_format="true",
                                ile_cd_becomes="CD", ot1_becomes="OT1")),
    "model_minimize crystal": lambda m: m._cns_render_template(
        "model_minimize", **dict(MINIMIZE, use_cryst="true",
                                 space_group="P2(1)2(1)2(1)")),
}


@pytest.mark.parametrize("name", list(RENDERS))
def test_rendered_scripts_equal(name, monkeypatch):
    monkeypatch.delenv("EVCOUPLINGS_CNS_TEMPLATE_DIR", raising=False)
    got, want = RENDERS[name](cns), RENDERS[name](jax_cns)
    assert got == want
    for mark in ("{{", "}}", "{%", "%}"):
        assert mark not in got
    assert got.rstrip().endswith("stop")


def test_template_variants_differ_where_they_should(monkeypatch):
    """The pinned variables reach the scripts: each variant renders
    something other than the public renderer's script."""
    monkeypatch.delenv("EVCOUPLINGS_CNS_TEMPLATE_DIR", raising=False)
    assert "class hbnd" in RENDERS["dg_sa hbond class"](cns)
    assert "class hbnd" not in RENDERS["dg_sa defaults"](cns)
    assert "hbuild" not in RENDERS["generate_easy without hydrogens"](cns)
    assert 'do (name="CD1")' in RENDERS["generate_easy renamed atoms"](cns)
    assert "xray" in RENDERS["model_minimize crystal"](cns)
    assert "patch DISU" not in RENDERS[
        "generate_seq table without cysteine pairs"](cns)
    assert RENDERS["generate_seq one disulfide"](cns).count(
        "patch DISU") == 1


@pytest.mark.parametrize("sequence,per_line", [
    ("ACDEFGHIKLMNPQRSTVWY", 16), ("MKV", 2), ("W" * 33, 16)])
def test_seq_files_equal(tmp_path, sequence, per_line):
    got = cns.cns_seq_file(sequence, str(tmp_path / "t.seq"), per_line)
    want = jax_cns.cns_seq_file(sequence, str(tmp_path / "j.seq"), per_line)
    with open(got) as f, open(want) as g:
        assert f.read() == g.read()


def test_invalid_residue_refused(tmp_path):
    for module in (cns, jax_cns):
        with pytest.raises(module.InvalidParameterError):
            module.cns_seq_file("ACJ", str(tmp_path / "x.seq"))
