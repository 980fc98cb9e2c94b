"""The port's fold modules (evcouplings_torch/fold, host code as in the
JAX package) against the JAX package's, on the in-repo cases of
tests/test_fold.py and tests/test_cns_templates.py and on seeded
variations of them: restraint lines and .tbl files, the .seq file and
every rendered CNS script byte for byte, clash flags, psipred and
maxcluster parses and the dihedral ranking exactly equal (float64,
tolerance 0), the complex_dock protocol's restraint files byte for byte;
then the helpers the stage brought (render_template, dihedral_angle,
pymol_secondary_structure) and the template search order.
"""

import os

import numpy as np
import pandas as pd
import pytest

import fold_fixtures as ff
from evcouplings_tpu.fold import cns as jax_cns
from evcouplings_tpu.fold import filter as jax_filter
from evcouplings_tpu.fold import haddock as jax_haddock
from evcouplings_tpu.fold import protocol as jax_protocol
from evcouplings_tpu.fold import ranking as jax_ranking
from evcouplings_tpu.fold import restraints as jax_restraints
from evcouplings_tpu.fold import tools as jax_tools
from evcouplings_tpu.utils import calculations as jax_calc
from evcouplings_tpu.visualize import pymol as jax_pymol
from evcouplings_torch.fold import cns, filter, haddock, protocol, ranking
from evcouplings_torch.fold import restraints, tools
from evcouplings_torch.utils import calculations, helpers
from evcouplings_torch.visualize import pymol

SEQ = "MKTAYIAKQRQISFVKSHFSRQGCWNDEPL"


def residue_table(secstruct, seq=None):
    seq = seq or "A" * len(secstruct)
    return pd.DataFrame({
        "i": range(1, len(secstruct) + 1),
        "A_i": list(seq[:len(secstruct)]),
        "sec_struct_3state": list(secstruct),
    })


def random_secstruct(seed, L=30):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("HEC"), size=L, p=(0.35, 0.25, 0.40)))


def read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("args,kwargs", [
    ((5, "CA", 20, "CB"), dict(dist=4, lower=4, upper=3, weight=2.0,
                               comment="ALA GLY")),
    ((5, "CA", 20, "CB"), dict(dist=5.0, lower=1.0, upper=2.0)),
])
def test_cns_dist_restraint_format(args, kwargs):
    got = cns.cns_dist_restraint(*args, **kwargs)
    assert got == jax_cns.cns_dist_restraint(*args, **kwargs)
    if "comment" in kwargs:
        assert got == ("assign (resid 5 and name CA) (resid 20 and name "
                       "CB)  4 4 3 weight 2.0 ! ALA GLY")


def test_cns_dihedral_and_haddock_formats():
    args = (1, "C", 2, "N", 2, "CA", 2, "C")
    kw = dict(energy_constant=0.5, degrees=-57.0, range=7.0, exponent=2)
    assert cns.cns_dihedral_restraint(*args, **kw) == \
        jax_cns.cns_dihedral_restraint(*args, **kw)
    assert cns.cns_dihedral_restraint(*args, comment="x", **kw) == \
        jax_cns.cns_dihedral_restraint(*args, comment="x", **kw)
    hargs = (10, "A", 200, "B")
    hkw = dict(dist=2.0, lower=2.0, upper=0.0, comment="c")
    assert haddock.haddock_dist_restraint(*hargs, **hkw) == \
        jax_haddock.haddock_dist_restraint(*hargs, **hkw)


@pytest.mark.parametrize("seed", [None, 0, 1, 2])
def test_ec_and_docking_restraint_files_equal(seed, tmp_path):
    """test_fold.py's EC table (seed None), then seeded tables over every
    residue type (glycines included)."""
    if seed is None:
        ecs = pd.DataFrame({"i": [3, 5], "j": [20, 30], "A_i": ["A", "G"],
                            "A_j": ["W", "C"]})
    else:
        rng = np.random.default_rng(seed)
        aa = list("ACDEFGHIKLMNPQRSTVWY")
        n = 40
        ecs = pd.DataFrame({"i": rng.integers(1, 50, n),
                            "j": rng.integers(50, 100, n),
                            "A_i": rng.choice(aa, n), "A_j": rng.choice(aa, n)})
    ecs["segment_i"], ecs["segment_j"] = "A_1", "B_1"
    for port_fn, jax_fn, fmt, jax_fmt in (
            (restraints.ec_dist_restraints, jax_restraints.ec_dist_restraints,
             cns.cns_dist_restraint, jax_cns.cns_dist_restraint),
            (restraints.docking_restraints, jax_restraints.docking_restraints,
             haddock.haddock_dist_restraint,
             jax_haddock.haddock_dist_restraint)):
        got, want = tmp_path / "port.tbl", tmp_path / "jax.tbl"
        port_fn(ecs, str(got), fmt)
        jax_fn(ecs, str(want), jax_fmt)
        assert read(got) == read(want) and read(got)
    if seed is None:
        restraints.ec_dist_restraints(ecs, str(got), cns.cns_dist_restraint)
        # pair 1: CA + CB; pair 2: CA only (G has no CB)
        assert len(read(got).strip().split("\n")) == 3


@pytest.mark.parametrize("secstruct", [
    "HHHHHCCC", "HHHEEECC", "CHHHHHCCCC", random_secstruct(3),
    random_secstruct(4), random_secstruct(5)])
def test_secstruct_restraint_files_equal(secstruct, tmp_path):
    residues = residue_table(secstruct, SEQ.replace("A", "G"))
    for name, fmt, jax_fmt in (
            ("secstruct_dist_restraints", cns.cns_dist_restraint,
             jax_cns.cns_dist_restraint),
            ("secstruct_angle_restraints", cns.cns_dihedral_restraint,
             jax_cns.cns_dihedral_restraint)):
        got, want = tmp_path / "port.tbl", tmp_path / "jax.tbl"
        getattr(restraints, name)(residues, str(got), fmt)
        getattr(jax_restraints, name)(residues, str(want), jax_fmt)
        assert read(got) == read(want), name


def test_cns_seq_file_equal(tmp_path):
    for seq in ("ACDG", SEQ):
        got = cns.cns_seq_file(seq, str(tmp_path / "port.seq"))
        want = jax_cns.cns_seq_file(seq, str(tmp_path / "jax.seq"))
        assert read(got) == read(want)
    assert read(cns.cns_seq_file("ACDG", str(tmp_path / "t.seq"))).strip() \
        == "ALA CYS ASP GLY"


DGSA_VARIANT = dict(
    pdb_infile="e.pdb", mtf_infile="t.mtf", num_structures=3,
    ec_pair_tbl_infile="a.tbl", ss_dist_tbl_infile="b.tbl",
    ss_angle_tbl_infile="c.tbl", pdb_outfile_basename="t",
    hbond_tbl_infile="hb.tbl", log_level="quiet",
    md_cool_noe_scale_factor=5, ss_dist_noe_avg_mode="cent",
    ec_pair_noe_avg_mode="cent")

RENDERS = {
    "generate_seq": lambda m: m.cns_mtf_inp("target.seq", "target.mtf",
                                            first_index=5),
    "generate_seq_disulfides": lambda m: m.cns_mtf_inp(
        "t.seq", "t.mtf", disulfide_bridges=[(12, 40), (77, 103)]),
    "generate_seq_disulfide_table": lambda m: m.cns_mtf_inp(
        "t.seq", "t.mtf", disulfide_bridges=pd.DataFrame({
            "i": [3, 5, 9], "j": [30, 50, 90], "A_i": ["C", "C", "A"],
            "A_j": ["C", "G", "C"]})),
    "generate_extended": lambda m: m.cns_extended_inp("t.mtf",
                                                      "t_extended.pdb"),
    "dg_sa": lambda m: m.cns_dgsa_inp(
        "t_extended.pdb", "t.mtf", "t", "t_couplings.tbl",
        "t_ss_distance.tbl", "t_ss_angle.tbl", num_structures=7,
        log_level="quiet"),
    "dg_sa_hbond": lambda m: m._cns_render_template("dg_sa", **DGSA_VARIANT),
    "generate_easy": lambda m: m.cns_generate_easy_inp("m.pdb", "m_h.pdb",
                                                       "m_h.mtf"),
    "model_minimize": lambda m: m.cns_minimize_inp(
        "m_h.pdb", "m_h.mtf", "m_hMIN.pdb", num_cycles=3),
}


@pytest.mark.parametrize("name", list(RENDERS))
def test_rendered_cns_scripts_equal(name, monkeypatch):
    """Every renderer of test_cns_templates.py (and the disulfide table
    form), from each package's packaged templates: byte for byte."""
    monkeypatch.delenv("EVCOUPLINGS_CNS_TEMPLATE_DIR", raising=False)
    got, want = RENDERS[name](cns), RENDERS[name](jax_cns)
    assert got == want
    assert "{{" not in got and "{%" not in got
    assert got.rstrip().endswith("stop")


def test_packaged_templates_are_copies():
    port_dir = cns._PACKAGED_TEMPLATE_DIR
    assert port_dir != jax_cns._PACKAGED_TEMPLATE_DIR
    names = sorted(n for n in os.listdir(jax_cns._PACKAGED_TEMPLATE_DIR)
                   if n.endswith((".inp", ".yml")))
    assert len(names) == 7
    for name in names:
        assert read(os.path.join(port_dir, name)) == read(
            os.path.join(jax_cns._PACKAGED_TEMPLATE_DIR, name)), name


def test_template_search_order(tmp_path, monkeypatch):
    """An explicit directory, then EVCOUPLINGS_CNS_TEMPLATE_DIR, then the
    packaged copy; an explicit directory without the template warns and
    falls through. The same in both packages."""
    explicit, env = tmp_path / "explicit", tmp_path / "env"
    explicit.mkdir()
    env.mkdir()
    (explicit / "generate_extended.inp").write_text("explicit {{ mtf_infile }}")
    (env / "generate_extended.inp").write_text("env {{ mtf_infile }}")
    (env / "model_minimize.inp").write_text("env min {{ pdb_infile }}")
    monkeypatch.setenv("EVCOUPLINGS_CNS_TEMPLATE_DIR", str(env))
    for module in (cns, jax_cns):
        assert module.cns_extended_inp("a.mtf", "b.pdb",
                                       template_dir=str(explicit)) == \
            "explicit a.mtf"
        assert module.cns_extended_inp("a.mtf", "b.pdb") == "env a.mtf"
        with pytest.warns(RuntimeWarning, match="falling back"):
            assert module.cns_minimize_inp(
                "p.pdb", "p.mtf", "o.pdb", template_dir=str(explicit)) == \
                "env min p.pdb"
    monkeypatch.delenv("EVCOUPLINGS_CNS_TEMPLATE_DIR")
    assert cns._cns_template_file("dg_sa") == os.path.join(
        cns._PACKAGED_TEMPLATE_DIR, "dg_sa.inp")


@pytest.mark.parametrize("seed", [17, 18, 19])
def test_secstruct_clash_equal_on_every_pair(seed):
    states = dict(enumerate(random_secstruct(seed)))
    got = [filter.detect_secstruct_clash(i, j, states)
           for i in range(30) for j in range(i + 1, 30)]
    want = [jax_filter.detect_secstruct_clash(i, j, states)
            for i in range(30) for j in range(i + 1, 30)]
    assert got == want and any(got) and not all(got)


def test_clash_tables_equal():
    residues = residue_table("CHHHHHCCCC")
    ecs = pd.DataFrame({"i": [2, 1], "j": [6, 9]})
    got = filter.secstruct_clashes(ecs, residues)
    pd.testing.assert_frame_equal(got, jax_filter.secstruct_clashes(
        ecs, residues))
    assert list(got.ss_clash) == [True, False]
    rng = np.random.default_rng(3)
    n = 40
    table = pd.DataFrame({
        "i": rng.integers(1, 15, size=n), "j": rng.integers(1, 15, size=n),
        "A_i": rng.choice(["C", "A"], size=n, p=(0.6, 0.4)),
        "A_j": rng.choice(["C", "A"], size=n, p=(0.6, 0.4))})
    got = filter.disulfide_clashes(table)
    pd.testing.assert_frame_equal(got, jax_filter.disulfide_clashes(table))
    assert got.cys_clash.any()


def random_trace(seed, drop_rate=0.0, n=36):
    """test_fold.py's random CA trace (a scaled random walk, some
    positions dropped)."""
    rng = np.random.default_rng(seed)
    pos = np.arange(1, n + 1)
    keep = rng.random(n) >= drop_rate
    xyz = rng.normal(scale=4.0, size=(n, 3)).cumsum(axis=0) * 0.6
    return pd.DataFrame({"i": pos[keep], "x": xyz[keep, 0],
                         "y": xyz[keep, 1], "z": xyz[keep, 2]})


@pytest.mark.parametrize("seed", [5, 7, 13, 21, 34])
@pytest.mark.parametrize("original", [True, False])
def test_beta_dihedrals_equal(seed, original):
    """The strand-pairing dihedral search, value for value (tolerance 0),
    and its KeyError in the same configurations."""
    coords = random_trace(seed, drop_rate=0.06 * (seed % 3))
    segments = [(3, 9), (12, 18), (22, 29)]
    results = []
    for module in (ranking, jax_ranking):
        try:
            results.append(module._beta_dihedrals(coords, segments,
                                                  original=original))
        except KeyError:
            results.append(KeyError)
    got, want = results
    if want is KeyError:
        assert got is KeyError
        return
    pd.testing.assert_frame_equal(got, want, check_exact=True)


@pytest.mark.parametrize("seed", [2, 9])
def test_alpha_dihedrals_equal(seed):
    coords = random_trace(seed, drop_rate=0.1)
    segments = [(4, 12), (20, 30)]
    got = ranking._alpha_dihedrals(coords, segments)
    pd.testing.assert_frame_equal(
        got, jax_ranking._alpha_dihedrals(coords, segments),
        check_exact=True)
    assert len(got)


@pytest.mark.parametrize("secstruct", [
    "H" * 12, "C" * 12, "CCHHHHHHCCCC", None])
def test_dihedral_ranking_equal(secstruct, tmp_path):
    """dihedral_ranking over helix models (and a strand-rich walk) in
    float64: every column exactly equal (tolerance 0)."""
    models = []
    for k, n in enumerate((12, 12, 30)):
        path = tmp_path / "m{}.pdb".format(k)
        path.write_text(ff.helix_pdb(SEQ[:n]))
        models.append(str(path))
    if secstruct is None:
        # a random walk through the ranking: strands pair in 3D
        trace = random_trace(5, n=30)
        lines = ["ATOM  {:>5}  CA  ALA A{:>4}    {:8.3f}{:8.3f}{:8.3f}  1.00"
                 "  0.00           C".format(k + 1, int(r.i), r.x, r.y, r.z)
                 for k, r in enumerate(trace.itertuples())]
        walk = tmp_path / "walk.pdb"
        walk.write_text("\n".join(lines) + "\nEND\n")
        models = [str(walk)]
        secstruct = "CC" + "EEEEEE" + "CCC" + "EEEEEE" + "CCC" + "EEEEEEE" + "C"
    residues = residue_table(secstruct, SEQ)
    got = ranking.dihedral_ranking(models, residues)
    want = jax_ranking.dihedral_ranking(models, residues)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    if secstruct == "H" * 12:
        assert got.num_alpha_dihedrals.iloc[0] > 0
        assert got.ranking_score.iloc[0] > 0.8


def test_psipred_readers_equal(tmp_path):
    v = tmp_path / "pred.ss2"
    v.write_text(
        "# PSIPRED VFORMAT (PSIPRED V4.0)\n\n"
        "   1 M C   0.999  0.000  0.001\n"
        "   2 K H   0.100  0.899  0.001\n"
        "   3 V E   0.100  0.001  0.899\n")
    h = tmp_path / "pred.horiz"
    h.write_text(
        "# PSIPRED HFORMAT (PSIPRED V4.0)\n\n"
        "Conf: 988\nPred: CHE\n  AA: MKV\n\n"
        "Conf: 12\nPred: HH\n  AA: AC\n")
    for path, first in ((v, 5), (h, 1), (h, 11)):
        got = tools.read_psipred_prediction(str(path), first_index=first)
        pd.testing.assert_frame_equal(
            got, jax_tools.read_psipred_prediction(str(path),
                                                   first_index=first),
            check_exact=True)
    bad = tmp_path / "bad.txt"
    bad.write_text("nothing\n")
    with pytest.raises(Exception, match="not a valid psipred"):
        tools.read_psipred_prediction(str(bad))


def test_maxcluster_parsers_equal():
    comparison = (
        "INFO  : 1. vs. /tmp/model_1.pdb  Pairs= 120, RMSD= 3.123, "
        "MaxSub=0.456, TM=0.567, MSI=0.345\n"
        "junk line\n"
        "INFO  : 2. vs. /tmp/model_2.pdb  Pairs=  90, RMSD= 5.000, "
        "MaxSub=0.300, TM=0.400, MSI=0.200\n")
    clustering = (
        "INFO  : Reading PDB list file\n"
        "INFO  : Clusters @ Threshold  5.000 (size)\n"
        "INFO  :   1 : 2  /tmp/model_1.pdb\n"
        "INFO  :   2 : 1  /tmp/model_2.pdb\n"
        "INFO  :   3 : 2  /tmp/model_3.pdb\n"
        "INFO  :   4 : 2  /tmp/model_4.pdb\n"
        "INFO  : Centroids\n"
        "INFO  :   1 : 7  /tmp/should_be_ignored.pdb\n")
    got = tools.parse_maxcluster_comparison(comparison)
    pd.testing.assert_frame_equal(
        got, jax_tools.parse_maxcluster_comparison(comparison),
        check_exact=True)
    assert got.num_pairs.tolist() == [120, 90]
    got = tools.parse_maxcluster_clustering(clustering)
    pd.testing.assert_frame_equal(
        got, jax_tools.parse_maxcluster_clustering(clustering),
        check_exact=True)
    assert "/tmp/should_be_ignored.pdb" not in set(got.filename)


def test_maxcluster_runners_equal(tmp_path):
    """run_maxcluster_cluster and compare_models_maxcluster through the
    fake maxcluster (tests/fold_fixtures.py), both packages."""
    tools_ = ff.write_fold_tools(str(tmp_path / "bin"), SEQ)
    models = []
    for k in range(3):
        path = tmp_path / "model{}.pdb".format(k)
        path.write_text(ff.helix_pdb(SEQ))
        models.append(str(path))
    for method in ("single", "average", "pairs_abs"):
        got = tools.run_maxcluster_cluster(models, method=method,
                                           binary=tools_["maxcluster"])
        pd.testing.assert_frame_equal(got, jax_tools.run_maxcluster_cluster(
            models, method=method, binary=tools_["maxcluster"]))
    pd.testing.assert_frame_equal(
        protocol.maxcluster_clustering_table(models, tools_["maxcluster"]),
        jax_protocol.maxcluster_clustering_table(models,
                                                 tools_["maxcluster"]))
    experiment = tmp_path / "exp.pdb"
    experiment.write_text(ff.helix_pdb(SEQ[:20], first_index=3))
    got = protocol.compare_models_maxcluster(
        [str(experiment)], models, binary=tools_["maxcluster"])
    want = jax_protocol.compare_models_maxcluster(
        [str(experiment)], models, binary=tools_["maxcluster"])
    pd.testing.assert_frame_equal(got[0], want[0], check_exact=True)
    assert list(got[1]) == list(want[1])
    assert (got[0].L_joint == 20).all() and len(got[0]) == 3


def test_complex_dock_files_equal(tmp_path):
    """test_fold.py's complex_dock case through both packages' run():
    one probability-cutoff file and two count files, byte for byte."""
    ecs = pd.DataFrame({
        "i": [1, 2, 3, 4], "j": [100, 101, 5, 102],
        "A_i": ["A", "C", "D", "E"], "A_j": ["F", "G", "H", "I"],
        "segment_i": ["A_1", "A_1", "A_1", "A_1"],
        "segment_j": ["B_1", "B_1", "A_1", "B_1"],
        "probability": [0.99, 0.95, 0.8, 0.5]})
    ec_file = str(tmp_path / "ecs.csv")
    ecs.to_csv(ec_file, index=False)
    outs = {}
    for tag, module in (("torch", protocol), ("jax", jax_protocol)):
        outs[tag] = module.run(
            protocol="complex_dock", prefix=str(tmp_path / tag / "job"),
            ec_file=ec_file, segments=None, dock_probability_cutoffs=[0.9],
            dock_lowest_count=2, dock_highest_count=3, dock_increase=1)
    got, want = (outs[t]["docking_restraint_files"] for t in ("torch", "jax"))
    assert [os.path.relpath(f, str(tmp_path / "torch")) for f in got] == \
        [os.path.relpath(f, str(tmp_path / "jax")) for f in want]
    assert len(got) == 3
    for g, w in zip(got, want):
        assert read(g) == read(w)
    assert "segid A" in read(got[0]) and "segid B" in read(got[0])


def test_invalid_protocol_and_method_raise(tmp_path):
    from evcouplings_torch.utils.config import InvalidParameterError

    with pytest.raises(InvalidParameterError, match="Invalid protocol"):
        protocol.run(protocol="nope")
    with pytest.raises(InvalidParameterError, match="unknown secondary"):
        protocol.secondary_structure(
            prefix=str(tmp_path / "p"), target_sequence_file=None,
            segments=None, sec_struct_method="dssp", sec_struct_file=None,
            psipred=None)


def test_dihedral_angle_equal():
    rng = np.random.default_rng(11)
    for _ in range(50):
        pts = rng.normal(size=(4, 3))
        got = calculations.dihedral_angle(*pts)
        assert got == jax_calc.dihedral_angle(*pts)
    square = np.array([[1.0, 0, 0], [0, 0, 0], [0, 1.0, 0], [0, 1.0, 1.0]])
    assert calculations.dihedral_angle(*square) == pytest.approx(-np.pi / 2)


def test_pymol_secondary_structure_equal(tmp_path):
    residues = residue_table("CHHHEECC")
    got = pymol.pymol_secondary_structure(residues, str(tmp_path / "a.pml"),
                                          chain="B")
    want = jax_pymol.pymol_secondary_structure(
        residues, str(tmp_path / "b.pml"), chain="B")
    assert got == want and read(tmp_path / "a.pml") == read(
        tmp_path / "b.pml")
    assert got[-1] == "rebuild" and len(got) == 6


def test_render_template_and_missing_jinja2(tmp_path, monkeypatch):
    """render_template renders with jinja2; without it the port raises
    naming the module, as the fold stage's first render would."""
    import sys

    from evcouplings_tpu.utils import helpers as jax_helpers

    t = tmp_path / "t.inp"
    t.write_text("{% for x in xs %}{{ x }};{% endfor %}{{ y }}")
    mapping = {"xs": [1, 2], "y": "z"}
    assert helpers.render_template(str(t), mapping) == "1;2;z"
    assert jax_helpers.render_template(str(t), mapping) == "1;2;z"
    monkeypatch.setitem(sys.modules, "jinja2", None)
    with pytest.raises(ImportError, match="jinja2"):
        helpers.render_template(str(t), mapping)
    with pytest.raises(ImportError, match="jinja2"):
        cns.cns_extended_inp("a.mtf", "b.pdb")
