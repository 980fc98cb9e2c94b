"""The port's pair-map drawing (evcouplings_torch/visualize/pairs.py, misc.py)
against the JAX package's, through the cases of tests/test_visualize.py
that tests/test_torch_compare.py does not hold: the axis and boundary
logic (find_boundaries in every mode, set_range, scale), the coverage
bars, the secondary-structure cartoon, the contact-map entry points (the
boundary mode honored, an invalid one refused, dot sizes scaled, the
second monomer's multimer contacts drawn, the cartoon across numbering
gaps), the misc helpers and the pymol scripts.

Both packages get the same EC tables and distance maps (the JAX file's
make_ecs / make_distance_map, each package's own DistanceMap) on
matplotlib's Agg backend. Boundaries, ranges, axis limits, the counts of
drawn artists, the patches' extents (rounded to 1e-6), colors and script
texts are compared exactly.
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

from evcouplings_tpu.compare.distances import (  # noqa: E402
    DistanceMap as JaxDistanceMap,
)
from evcouplings_tpu.visualize import misc as jax_misc  # noqa: E402
from evcouplings_tpu.visualize import pairs as jax_pairs  # noqa: E402
from evcouplings_torch.compare.distances import DistanceMap  # noqa: E402
from evcouplings_torch.visualize import misc, pairs  # noqa: E402
from test_visualize import make_ecs  # noqa: E402

PACKAGES = {"torch": (pairs, DistanceMap), "jax": (jax_pairs, JaxDistanceMap)}


def make_distance_map(cls, ids, cutoff_pattern=None):
    """test_visualize.make_distance_map with the package's DistanceMap."""
    n = len(ids)
    residues = pd.DataFrame({"id": [str(x) for x in ids],
                             "coord_id": [str(x) for x in ids]})
    mat = np.full((n, n), 10.0)
    np.fill_diagonal(mat, 0.0)
    for a, b in cutoff_pattern or ():
        mat[a, b] = mat[b, a] = 3.0
    return cls(residues, residues, mat, symmetric=True)


def _drawn(ax):
    """What an axis holds: artist counts, limits, the y direction and the
    patches' extents."""
    return (len(ax.collections), len(ax.patches), len(ax.lines),
            ax.get_xlim(), ax.get_ylim(), ax.yaxis_inverted(),
            [tuple(np.round(p.get_extents().bounds, 6))
             for p in ax.patches])


def _both(draw, xlim=None, ylim=None):
    """draw(pairs module, DistanceMap class, ax) through both packages on
    fresh axes: (result, _drawn(ax)) of each."""
    out = []
    for module, cls in PACKAGES.values():
        fig, ax = plt.subplots()
        try:
            if xlim:
                ax.set_xlim(*xlim)
            if ylim:
                ax.set_ylim(*ylim)
            out.append((draw(module, cls, ax), _drawn(ax)))
        finally:
            plt.close(fig)
    return out


def _outcome(fn):
    try:
        return fn()
    except Exception as e:   # the exception type is what is compared
        return type(e)


@pytest.mark.parametrize("mode,symmetric,ecs,structure", [
    ("union", True, [(5, 20), (7, 30)], range(10, 41)),
    ("intersection", True, [(5, 20), (7, 30)], range(10, 41)),
    ("ecs", True, [(5, 20), (7, 30)], range(10, 41)),
    ("structure", True, [(5, 20), (7, 30)], range(10, 41)),
    ("ecs", False, [(5, 100), (8, 120)], None),
    ("intersection", True, [(5, 20), (7, 30)], None),
    ((1, 9), True, None, None),
    ([(1, 9), (2, 8)], True, None, None),
    ("bogus", True, [(5, 20)], None),
    ((1, 2, 3), True, None, None),
])
def test_find_boundaries(mode, symmetric, ecs, structure):
    got, want = (
        _outcome(lambda: module.find_boundaries(
            mode, None if ecs is None else make_ecs(ecs),
            None if structure is None else make_distance_map(cls, structure),
            None, symmetric=symmetric))
        for module, cls in PACKAGES.values())
    assert got == want
    if mode == "union":
        assert got == ((5, 40), (5, 40))


@pytest.mark.parametrize("kw", [
    dict(pairs=[(3, 40), (10, 25)], symmetric=True),
    dict(pairs=[(3, 40), (10, 25)], symmetric=False, margin=2,
         invert_y=False),
    dict(pairs=[(3, 40)], x=(0, 100), y=(5, 50)),
    dict(),
])
def test_set_range(kw):
    kw = dict(kw)
    if "pairs" in kw:
        kw["pairs"] = make_ecs(kw["pairs"])
    (got, got_ax), (want, want_ax) = _both(
        lambda module, cls, ax: _outcome(
            lambda: module.set_range(ax=ax, **kw)))
    assert got == want and got_ax == want_ax
    if kw.get("margin") == 2:
        assert got == ((1, 12), (23, 42))


@pytest.mark.parametrize("xlim,ylim", [((0, 200), (0, 100)),
                                       ((0, 100), (0, 100))])
def test_scale(xlim, ylim):
    style = {"s": 80, "width": 1, "c": "k"}
    (got, _), (want, _) = _both(
        lambda module, cls, ax: module.scale(style, ax=ax), xlim, ylim)
    assert got == want
    assert style == {"s": 80, "width": 1, "c": "k"}


@pytest.mark.parametrize("symmetric", [True, False])
def test_ec_coverage(symmetric):
    ecs = make_ecs([(1, 10), (2, 11), (3, 12)])
    (_, got), (_, want) = _both(
        lambda module, cls, ax: module.plot_ec_coverage(
            ecs, symmetric=symmetric, ax=ax), (0, 50), (50, 0))
    assert got == want
    assert got[1] == (4 if symmetric else 2)


@pytest.mark.parametrize("source", ["list", "distance map"])
def test_structure_coverage(source):
    def draw(module, cls, ax):
        if source == "list":
            coverage = [([(1, 10), (20, 30)], [(1, 10)], "1abc:A"),
                        ([(5, 15)], [(5, 15)], "2xyz:B")]
        else:
            coverage = make_distance_map(cls, range(1, 6)) \
                .structure_coverage()
        module.plot_structure_coverage(coverage, ax=ax)
        return coverage, ax.get_facecolor()

    (got, got_ax), (want, want_ax) = _both(draw)
    assert got == want and got_ax == want_ax


@pytest.mark.parametrize("sse", ["dict", "frame", "frame without column",
                                 "outside the range"])
def test_secondary_structure_cartoon(sse):
    if sse == "dict":
        source = {i: "H" for i in range(2, 9)}
        source.update({i: "E" for i in range(11, 16)})
    elif sse == "frame":
        source = pd.DataFrame({
            "id": list(range(1, 15)),
            "sec_struct_3state": ["C"] * 3 + ["H"] * 6 + ["E"] * 5})
    elif sse == "frame without column":
        source = pd.DataFrame({"id": [1, 2, 3]})
    else:
        source = {i: "H" for i in range(100, 120)}
    (_, got), (_, want) = _both(
        lambda module, cls, ax: module.plot_secondary_structure(
            source, ax=ax, style=dict(module.STYLE_SECSTRUCT)),
        (0, 20), (20, 0))
    assert got == want
    assert (got[1] + got[2] > 0) == (sse in ("dict", "frame"))


def test_secondary_structure_segments():
    for s, offset in (("HHHH--EEE", 5), ("CCHHE", 1), ("", 3)):
        assert pairs.find_secondary_structure_segments(s, offset) == \
            jax_pairs.find_secondary_structure_segments(s, offset)
    assert pairs.find_secondary_structure_segments("HHHH--EEE", 5) == (
        5, 13, [("H", 5, 8), ("-", 9, 10), ("E", 11, 13)])


def test_plot_contact_map_with_structure():
    ecs = make_ecs([(1, 6), (3, 10), (2, 15)])
    (_, got), (_, want) = _both(lambda module, cls, ax: module
                                .plot_contact_map(
                                    ecs=ecs, monomer=make_distance_map(
                                        cls, range(1, 21), [(0, 5), (2, 9)]),
                                    ax=ax))
    assert got == want and got[0] > 0


@pytest.mark.parametrize("boundaries", ["intersection", "union", "ecs",
                                        "structure", "bogus"])
def test_boundaries_mode_is_honored(boundaries):
    ecs = make_ecs([(1, 10), (2, 15)])
    (got, got_ax), (want, want_ax) = _both(
        lambda module, cls, ax: _outcome(lambda: module.plot_contact_map(
            ecs=ecs, monomer=make_distance_map(cls, range(5, 26)),
            boundaries=boundaries, margin=0, ax=ax)))
    assert got_ax == want_ax
    if boundaries == "bogus":
        assert got is want is ValueError
    if boundaries == "intersection":
        assert sorted(got_ax[3]) == [5, 15]


@pytest.mark.parametrize("n_pos", [50, 500])
@pytest.mark.parametrize("scale_sizes", [True, False])
def test_scale_sizes(n_pos, scale_sizes):
    (_, got), (_, want) = _both(
        lambda module, cls, ax: module.plot_contact_map(
            ecs=make_ecs([(1, n_pos)]), scale_sizes=scale_sizes,
            boundaries="ecs", ax=ax) and ax.collections[0].get_sizes()[0])
    assert got == want


@pytest.mark.parametrize("with_multimer_j", [True, False])
def test_complex_contact_map(with_multimer_j):
    def draw(module, cls, ax):
        dm2 = make_distance_map(cls, range(1, 11), [(0, 5)])
        module.complex_contact_map(
            make_ecs([(1, 5)]), make_ecs([(3, 9)]), make_ecs([(1, 3)]),
            None, None, None, dm2 if with_multimer_j else None, None, ax=ax)

    (_, got), (_, want) = _both(draw)
    assert got == want and got[0] > 0


def test_secstruct_cartoon_respects_numbering_gaps():
    def draw(module, cls, ax):
        dm = make_distance_map(cls, list(range(1, 6)) + list(range(20, 25)))
        dm.residues_i["sec_struct_3state"] = ["H"] * 5 + ["E"] * 5
        dm.residues_j = dm.residues_i
        module.plot_contact_map(ecs=make_ecs([(1, 24)]), monomer=dm,
                                show_secstruct=True, ax=ax)
        return max(p.get_patch_transform().transform(
            p.get_path().vertices)[:, 0].max() for p in ax.patches)

    (got, got_ax), (want, want_ax) = _both(draw)
    assert got == want and got_ax == want_ax
    assert got >= 20


def test_plot_context_and_chart_junk():
    drawn = []
    for module in (misc, jax_misc):
        fig, ax = plt.subplots()
        with module.plot_context("DejaVu Sans", size=10):
            ax.plot([1, 2], [3, 4])
        module.remove_chart_junk(ax=ax)
        drawn.append({k: s.get_visible() for k, s in ax.spines.items()})
        plt.close(fig)
    assert drawn[0] == drawn[1]
    assert not drawn[0]["top"] and drawn[0]["left"]


def test_rgb2hex_and_colormap():
    for args in ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0, 1.0), (0.2, 0.4, 0.6)):
        assert misc.rgb2hex(*args) == jax_misc.rgb2hex(*args)
    cm, jcm = misc.colormap(0.0, 1.0), jax_misc.colormap(0.0, 1.0)
    for x in np.linspace(-0.5, 1.5, 9):
        assert cm(x) == jcm(x)


def test_pymol_scripts(tmp_path):
    ecs = make_ecs([(1, 5), (2, 8)])
    ecs["dist"] = [3.0, 8.0]
    table = pd.DataFrame({"i": range(1, 21),
                          "enrichment": np.linspace(5, 0.1, 20)})
    for name, fn, arg in (("ecs", "ec_lines_pymol_script", ecs),
                          ("enrich", "enrichment_pymol_script", table)):
        texts = []
        for tag, (module, _) in PACKAGES.items():
            out = tmp_path / "{}_{}.pml".format(tag, name)
            getattr(module, fn)(arg, str(out))
            texts.append(out.read_text())
        assert texts[0] == texts[1]
