"""
EC visualization (port of evcouplings_tpu/visualize/pairs.py): the Pymol
line and enrichment script writers, and contact-map plotting. matplotlib
is imported inside the drawing functions, never when the module loads:
the module loads on a machine without it.
"""

from copy import deepcopy
from itertools import groupby

import numpy as np
import pandas as pd

from evcouplings_torch.utils.helpers import find_segments
from evcouplings_torch.visualize.pymol import pymol_mapping, pymol_pair_lines

# blue sequential colormap for enrichment categories (RGB fractions)
_ENRICHMENT_COLORS = [
    (77, 0, 75),       # dark purple
    (129, 15, 124),
    (136, 65, 157),
    (140, 107, 177),
    (140, 150, 198),
    (158, 188, 218),
    (191, 211, 230),
    (224, 236, 244),
    (247, 252, 253),   # almost white
]

# pymol dash geometry for EC lines
_DASH_GEOMETRY = {"dash_radius": 0.345, "dash_gap": 0.075,
                  "dash_length": 0.925}


def _chain_clause(chain):
    """The ', chain ...' suffix pymol commands take (empty without a
    chain; multi-chain dicts get an or-joined selector)."""
    if chain is None:
        return ""
    if isinstance(chain, dict):
        return ", chain " + " or chain ".join(chain.values())
    return ", chain '{}'".format(chain)


def ec_lines_pymol_script(ec_table, output_file, distance_cutoff=5,
                          score_column="cn", chain=None):
    """Pymol script drawing EC pairs as lines on a structure.

    Line radius scales with score; if a "dist" column exists, pairs
    beyond distance_cutoff are colored red (false positives).
    """
    t = ec_table.assign(**_DASH_GEOMETRY)

    if score_column is not None:
        # radius proportional to score, topping out at 0.5, floored
        # at zero for negative scores
        radius = 0.5 * t[score_column] / t[score_column].max()
        t["dash_radius"] = radius.clip(lower=0)

    if "dist" in t.columns and distance_cutoff is not None:
        # true contacts green, false positives red; pairs with no
        # distance (NaN) stay uncolored
        t["color"] = (
            pd.Series(np.nan, index=t.index, dtype=object)
            .mask(t.dist <= distance_cutoff, "green")
            .mask(t.dist > distance_cutoff, "red")
        )
    else:
        t["color"] = "green"

    sel = _chain_clause(chain)
    with open(output_file, "w") as f:
        f.write("as cartoon{}\ncolor grey80{}\n".format(sel, sel))
        pymol_pair_lines(t, f, chain)


def _paint_quantile_bins(t, fractions, names):
    """Assign color names to row blocks of t (already sorted by
    enrichment, descending): block k = rows between the
    fractions[k-1] and fractions[k] quantile boundaries (truncating
    row counts like the reference)."""
    edges = [int(frac * len(t)) for frac in fractions]
    lo = 0
    for name, hi in zip(names, edges):
        t.loc[t.index[lo:hi], "color"] = name
        lo = hi
    return edges


def enrichment_pymol_script(enrichment_table, output_file,
                            sphere_view=True, chain=None, legacy=False):
    """Pymol script highlighting EC enrichment per position.

    Default mode bins positions into nine enrichment categories on a
    sequential colormap (top category also rendered as spheres when
    sphere_view). Legacy mode reproduces the 2011 red/yellow scheme.
    """
    palette = None
    if legacy:
        t = enrichment_table.query("enrichment > 1").copy()
        t["b_factor"] = t.enrichment
        t["color"] = "yelloworange"
        # top 5% red, next 10% orange, spheres through the top 15%
        edges = _paint_quantile_bins(
            t, (0.05, 0.15), ("red", "orange")
        )
        sphere_rows = edges[-1]
    else:
        t = deepcopy(enrichment_table)
        t["b_factor"] = t.enrichment
        t["color"] = ""
        palette = [
            tuple(channel / 255 for channel in rgb)
            for rgb in _ENRICHMENT_COLORS
        ]
        edges = _paint_quantile_bins(
            t,
            (.11, .22, .33, .44, .55, .66, .77, .88, 1.0),
            ["color{}".format(k) for k in range(len(palette))],
        )
        # spheres through the second bin boundary (top ~22%)
        sphere_rows = edges[1]

    if sphere_view:
        t.loc[t.index[:sphere_rows], "show"] = "spheres"

    sel = _chain_clause(chain)
    with open(output_file, "w") as f:
        reset_target = "all" if chain is None \
            else "chain '{}'".format(chain)
        f.write("alter {}, b=0.0\n".format(reset_target))

        if palette is None:
            f.write("color grey80{}\n".format(sel))
        else:
            for k, (r, g, b) in enumerate(palette):
                f.write("set_color color{}, [{},{},{}]\n".format(
                    k, r, g, b
                ))
            f.write("color color{}{}\n".format(len(palette) - 1, sel))

        f.write("as cartoon{}\n".format(sel))
        pymol_mapping(t, f, chain)

        if not sphere_view:
            f.write("cartoon putty{}\n".format(sel))


# ---------------------------------------------------------------------------
# contact map plotting
# ---------------------------------------------------------------------------

def _axes(ax):
    """The target axes: the given one, else matplotlib's current
    (matplotlib is imported here, on use)."""
    if ax is not None:
        return ax
    import matplotlib.pyplot as plt

    return plt.gca()


_BOUNDARY_MODES = ("union", "intersection", "ecs", "structure")


def _check_boundary_mode(mode):
    if mode not in _BOUNDARY_MODES:
        raise ValueError(
            "Not a valid value for boundaries: {}".format(mode)
        )


def _numeric_set(values):
    """Positions coerced to a set of ints; non-numeric entries
    (insertion codes, NaN) are dropped rather than crashing."""
    nums = pd.to_numeric(pd.Series(list(values)), errors="coerce")
    return set(nums.dropna().astype(int))


def _scatter_style(color, size, **extra):
    """Edge-less scatter style for contact-map dots."""
    return {"edgecolor": "none", "c": color, "s": size, **extra}


# rendering defaults mirror the reference's published figures
STYLE_EC = _scatter_style("black", 80)
STYLE_CONTACT = _scatter_style("#b6d4e9", 100)
STYLE_CONTACT_BRIGHT = _scatter_style("#d9e7f5", 100)
STYLE_CONTACT_MULTIMER = _scatter_style("#fc8c3b", 100, alpha=0.3)

STYLE_SECSTRUCT = {
    "helix_turn_length": 2,
    "strand_width_factor": 0.5,
    "min_sse_length": 2,
    "width": 1,
    "line_width": 2,
    # monochrome cartoons by default
    "helix_color": "k",
    "strand_color": "k",
    "coil_color": "k",
}

STYLE_EC_COVERAGE = {
    "color": "#d9d7d7",
    "height": 0.8,
    "width": 0.8,
    "margin": 0.5,
}

STYLE_STRUCTURE_COVERAGE = {
    "color": "#83a7c8",
    "height": 0.8,
    "missing_coverage_color": "#dddddd",
    "available_coverage_color": "#ffffff",
}


def find_secondary_structure_segments(sse_string, offset=0):
    """Identify (state, start, end) segments in an H/E/C string.

    Parity: reference pairs.py:1225-1272. "-" (no data) stays a
    distinct state: the cartoon SKIPS those spans instead of drawing
    a coil line across numbering gaps.
    """
    segments = []
    cursor = offset
    for state, run in groupby(sse_string):
        length = sum(1 for _ in run)
        segments.append((state, cursor, cursor + length - 1))
        cursor += length
    return offset, offset + len(sse_string) - 1, segments


def secondary_structure_cartoon(sse, ax=None, sequence_start=0,
                                sequence_end=None, horizontal=True,
                                flip_direction=False, center=0, width=1,
                                helix_turn_length=1,
                                strand_width_factor=0.5, line_width=2,
                                min_sse_length=0, clipping=False,
                                helix_color="k", strand_color="k",
                                coil_color="k", draw_coils=True):
    """Draw a 1D secondary-structure cartoon along an axis: zig-zag for
    helices, arrows for strands, thin lines for coil."""
    ax = _axes(ax)

    def _pos(p):
        # full mirror of the sequence axis when flip_direction is set
        # (negating only the arrow direction drew strands OUTSIDE
        # their segments and left helices/coils unflipped)
        if flip_direction and sequence_end is not None:
            return sequence_end - (p - sequence_start)
        return p

    def _line(seq_coords, off_coords, color, lw):
        # a polyline whose first coordinate runs along the sequence
        # axis; swap for vertical cartoons
        a, b = np.asarray(seq_coords), np.asarray(off_coords)
        xs, ys = (a, b) if horizontal else (b, a)
        ax.plot(xs, ys, color=color, linewidth=lw,
                solid_capstyle="round", clip_on=clip)

    # cartoons sit OUTSIDE the axis limits (plot_secondary_structure
    # places them at max(range) + margin): default clipping would
    # silently erase every artist
    clip = bool(clipping)

    for state, start, end in sse:
        if end - start + 1 < min_sse_length and state not in ("C", "-"):
            state = "C"

        if state == "H":
            # zig-zag helix: alternate between the two edge offsets
            # every half turn
            seq = np.arange(start, end + 0.01, helix_turn_length / 2)
            off = center + np.where(
                np.arange(seq.size) % 2, width / 2, -width / 2
            )
            _line([_pos(s) for s in seq], off, helix_color, line_width)
        elif state == "E":
            # strand: arrow along the (possibly mirrored) sequence
            # direction, drawn through an orientation-generic delta
            tail, tip = _pos(start), _pos(end)
            d_seq = tip - tail
            arrow_args = dict(
                width=width * strand_width_factor,
                head_length=min(1.5, abs(end - start)),
                length_includes_head=True,
                facecolor=strand_color, edgecolor="none",
                clip_on=clip,
            )
            if horizontal:
                ax.arrow(tail, center, d_seq, 0, **arrow_args)
            else:
                ax.arrow(center, tail, 0, d_seq, **arrow_args)
        elif state == "-":
            # no data: draw nothing across the gap
            continue
        elif draw_coils:
            _line([_pos(start), _pos(end)], [center, center],
                  coil_color, line_width / 2)


def _combine_ranges(mode, primary, fallback):
    """One axis extent from the EC-position set and the structure-
    position set under the given boundaries mode; an empty set
    borrows the other's range."""
    ec_rng = _span(primary) if primary else _span(fallback)
    st_rng = _span(fallback) if fallback else _span(primary)
    if mode == "ecs":
        return ec_rng
    if mode == "structure":
        return st_rng
    lows, highs = (ec_rng[0], st_rng[0]), (ec_rng[1], st_rng[1])
    if mode == "union":
        return min(lows), max(highs)
    return max(lows), min(highs)       # intersection


def _span(positions):
    return min(positions), max(positions)


def find_boundaries(boundaries, ecs, monomer, multimer, symmetric):
    """Resolve axis boundaries for a contact map.

    boundaries: "union" | "intersection" | "ecs" | "structure", a
    (min, max) tuple applied to both axes, or [(min_x, max_x),
    (min_y, max_y)]. Returns ((min_x, max_x), (min_y, max_y)).

    Parity: reference visualize/pairs.py:70-192.
    """
    # manual ranges take precedence over data-derived ones
    if isinstance(boundaries, tuple):
        if len(boundaries) != 2:
            raise ValueError(
                "boundaries must be a tuple with 2 elements (min, max)."
            )
        return boundaries, boundaries

    if isinstance(boundaries, list):
        well_formed = (
            len(boundaries) == 2
            and all(len(side) == 2 for side in boundaries)
        )
        if not well_formed:
            raise ValueError(
                "boundaries must be a list of 2 tuples with 2 elements "
                "[(min_x, max_x), (min_y, max_y)]."
            )
        return tuple(boundaries[0]), tuple(boundaries[1])

    _check_boundary_mode(boundaries)

    def _axis_extent(axis):
        ec_pos = set()
        if ecs is not None and len(ecs) > 0:
            cols = (ecs.i, ecs.j) if symmetric else (getattr(ecs, axis),)
            for col in cols:
                ec_pos |= _numeric_set(col)

        structure_pos = set()
        for dm in (monomer, multimer):
            if dm is not None:
                structure_pos |= _numeric_set(
                    getattr(dm, "residues_" + axis).id
                )

        return _combine_ranges(boundaries, ec_pos, structure_pos)

    return _axis_extent("i"), _axis_extent("j")


def set_range(pairs=None, symmetric=True, x=None, y=None,
              ax=None, margin=0, invert_y=True):
    """Set contact-map axis ranges from a pair table and/or explicit
    (min, max) tuples, preserving axis inversion.

    Parity: reference visualize/pairs.py:651-757.
    """
    ax = _axes(ax)

    def _pad(lo, hi):
        return lo - margin, hi + margin

    x_range = y_range = None
    if pairs is not None:
        i, j = pairs.i.astype(int), pairs.j.astype(int)
        if symmetric:
            both = pd.concat([i, j])
            x_range = y_range = _pad(both.min(), both.max())
        else:
            x_range = _pad(i.min(), i.max())
            y_range = _pad(j.min(), j.max())

    if x is not None:
        x_range = _pad(*x)
    if y is not None:
        y_range = _pad(*y)

    if x_range is None or y_range is None:
        raise ValueError(
            "Axis remained unspecified (set pairs or x/y): "
            "x: {} y: {}".format(x_range, y_range)
        )

    # remember orientation before set_*lim resets it
    flip_x = ax.xaxis_inverted()
    flip_y = ax.yaxis_inverted() or invert_y

    ax.set_xlim(x_range)
    ax.set_ylim(y_range)
    if flip_x:
        ax.invert_xaxis()
    if flip_y:
        ax.invert_yaxis()

    ax.yaxis.set_ticks_position("left")
    ax.xaxis.set_ticks_position(
        "top" if ax.yaxis_inverted() else "bottom"
    )

    return x_range, y_range


def scale(style, ax=None):
    """Scale dot size / secondary-structure width in a style dict by
    the linear extent of the plot, so elements keep a constant visual
    size across map lengths. Parity: reference pairs.py:759-785."""
    ax = _axes(ax)
    extent = max(
        abs(np.diff(ax.get_xlim())[0]),
        abs(np.diff(ax.get_ylim())[0]),
    )

    rescaled = deepcopy(style)
    for key, transform in (
        ("s", lambda v: v ** 2 / extent),
        ("width", lambda v: v * extent / 100),
    ):
        if key in rescaled:
            rescaled[key] = transform(rescaled[key])
    return rescaled


def _block(ax, anchor, size_x, size_y, color, clip_on=True):
    """A borderless background rectangle behind the map content."""
    from matplotlib import patches

    ax.add_patch(patches.Rectangle(
        anchor, size_x, size_y, linewidth=0, edgecolor="none",
        facecolor=color, zorder=-10, clip_on=clip_on,
    ))


def plot_ec_coverage(all_ecs, symmetric, style=STYLE_EC_COVERAGE,
                     ax=None):
    """Draw bars alongside the contact map marking the consecutive
    position ranges covered by the EC table.

    Parity: reference visualize/pairs.py:787-863.
    """
    ax = _axes(ax)
    style = style or {}

    pos_i = set(all_ecs.i.values)
    pos_j = set(all_ecs.j.values)
    if symmetric:
        pos_i = pos_j = sorted(pos_i | pos_j)
    else:
        pos_i, pos_j = sorted(pos_i), sorted(pos_j)

    margin = style.get("margin", 0)
    bar = style.get("width", 1)
    color = style.get("color")
    along_x = max(ax.get_ylim()) + margin   # bars above the map
    along_y = max(ax.get_xlim()) + margin   # bars beside the map

    for start, end in find_segments(pos_i):
        _block(ax, (start, along_x), end - start + 1, bar, color,
               clip_on=False)
    for start, end in find_segments(pos_j):
        _block(ax, (along_y, start), bar, end - start + 1, color,
               clip_on=False)


def plot_structure_coverage(structure_coverage,
                            style=STYLE_STRUCTURE_COVERAGE, ax=None):
    """Shade the contact-map background by structural coverage: the
    axes background takes the missing-coverage color, and a rectangle
    in the available-coverage color is drawn for every covered segment
    pair of every structure.

    structure_coverage: list of (coverage_i, coverage_j, coverage_id)
    as returned by DistanceMap.structure_coverage().

    Parity: reference visualize/pairs.py:866-912.
    """
    ax = _axes(ax)
    style = style or {}

    missing = style.get("missing_coverage_color")
    if missing is not None:
        ax.set_facecolor(missing)

    available = style.get("available_coverage_color")
    for coverage_i, coverage_j, _ in structure_coverage:
        for start_i, end_i in coverage_i:
            for start_j, end_j in coverage_j:
                _block(
                    ax, (start_i, start_j),
                    end_i - start_i + 1, end_j - start_j + 1,
                    available,
                )


def plot_secondary_structure(secstruct_i, secstruct_j=None, ax=None,
                             style=None, margin=None):
    """Draw secondary-structure cartoons along both contact-map axes.

    secstruct_i/j: dict position -> "H"/"E"/"C"/"-", or a DataFrame
    with "id" and "sec_struct_3state" columns (Chain.residues /
    DistanceMap.residues_i/j). Call only after the axis orientation of
    the plot has been fixed.

    Parity: reference visualize/pairs.py:915-1044.
    """
    ax = _axes(ax)
    style = style or {}
    if secstruct_j is None:
        secstruct_j = secstruct_i

    def _extract(secstruct, axis_range):
        if isinstance(secstruct, pd.DataFrame):
            if "sec_struct_3state" not in secstruct.columns:
                return None, None, None
            with_ss = secstruct.dropna(subset=["sec_struct_3state"])
            secstruct = dict(zip(
                with_ss.id.astype(int), with_ss.sec_struct_3state
            ))

        # keep only positions inside the plot range (drawing outside
        # the axes creates artifacts)
        lo, hi = min(axis_range), max(axis_range)
        inside = {
            pos: state for pos, state in secstruct.items()
            if lo <= pos < hi
        }
        if not inside:
            return None, None, None

        first, last = min(inside), max(inside) + 1
        sse_str = "".join(
            inside.get(pos, "-") for pos in range(first, last)
        )
        return find_secondary_structure_segments(sse_str, offset=first)

    if margin is None:
        margin = 3 * style.get("width", 1)
    else:
        margin += style.get("width", 1)

    x_range, y_range = ax.get_xlim(), ax.get_ylim()

    # one cartoon per axis: along x the cartoon sits above the map
    # (offset past the y extent), along y beside it (past x)
    for source, source_range, offset_range, along_x in (
        (secstruct_i, x_range, y_range, True),
        (secstruct_j, y_range, x_range, False),
    ):
        start, end, segments = _extract(source, source_range)
        if segments is None:
            continue
        secondary_structure_cartoon(
            segments, ax=ax, sequence_start=start, sequence_end=end,
            horizontal=along_x, center=max(offset_range) + margin,
            **style,
        )


def plot_pairs(pairs, symmetric=False, ax=None, style=None):
    """Scatter a table of (i, j) pairs; optional per-pair color / size
    columns override the style. (Parameter named `pairs` for keyword
    compatibility with the reference, visualize/pairs.py.)"""
    pairs_table = pairs
    ax = _axes(ax)
    style = dict(style or STYLE_EC)

    if pairs_table is None or len(pairs_table) == 0:
        return []

    i = pairs_table.i.astype(float).values
    j = pairs_table.j.astype(float).values

    if "color" in pairs_table.columns:
        style["c"] = pairs_table.color.values
    if "size" in pairs_table.columns:
        sizes = pairs_table["size"].astype(float).values
        base = style.get("s", 80)
        if np.all(sizes <= 1):
            sizes = sizes * base
        style["s"] = sizes

    paths = [ax.scatter(i, j, **style)]
    if symmetric:
        paths.append(ax.scatter(j, i, **style))
    return paths


def _axis_ids(ecs, distance_maps, which):
    """Collect numeric positions present in EC tables / distance maps."""
    ids = set()
    if ecs is not None and len(ecs) > 0:
        ids |= set(pd.to_numeric(ecs.i, errors="coerce").dropna())
        ids |= set(pd.to_numeric(ecs.j, errors="coerce").dropna())
    for dm in distance_maps:
        if dm is None:
            continue
        residues = dm.residues_i if which == "i" else dm.residues_j
        ids |= set(pd.to_numeric(residues.id, errors="coerce").dropna())
    return ids


def plot_contact_map(
        ecs=None, monomer=None, multimer=None, distance_cutoff=5,
        secondary_structure=None, show_secstruct=True,
        ec_coverage=None, show_structure_coverage=False,
        scale_sizes=True, ec_style=STYLE_EC,
        monomer_style=STYLE_CONTACT,
        multimer_style=STYLE_CONTACT_MULTIMER,
        secstruct_style=STYLE_SECSTRUCT,
        ec_coverage_style=STYLE_EC_COVERAGE,
        structure_coverage_style=STYLE_STRUCTURE_COVERAGE, margin=5,
        invert_y=True, boundaries="union", symmetric=True, ax=None):
    """Contact map: structure contacts as background discs, ECs as
    points (green/red split by distance_cutoff when distances known).

    Parity: reference pairs.py:195-391 (same parameters; boundary
    resolution through find_boundaries, size scaling through scale(),
    coverage bars / background through plot_ec_coverage /
    plot_structure_coverage, cartoons through
    plot_secondary_structure).
    """
    ax = _axes(ax)

    # resolve and fix axis boundaries FIRST: size scaling and cartoon
    # placement read the axis extents
    ids_i = _axis_ids(ecs, [monomer, multimer], "i")
    ids_j = _axis_ids(ecs, [monomer, multimer], "j")
    # normalize manual forms for find_boundaries: a scalar pair (from
    # YAML, a list) -> tuple; a pair of per-axis pairs (tuple OR
    # list) -> list of two tuples
    if (isinstance(boundaries, (tuple, list)) and len(boundaries) == 2
            and isinstance(boundaries[0], (tuple, list))):
        boundaries = [tuple(boundaries[0]), tuple(boundaries[1])]
    elif isinstance(boundaries, list) and len(boundaries) == 2:
        boundaries = tuple(boundaries)
    if (len(ids_i) == 0 or len(ids_j) == 0) \
            and isinstance(boundaries, str):
        # a mode string cannot be resolved against an empty axis —
        # fall back to unit extents (after validating the mode)
        _check_boundary_mode(boundaries)
        (min_i, max_i), (min_j, max_j) = (0, 1), (0, 1)
    else:
        (min_i, max_i), (min_j, max_j) = find_boundaries(
            boundaries, ecs, monomer, multimer, symmetric
        )

    ax.set_xlim(min_i - margin, max_i + margin)
    y_lim = (min_j - margin, max_j + margin)
    ax.set_ylim(*(reversed(y_lim) if invert_y else y_lim))

    if scale_sizes:
        ec_style, monomer_style, multimer_style, secstruct_style, \
            ec_coverage_style = (
                scale(s, ax=ax) for s in (
                    ec_style, monomer_style, multimer_style,
                    secstruct_style, ec_coverage_style,
                )
            )

    # background: structural coverage shading, then contacts
    if show_structure_coverage:
        coverage_src = monomer if monomer is not None else multimer
        if coverage_src is not None:
            plot_structure_coverage(
                coverage_src.structure_coverage(),
                style=structure_coverage_style, ax=ax,
            )
    # contacts() already emits BOTH (i, j) and (j, i) for symmetric
    # maps — re-mirroring in plot_pairs double-composited every disc
    for dist_map, disc_style in (
        (monomer, monomer_style), (multimer, multimer_style),
    ):
        if dist_map is not None:
            plot_pairs(
                dist_map.contacts(max_dist=distance_cutoff),
                symmetric=False, ax=ax, style=disc_style,
            )

    # coverage bars of the full EC table alongside the axes
    if ec_coverage is not None and len(ec_coverage) > 0:
        plot_ec_coverage(
            ec_coverage, symmetric, style=ec_coverage_style, ax=ax
        )

    # foreground: ECs (color split by structural distance if available)
    if ecs is not None and len(ecs) > 0:
        ecs = ecs.copy()
        if "color" not in ecs.columns and monomer is not None:
            dists = np.array([
                monomer.dist(i, j, raise_na=False)
                for i, j in zip(ecs.i, ecs.j)
            ])
            if multimer is not None:
                dists_mm = np.array([
                    multimer.dist(i, j, raise_na=False)
                    for i, j in zip(ecs.i, ecs.j)
                ])
                dists = np.fmin(dists, dists_mm)
            color = np.where(dists <= distance_cutoff, "#50a455", "#b2402f")
            color[np.isnan(dists)] = "#404040"
            ecs["color"] = color
        plot_pairs(ecs, symmetric=symmetric, ax=ax, style=ec_style)

    # secondary structure cartoons along both axes (gap-aware, from
    # the explicit table if given, else the distance-map residues)
    if show_secstruct:
        if secondary_structure is not None:
            # accept a Chain (use its residue table), a residue
            # DataFrame, a position -> state dict, or — for
            # asymmetric maps — a (ss_i, ss_j) pair
            if isinstance(secondary_structure, tuple):
                ss_i, ss_j = secondary_structure
                plot_secondary_structure(
                    getattr(ss_i, "residues", ss_i),
                    getattr(ss_j, "residues", ss_j),
                    ax=ax, style=secstruct_style,
                )
            elif not symmetric:
                raise ValueError(
                    "Need one secondary structure per axis for an "
                    "asymmetric map: pass a (ss_i, ss_j) tuple"
                )
            else:
                ss = getattr(
                    secondary_structure, "residues",
                    secondary_structure,
                )
                plot_secondary_structure(
                    ss, ax=ax, style=secstruct_style
                )
        elif monomer is not None:
            plot_secondary_structure(
                monomer.residues_i, monomer.residues_j,
                ax=ax, style=secstruct_style,
            )

    ax.set_xlabel("Position i")
    ax.set_ylabel("Position j")
    ax.set_aspect("equal", adjustable="box")
    return ax


def complex_contact_map(intra1_ecs, intra2_ecs, inter_ecs,
                        d_intra_i, d_multimer_i,
                        d_intra_j, d_multimer_j,
                        d_inter, margin=5, boundaries="union",
                        scale_sizes=True, show_secstruct=True, ax=None):
    """Complex contact map: monomer quadrants on the diagonal blocks,
    inter-molecule ECs/contacts off-diagonal.

    Parity: reference pairs.py:393-579 (same parameters; quadrants
    rendered into one axes with offset positions).
    """
    ax = _axes(ax)

    # determine extents of both monomers, honoring the boundaries
    # mode (previously accepted and silently ignored)
    def _ec_ids(ecs_m, inter_col):
        ids = _axis_ids(ecs_m, [], "i")
        if inter_ecs is not None and len(inter_ecs) > 0:
            ids |= set(pd.to_numeric(
                getattr(inter_ecs, inter_col), errors="coerce"
            ).dropna())
        return ids

    def _extent(ids_ec, ids_st, k):
        if not ids_ec and not ids_st:
            return 0, 1
        if isinstance(boundaries, tuple):
            return boundaries
        if isinstance(boundaries, list):
            return tuple(boundaries[k])
        _check_boundary_mode(boundaries)
        return _combine_ranges(boundaries, ids_ec, ids_st)

    min_1, max_1 = _extent(
        _ec_ids(intra1_ecs, "i"),
        _axis_ids(None, [d_intra_i, d_multimer_i], "i"), 0,
    )
    min_2, max_2 = _extent(
        _ec_ids(intra2_ecs, "j"),
        _axis_ids(None, [d_intra_j, d_multimer_j], "i"), 1,
    )

    # second monomer drawn offset after the first
    offset_2 = max_1 + 2 * margin - min_2

    # fix the full extents first so size scaling and cartoons can
    # read them
    lo = min_1 - margin
    hi = max_2 + offset_2 + margin

    def _full_extents():
        ax.set_xlim(lo, hi)
        ax.set_ylim(hi, lo)

    _full_extents()

    styles = {
        "ec": STYLE_EC, "contact": STYLE_CONTACT,
        "multimer": STYLE_CONTACT_MULTIMER,
        "secstruct": STYLE_SECSTRUCT,
    }
    if scale_sizes:
        styles = {k: scale(v, ax=ax) for k, v in styles.items()}

    def _shift(table, cols, offset):
        if table is None or len(table) == 0:
            return None
        table = table.copy()
        for c in cols:
            # whole-column assignment: the source column may be a
            # string dtype (DistanceMap residue ids), which .loc
            # refuses to overwrite with numerics under pandas >= 2
            table[c] = pd.to_numeric(table[c], errors="coerce") + offset
        return table

    # monomer 1 block (no scaling inside: styles already scaled to
    # the full complex extents here)
    plot_contact_map(
        intra1_ecs, d_intra_i, d_multimer_i,
        show_secstruct=False, scale_sizes=False, margin=margin,
        boundaries=(min_1, max_1), invert_y=False, ax=ax,
        ec_style=styles["ec"], monomer_style=styles["contact"],
        multimer_style=styles["multimer"],
    )
    # plot_contact_map narrows the limits to the monomer-1 block;
    # restore the full complex extents
    _full_extents()

    # monomer 2 block (shifted): intra + multimer contacts, then ECs.
    # contacts() already carries both orientations.
    for dist_map, disc_style in (
        (d_intra_j, styles["contact"]), (d_multimer_j, styles["multimer"]),
    ):
        if dist_map is not None:
            plot_pairs(
                _shift(dist_map.contacts(), ["i", "j"], offset_2),
                symmetric=False, ax=ax, style=disc_style,
            )
    plot_pairs(
        _shift(intra2_ecs, ["i", "j"], offset_2),
        symmetric=True, ax=ax, style=styles["ec"],
    )

    # inter quadrant: i from monomer 1, j from monomer 2 (shifted);
    # each inter table is drawn in both orientations
    def _both_orientations(table, point_style):
        if table is None:
            return
        plot_pairs(table, symmetric=False, ax=ax, style=point_style)
        plot_pairs(
            table.rename(columns={"i": "j", "j": "i"}),
            symmetric=False, ax=ax, style=point_style,
        )

    if d_inter is not None:
        _both_orientations(
            _shift(d_inter.contacts(), ["j"], offset_2),
            styles["contact"],
        )
    _both_orientations(
        _shift(inter_ecs, ["j"], offset_2), styles["ec"]
    )

    # secondary-structure cartoons: monomer 1 in place, monomer 2
    # shifted into its block
    if show_secstruct:
        def _ss_dict(dm, offset):
            res = dm.residues_i
            if "sec_struct_3state" not in res.columns:
                return None
            res = res.dropna(subset=["sec_struct_3state"])
            if len(res) == 0:
                return None
            # residue ids may be strings with non-numeric entries
            # (insertion codes) — coerce like _shift above
            pos_num = pd.to_numeric(res.id, errors="coerce")
            return {
                int(pos) + offset: state for pos, state in zip(
                    pos_num, res.sec_struct_3state
                ) if pd.notna(pos)
            }

        ss = {}
        for dist_map, offset in ((d_intra_i, 0), (d_intra_j, offset_2)):
            if dist_map is not None:
                ss.update(_ss_dict(dist_map, offset) or {})
        if ss:
            plot_secondary_structure(
                ss, ax=ax, style=styles["secstruct"]
            )

    _full_extents()
    ax.set_aspect("equal", adjustable="box")
    return ax
