"""
EC visualization (the part of evcouplings_tpu/visualize/pairs.py the
couplings stage calls): the Pymol line and enrichment script writers.
The contact-map plots wait for the compare stage.
"""

from copy import deepcopy

import numpy as np
import pandas as pd

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
