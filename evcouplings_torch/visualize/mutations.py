"""
Mutation-effect matrix visualization and Pymol mapping (port of
evcouplings_tpu/visualize/mutations.py): plot_mutation_matrix,
matrix_base_mpl, matrix_base_bokeh (optional), mutation_pymol_script.

matplotlib is imported inside the functions that draw or map colors,
so the module imports on a machine without it.
"""

import numpy as np
import pandas as pd

from evcouplings_torch.couplings.model import CouplingsModel
from evcouplings_torch.mutate.calculations import split_mutants
from evcouplings_torch.utils.calculations import entropy_vector
from evcouplings_torch.visualize.misc import colormap as make_colormap
from evcouplings_torch.visualize.pymol import pymol_mapping

# substitutions ordered by amino-acid property
AA_LIST_PROPERTY = "WFYPMILVAGCSTQNDEHRK"


def plot_mutation_matrix(source, mutant_column="mutant",
                         effect_column="prediction_epistatic",
                         conservation_column="column_conservation",
                         order=AA_LIST_PROPERTY,
                         min_value=None, max_value=None,
                         min_percentile=None, max_percentile=None,
                         show_conservation=False,
                         secondary_structure=None, engine="mpl",
                         **matrix_style):
    """Plot a single-substitution mutation matrix from a CouplingsModel
    or a mutation-effect DataFrame (mutations in "A100V" format)."""
    conservation = None

    if isinstance(source, CouplingsModel):
        matrix = source.smm()
        positions = source.index_list
        substitutions = source.alphabet
        wildtype_sequence = source.seq()
        if show_conservation:
            conservation = entropy_vector(source)
    else:
        source = split_mutants(source, mutant_column).query(
            "num_mutations == 1"
        )
        source = source.assign(
            pos=pd.to_numeric(source.pos).astype(int),
            **{effect_column: pd.to_numeric(
                source[effect_column], errors="coerce"
            )},
        )

        substitutions = sorted(source.subs.unique())
        source_grp = (
            source.groupby("pos").first().reset_index()
            .sort_values(by="pos")
        )
        positions = source_grp.pos.values
        wildtype_sequence = source_grp.wt.values
        if show_conservation:
            conservation = pd.to_numeric(
                source_grp[conservation_column], errors="coerce"
            ).values

        matrix = np.full((len(positions), len(substitutions)), np.nan)
        pos_to_i = {p: i for i, p in enumerate(positions)}
        subs_to_j = {s: j for j, s in enumerate(substitutions)}
        for _, r in source.iterrows():
            matrix[pos_to_i[r["pos"]], subs_to_j[r["subs"]]] = (
                r[effect_column]
            )

    # reorder substitution axis
    if order is not None:
        matrix_final = np.full((len(positions), len(order)), np.nan)
        substitutions_list = list(substitutions)
        for i, subs in enumerate(order):
            if subs in substitutions_list:
                matrix_final[:, i] = (
                    matrix[:, substitutions_list.index(subs)]
                )
        substitutions = list(order)
    else:
        matrix_final = matrix

    # colormap range (symmetric by default)
    effects = matrix_final.ravel()
    effects = effects[np.isfinite(effects)]

    if min_percentile is not None:
        min_value = np.percentile(effects, min_percentile)
    if max_percentile is not None:
        max_value = np.percentile(effects, max_percentile)

    if min_value is None and max_value is None:
        bound = np.abs(effects).max()
        min_value, max_value = -bound, bound
    elif min_value is None:
        min_value = effects.min()
    elif max_value is None:
        max_value = effects.max()

    if engine == "mpl":
        return matrix_base_mpl(
            matrix_final, positions, substitutions,
            conservation=conservation,
            secondary_structure=secondary_structure,
            wildtype_sequence=wildtype_sequence,
            min_value=min_value, max_value=max_value,
            **matrix_style,
        )
    elif engine == "bokeh":
        return matrix_base_bokeh(
            matrix_final, positions, substitutions,
            wildtype_sequence=wildtype_sequence,
            min_value=min_value, max_value=max_value,
            **matrix_style,
        )
    else:
        raise ValueError(
            "Invalid plotting engine: {}. Valid options: mpl, bokeh".format(
                engine
            )
        )


def matrix_base_mpl(matrix, positions, substitutions, conservation=None,
                    secondary_structure=None, wildtype_sequence=None,
                    min_value=None, max_value=None, ax=None,
                    colormap=None, colormap_conservation=None,
                    na_color="#bbbbbb", title=None,
                    position_label_size=8, substitution_label_size=8,
                    show_colorbar=True, colorbar_indicate_bounds=False,
                    show_wt_char=True, label_filter=None,
                    secondary_structure_style=None):
    """Static matplotlib heatmap of a (positions x substitutions)
    mutation-effect matrix, with wild-type markers and an optional
    conservation strip below (the JAX package's keyword surface:
    label_filter drops position labels, colorbar_indicate_bounds adds
    <=/>= to the colorbar extremes; a secondary-structure cartoon,
    secondary_structure and its style, is not ported yet)."""
    import matplotlib.pyplot as plt

    if secondary_structure is not None:
        # the cartoon is drawn by the contact-map plotting code, which
        # is ported with the compare stage
        raise NotImplementedError(
            "secondary-structure cartoons are not ported yet (ROADMAP "
            "A14, compare stage)")

    if colormap is None:
        colormap = plt.cm.RdBu_r
    if colormap_conservation is None:
        colormap_conservation = plt.cm.Oranges

    num_pos = len(positions)
    num_subs = len(substitutions)

    if ax is None:
        extra_rows = 1.5 if conservation is not None else 0
        plt.figure(figsize=(
            max(4.0, num_pos * 0.2), (num_subs + extra_rows) * 0.2 + 1.2
        ))
        ax = plt.gca()

    cmap = colormap.copy()
    cmap.set_bad(color=na_color)

    # (subs, pos) orientation: positions along x
    data = np.ma.masked_invalid(matrix.T)
    mesh = ax.pcolormesh(
        data, cmap=cmap, vmin=min_value, vmax=max_value,
        edgecolors="white", linewidth=0.3,
    )

    ax.set_xticks(np.arange(num_pos) + 0.5)
    if wildtype_sequence is not None and show_wt_char:
        xlabels = [
            "{}{}".format(wt, p)
            for wt, p in zip(wildtype_sequence, positions)
        ]
    else:
        xlabels = [str(p) for p in positions]
    if label_filter is not None:
        xlabels = [
            lbl if label_filter(pos) else ""
            for lbl, pos in zip(xlabels, positions)
        ]
    ax.set_xticklabels(xlabels, rotation=90, size=position_label_size)

    ax.set_yticks(np.arange(num_subs) + 0.5)
    ax.set_yticklabels(substitutions, size=substitution_label_size)
    ax.invert_yaxis()

    # mark the wild-type cell of each column with a dot
    if wildtype_sequence is not None:
        subs_to_j = {s: j for j, s in enumerate(substitutions)}
        for i, wt in enumerate(wildtype_sequence):
            if wt in subs_to_j:
                ax.plot(
                    i + 0.5, subs_to_j[wt] + 0.5, ".",
                    color="black", markersize=3,
                )

    if conservation is not None:
        for i, c in enumerate(np.asarray(conservation, dtype=float)):
            if np.isfinite(c):
                ax.add_patch(plt.Rectangle(
                    (i, num_subs + 0.5), 1, 1,
                    color=colormap_conservation(c),
                ))
        ax.set_ylim(num_subs + 1.6, 0)

    if title is not None:
        ax.set_title(title)
    if show_colorbar:
        cb = plt.colorbar(mesh, ax=ax, shrink=0.6, pad=0.02)
        if (colorbar_indicate_bounds
                and min_value is not None and max_value is not None):
            # clipped colormap: mark the extremes as bounds
            cb.set_ticks([min_value, max_value])
            cb.ax.set_yticklabels([
                u"\u2264 {:+.1f}".format(min_value),
                u"\u2265 {:+.1f}".format(max_value),
            ])

    return ax


def matrix_base_bokeh(matrix, positions, substitutions,
                      wildtype_sequence=None, label_size=8,
                      min_value=None, max_value=None,
                      colormap=None, na_color="#bbbbbb", title=None):
    """Interactive bokeh heatmap of a mutation-effect matrix (with
    hover tooltips). Requires the optional bokeh package."""
    import matplotlib.pyplot as plt

    try:
        from bokeh import plotting as bp
        from bokeh.models import HoverTool
    except ImportError as e:
        raise ImportError(
            "matrix_base_bokeh requires the optional bokeh package; "
            "use engine='mpl' instead."
        ) from e

    if colormap is None:
        colormap = plt.cm.RdBu_r
    if min_value is None or max_value is None:
        finite = matrix[np.isfinite(matrix)]
        bound = np.abs(finite).max()
        min_value = -bound if min_value is None else min_value
        max_value = bound if max_value is None else max_value

    mapper = make_colormap(min_value, max_value, colormap)

    rows = []
    for i, pos in enumerate(positions):
        wt = (
            wildtype_sequence[i] if wildtype_sequence is not None else ""
        )
        for j, subs in enumerate(substitutions):
            value = matrix[i, j]
            rows.append({
                "pos": "{}{}".format(wt, pos),
                "subs": subs,
                "effect": None if not np.isfinite(value) else value,
                "color": na_color if not np.isfinite(value)
                else mapper(value),
                "mutant": "{}{}{}".format(wt, pos, subs),
            })
    df = pd.DataFrame(rows)

    x_range = list(dict.fromkeys(df.pos))
    y_range = list(substitutions)[::-1]

    fig = bp.figure(
        title=title, x_range=x_range, y_range=y_range,
        x_axis_location="above",
        tools="hover,save,pan,box_zoom,wheel_zoom,reset",
        width=max(400, 12 * len(x_range)), height=12 * len(y_range) + 120,
    )
    fig.rect(
        "pos", "subs", 1, 1, source=bp.ColumnDataSource(df),
        color="color", line_color="white",
    )
    fig.xaxis.major_label_orientation = np.pi / 2
    fig.axis.major_label_text_font_size = "{}pt".format(label_size)

    hover = fig.select_one(HoverTool)
    hover.tooltips = [("mutant", "@mutant"), ("effect", "@effect")]
    return fig


def mutation_pymol_script(mutation_table, output_file,
                          effect_column="prediction_epistatic",
                          mutant_column="mutant", agg_func="mean",
                          cmap=None, segment_to_chain_mapping=None):
    """Pymol script mapping aggregated per-position mutation effects
    onto a structure (spheres colored by effect), one block per
    segment."""
    import matplotlib.pyplot as plt

    if cmap is None:
        cmap = plt.cm.RdBu_r

    t = split_mutants(mutation_table, mutant_column)
    t = t.query("num_mutations == 1")

    if len(t) == 0:
        raise ValueError(
            "mutation_table does not contain any single "
            "amino acid substitutions."
        )

    if "segment" not in t.columns:
        t = t.assign(segment=None)

    with open(output_file, "w") as f:
        # NaN segments -> sentinel string so groupby keeps them; only
        # the segment column (a whole-frame fillna would inject
        # strings into the numeric effect column and crash the
        # groupby mean below)
        t = t.assign(segment=t.segment.fillna("none"))
        for segment_name, seg_t in t.groupby("segment"):
            if segment_to_chain_mapping is None:
                chain = None
            elif isinstance(segment_to_chain_mapping, str):
                chain = segment_to_chain_mapping
            elif segment_name not in segment_to_chain_mapping:
                raise ValueError(
                    "Segment name {} has no mapping to PyMOL chain. "
                    "Available mappings are: {}".format(
                        segment_name, segment_to_chain_mapping
                    )
                )
            else:
                chain = segment_to_chain_mapping[segment_name]

            seg_t = seg_t.loc[:, ["pos", effect_column]].rename(
                columns={"pos": "i", effect_column: "effect"}
            )
            t_agg = seg_t.groupby("i").agg(agg_func).reset_index()
            t_agg = t_agg.assign(i=pd.to_numeric(t_agg.i).astype(int))

            max_val = t_agg.effect.abs().max()
            mapper = make_colormap(-max_val, max_val, cmap)
            t_agg = t_agg.assign(
                color=t_agg.effect.map(mapper), show="spheres"
            )

            chain_sel = (
                ", chain '{}'".format(chain) if chain is not None else ""
            )
            f.write("as cartoon{}\n".format(chain_sel))
            pymol_mapping(t_agg, f, chain)
