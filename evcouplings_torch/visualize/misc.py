"""
Shared visualization helpers (port of evcouplings_tpu/visualize/misc.py):
the style context, chart-junk removal and color mapping. matplotlib is
imported on use: the module loads on a machine without it.
"""


def plot_context(font="Helvetica", size=12, axis_label_size=12,
                 axis_title_size=14, axis_line_width=1,
                 tick_label_size=12, tick_direction="out", dpi=300,
                 additional_param_dict=None):
    """matplotlib rc_context with sensible publication-figure defaults."""
    import matplotlib as mpl

    per_axis = {
        "{}tick.{}".format(axis, prop): value
        for axis in "xy"
        for prop, value in (("labelsize", tick_label_size),
                            ("direction", tick_direction))
    }
    rc_params = {
        **per_axis,
        "figure.dpi": dpi,
        "savefig.dpi": dpi,
        "font.family": font,
        "font.size": size,
        "axes.labelsize": axis_label_size,
        "axes.titlesize": axis_title_size,
        "axes.linewidth": axis_line_width,
        "savefig.bbox": "tight",
        "pdf.fonttype": 42,  # embed editable TrueType text
        **(additional_param_dict or {}),
    }
    return mpl.rc_context(rc_params)


def remove_chart_junk(ax=None, remove=("top", "right"),
                      x_ticks_loc="bottom", y_ticks_loc="left",
                      hide_x_labels=False, hide_y_labels=False):
    """Remove spines/ticks for a cleaner plot."""
    import matplotlib.pyplot as plt

    ax = plt.gca() if ax is None else ax

    for edge in remove:
        ax.spines[edge].set_visible(False)

    for axis, location, hidden in (
        (ax.xaxis, x_ticks_loc, hide_x_labels),
        (ax.yaxis, y_ticks_loc, hide_y_labels),
    ):
        axis.set_ticks_position(location)
        if hidden:
            plt.setp(axis.get_ticklabels(), visible=False)


def rgb2hex(r, g, b, a=None):
    """RGB fractions (0-1) to "#rrggbb" (alpha ignored)."""
    return "#{:02x}{:02x}{:02x}".format(
        *(int(255 * channel) for channel in (r, g, b))
    )


def colormap(min_value, max_value, colormap=None, to_hex=True):
    """Value -> color mapping function over [min_value, max_value]."""
    import matplotlib as mpl
    import matplotlib.pyplot as plt

    mapper = plt.cm.ScalarMappable(
        norm=mpl.colors.Normalize(vmin=min_value, vmax=max_value),
        cmap=plt.cm.RdBu_r if colormap is None else colormap,
    )
    if to_hex:
        return lambda value: rgb2hex(*mapper.to_rgba(value))
    return mapper.to_rgba
