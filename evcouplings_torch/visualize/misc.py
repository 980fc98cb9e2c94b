"""
Color mapping helpers (the subset of evcouplings_tpu/visualize/misc.py
that the mutation scripts use). matplotlib is imported on use.
"""


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
