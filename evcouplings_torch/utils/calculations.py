"""
Calculation helpers (the part of evcouplings_tpu/utils/calculations.py
the port uses): column entropies of frequency matrices and the median
absolute deviation. Small host-side numpy helpers.
"""

import numpy as np


def entropy_rows(F, normalize=False):
    """Vectorized row-wise entropy of an (L x q) frequency matrix."""
    F = np.asarray(F, dtype=float)
    logF = np.where(F > 0, np.log2(np.where(F > 0, F, 1.0)), 0.0)
    H = -np.sum(np.where(F > 0, F, 0.0) * logF, axis=-1)
    if normalize:
        return 1 - (H / np.log2(F.shape[-1]))
    return H


def entropy_vector(model, normalize=True):
    """Positional entropies for single-site frequencies in a CouplingsModel."""
    return entropy_rows(model.fi(), normalize=normalize)


def entropy_map(model, normalize=True):
    """Map from position (model numbering) to column entropy."""
    return dict(zip(
        model.index_list, entropy_vector(model, normalize)
    ))


def median_absolute_deviation(x, scale=1.4826):
    """Scaled median absolute deviation (default scale matches Gaussian SD)."""
    spread = np.abs(x - np.median(x))
    return scale * np.median(spread)
