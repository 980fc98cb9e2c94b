"""
Calculation helpers (port of evcouplings_tpu/utils/calculations.py):
entropies of distributions and of frequency matrices' columns, the
dihedral angle of four points (the fold stage's model ranking) and the
median absolute deviation. Small host-side numpy helpers in float64.
"""

import numpy as np


def entropy(X, normalize=False):
    """Shannon entropy (log2) of a distribution vector.

    With ``normalize=True``, returns conservation in [0, 1]
    (1 = fully conserved), computed as 1 - H / log2(len(X)).
    """
    X = np.asarray(X, dtype=float)
    support = X[X > 0]
    H = -np.sum(support * np.log2(support))

    return 1 - (H / np.log2(len(X))) if normalize else H


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


def dihedral_angle(p0, p1, p2, p3):
    """Dihedral/torsion angle (radians) defined by four 3D points."""
    bond_back = -1.0 * (p1 - p0)
    axis = p2 - p1
    bond_fwd = p3 - p2

    axis = axis / np.linalg.norm(axis)

    # vector rejections of the outer bonds onto the plane
    # perpendicular to the central axis
    rej_back = bond_back - np.dot(bond_back, axis) * axis
    rej_fwd = bond_fwd - np.dot(bond_fwd, axis) * axis

    return np.arctan2(
        np.dot(np.cross(axis, rej_back), rej_fwd),
        np.dot(rej_back, rej_fwd),
    )


def median_absolute_deviation(x, scale=1.4826):
    """Scaled median absolute deviation (default scale matches Gaussian SD)."""
    spread = np.abs(x - np.median(x))
    return scale * np.median(spread)
