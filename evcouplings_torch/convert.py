"""
Carry parameters and fit state from the JAX package into the port.

The JAX package's fits and models hold their parameters as numpy arrays
(a PlmFitResult's J_ij / h_i, a CouplingsModel's arrays, a fit snapshot's
npz arrays). These helpers take those arrays, never the JAX package's
classes by import, and turn them into the port's tensors, models and
resume state, so that tests can feed both packages the same state.
"""

import os

import numpy as np
import torch

from evcouplings_torch.couplings.mean_field import MeanFieldCouplingsModel
from evcouplings_torch.couplings.model import CouplingsModel
from evcouplings_torch.ops.encode import flatten_J
from evcouplings_torch.ops.plm import restore_snapshot, snapshot_arrays

# attributes a CouplingsModel carries (both packages name them alike)
_MODEL_FIELDS = (
    "J_ij", "h_i", "f_i", "f_ij", "alphabet", "target_seq", "index_list",
    "weights", "theta", "lambda_h", "lambda_J", "lambda_group", "N_valid",
    "N_invalid", "num_iter", "N_eff",
)
# the further arrays of a mean-field model
_MEAN_FIELD_FIELDS = ("regularized_f_i", "regularized_f_ij", "pseudo_count")


def params_from_jax(J_ij, h_i, device="cpu", dtype=torch.float64):
    """(L, L, q, q) couplings and (L, q) fields as numpy arrays ->
    the port's fit parameters {"J": (Lq, Lq), "h": (L, q)} tensors."""
    J_ij = np.asarray(J_ij, dtype=np.float64)
    h_i = np.asarray(h_i, dtype=np.float64)
    return {
        "J": flatten_J(torch.as_tensor(J_ij)).to(device=device, dtype=dtype)
        .contiguous(),
        "h": torch.as_tensor(h_i).to(device=device, dtype=dtype),
    }


def model_from_jax(model_or_arrays, device=None):
    """A JAX-package CouplingsModel or MeanFieldCouplingsModel (or any
    object / mapping with its array attributes) -> the port's model. A
    source with regularized frequencies and a pseudo-count gives a
    MeanFieldCouplingsModel, whose DI runs on `device`."""
    if isinstance(model_or_arrays, dict):
        get = model_or_arrays.get
    else:
        def get(name):
            return getattr(model_or_arrays, name, None)
    kw = {name: get(name) for name in _MODEL_FIELDS}
    kw["J_ij"] = np.asarray(kw["J_ij"], dtype=np.float64)
    kw["h_i"] = np.asarray(kw["h_i"], dtype=np.float64)
    kw["alphabet"] = "".join(np.asarray(kw["alphabet"]).astype(str))
    kw["target_seq"] = "".join(np.asarray(kw["target_seq"]).astype(str))
    if get("regularized_f_i") is not None:
        kw.update({name: get(name) for name in _MEAN_FIELD_FIELDS})
        return MeanFieldCouplingsModel.from_params(device=device, **kw)
    return CouplingsModel.from_params(**kw)


def snapshot_from_jax(snapshot, solver, L, q, device="cpu",
                      dtype=torch.float32, memory_size=5):
    """A symmetric fit's snapshot as the JAX package writes it (an .npz
    path, or a mapping of its arrays) -> the port's resume state (params,
    solver state or None, iteration), as ops/plm.fit_plm restores it."""
    if isinstance(snapshot, (str, os.PathLike)):
        snapshot = np.load(snapshot)
    return restore_snapshot(snapshot, solver, L, q, dtype, device,
                            memory_size)


def snapshot_to_jax(solver, params, state, iteration, fingerprint=None):
    """The port's fit state -> the snapshot arrays the JAX package reads
    (np.savez them to resume there)."""
    return snapshot_arrays(solver, params, state, iteration, fingerprint)
