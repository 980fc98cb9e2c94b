"""
Carry parameters from the JAX package into the port.

The JAX package's fits and models hold their parameters as numpy arrays
(a PlmFitResult's J_ij / h_i, a CouplingsModel's arrays). These helpers
take those arrays, never the JAX package's classes by import, and turn
them into the port's tensors and CouplingsModel, so that tests can feed
both packages the same parameters.
"""

import numpy as np
import torch

from evcouplings_torch.couplings.model import CouplingsModel
from evcouplings_torch.ops.encode import flatten_J

# attributes a CouplingsModel carries (both packages name them alike)
_MODEL_FIELDS = (
    "J_ij", "h_i", "f_i", "f_ij", "alphabet", "target_seq", "index_list",
    "weights", "theta", "lambda_h", "lambda_J", "lambda_group", "N_valid",
    "N_invalid", "num_iter", "N_eff",
)


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


def model_from_jax(model_or_arrays):
    """A JAX-package CouplingsModel (or any object / mapping with its
    array attributes) -> the port's CouplingsModel."""
    if isinstance(model_or_arrays, dict):
        get = model_or_arrays.__getitem__
    else:
        def get(name):
            return getattr(model_or_arrays, name)
    kw = {name: get(name) for name in _MODEL_FIELDS}
    kw["J_ij"] = np.asarray(kw["J_ij"], dtype=np.float64)
    kw["h_i"] = np.asarray(kw["h_i"], dtype=np.float64)
    kw["alphabet"] = "".join(np.asarray(kw["alphabet"]).astype(str))
    kw["target_seq"] = "".join(np.asarray(kw["target_seq"]).astype(str))
    return CouplingsModel.from_params(**kw)
