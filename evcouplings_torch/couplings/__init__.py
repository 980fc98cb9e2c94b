"""Potts-model containers and the plmc-replacement fitter. The package
star-exports its submodules, as the JAX package's couplings/__init__.py
does, so reference-style imports like `from evcouplings.couplings import
CouplingsModel` resolve through the compat alias."""

from evcouplings_torch.couplings.mapping import *  # noqa: F401,F403
from evcouplings_torch.couplings.model import *  # noqa: F401,F403
from evcouplings_torch.couplings.pairs import *  # noqa: F401,F403
from evcouplings_torch.couplings.tools import *  # noqa: F401,F403
from evcouplings_torch.couplings.mean_field import *  # noqa: F401,F403
