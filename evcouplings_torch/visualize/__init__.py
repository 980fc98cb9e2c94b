"""Visualization of the port's stage outputs: Pymol scripts, EVzoom JSON,
contact maps and mutation-effect matrices. The package star-exports its
submodules, as the JAX package's visualize/__init__.py does."""

from evcouplings_torch.visualize.parameters import *  # noqa: F401,F403
from evcouplings_torch.visualize.pairs import *  # noqa: F401,F403
from evcouplings_torch.visualize.mutations import *  # noqa: F401,F403
from evcouplings_torch.visualize.misc import *  # noqa: F401,F403
from evcouplings_torch.visualize.pymol import *  # noqa: F401,F403
