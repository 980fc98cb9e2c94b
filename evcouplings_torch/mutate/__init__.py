"""Mutation-effect (EVmutation) calculations and the mutate stage; the
package star-exports its submodules, as the JAX package's
mutate/__init__.py does."""

from evcouplings_torch.mutate.calculations import *  # noqa: F401,F403
from evcouplings_torch.mutate.protocol import *  # noqa: F401,F403
