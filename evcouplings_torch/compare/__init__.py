"""compare package (port of evcouplings_tpu/compare): star-exports its
submodules as the JAX package does."""

from evcouplings_torch.compare.ecs import *  # noqa: F401,F403
from evcouplings_torch.compare.distances import *  # noqa: F401,F403
from evcouplings_torch.compare.mapping import *  # noqa: F401,F403
from evcouplings_torch.compare.pdb import *  # noqa: F401,F403
from evcouplings_torch.compare.sifts import *  # noqa: F401,F403
