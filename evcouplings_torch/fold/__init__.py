"""The fold stage (port of evcouplings_tpu/fold): star-exports its
submodules, as the JAX package's fold/__init__.py does."""

from evcouplings_torch.fold.tools import *  # noqa: F401,F403
from evcouplings_torch.fold.cns import *  # noqa: F401,F403
from evcouplings_torch.fold.filter import *  # noqa: F401,F403
from evcouplings_torch.fold.restraints import *  # noqa: F401,F403
from evcouplings_torch.fold.protocol import *  # noqa: F401,F403
from evcouplings_torch.fold.ranking import *  # noqa: F401,F403
