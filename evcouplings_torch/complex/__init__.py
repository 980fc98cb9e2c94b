"""complex package (port of evcouplings_tpu/complex): star-exports its
submodules as the JAX package's __init__ does."""

from evcouplings_torch.complex.protocol import *  # noqa: F401,F403
from evcouplings_torch.complex.alignment import *  # noqa: F401,F403
from evcouplings_torch.complex.distance import *  # noqa: F401,F403
from evcouplings_torch.complex.similarity import *  # noqa: F401,F403
