"""align package: star-exports its submodules, as the JAX package's
align/__init__.py does."""

from evcouplings_torch.align.alignment import *  # noqa: F401,F403
from evcouplings_torch.align.pfam import *  # noqa: F401,F403
from evcouplings_torch.align.protocol import *  # noqa: F401,F403
from evcouplings_torch.align.tools import *  # noqa: F401,F403
from evcouplings_torch.align.ena import *  # noqa: F401,F403
