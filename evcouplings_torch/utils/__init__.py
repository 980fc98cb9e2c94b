"""
Shared utilities (port of evcouplings_tpu/utils/__init__.py): config,
system helpers, batch submitters, trackers, and the submitter factory.
"""

import abc

# the package star-exports its submodules, in the JAX package's order, so
# reference-style imports like `from evcouplings_torch.utils import
# read_config_file` resolve here; batch and tracker both define EStatus,
# and the tracker's (imported last) is the one this package exports
from evcouplings_torch.utils.calculations import *  # noqa: F401,F403
from evcouplings_torch.utils.config import *  # noqa: F401,F403
from evcouplings_torch.utils.helpers import *  # noqa: F401,F403
from evcouplings_torch.utils.system import *  # noqa: F401,F403
from evcouplings_torch.utils.batch import *  # noqa: F401,F403
from evcouplings_torch.utils.constants import *  # noqa: F401,F403
from evcouplings_torch.utils.tracker import *  # noqa: F401,F403

from evcouplings_torch import BailoutException  # noqa: F401
from evcouplings_torch.utils.batch import ASubmitter  # noqa: F401
from evcouplings_torch.utils.helpers import PersistentDict  # noqa: F401


class ASubmitterFactory(abc.ABCMeta):
    def __init__(cls, name, bases, nmspc):
        type.__init__(cls, name, bases, nmspc)

    def __call__(cls, _name, *args, **kwargs):
        try:
            return ASubmitter[str(_name).lower()](**kwargs)
        except KeyError:
            raise ValueError("This submitter is currently not supported")


class SubmitterFactory(metaclass=ASubmitterFactory):
    """Instantiate a registered submitter by name
    (SubmitterFactory("local", ...))."""

    @staticmethod
    def available_methods():
        """Names of all registered submitters."""
        return list(ASubmitter.registry.keys())
