"""
evcouplings_torch — the evolutionary-couplings framework on PyTorch and
hand-written CUDA/Triton kernels for NVIDIA Hopper (H100).

A port of `evcouplings_tpu` that keeps its module paths, public names and
artifact formats (plmc_v2 `.model` files, raw EC files, the pipeline's
config/outcfg chaining). It never imports JAX or the JAX package. Entry
points run on the CUDA device unless the caller passes ``device="cpu"``
(a job config: ``device: cpu``); on the CPU every kernel is replaced by
its plain PyTorch version.
"""

from evcouplings_torch._device import resolve_device

__version__ = "0.1.0"

# the JAX package's subpackages (a star-import loads each on demand; a
# plain import loads none of them), plus device selection
__all__ = [
    "align", "compare", "complex", "couplings", "fold", "mutate",
    "visualize", "utils", "ops", "parallel", "resolve_device",
]


class BailoutException(Exception):
    """Deliberate early-exit from a pipeline (e.g. no significant couplings)."""
