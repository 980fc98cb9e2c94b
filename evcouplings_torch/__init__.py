"""
evcouplings_torch — the evolutionary-couplings framework on PyTorch and
hand-written CUDA/Triton kernels for NVIDIA Hopper (H100).

A port of `evcouplings_tpu` that keeps its module paths, public names and
artifact formats (plmc_v2 `.model` files, raw EC files). It never imports
JAX or the JAX package. Entry points run on the CUDA device unless the
caller passes ``device="cpu"``; on the CPU every kernel is replaced by its
plain PyTorch version.
"""

from evcouplings_torch._device import resolve_device

__all__ = ["resolve_device"]
