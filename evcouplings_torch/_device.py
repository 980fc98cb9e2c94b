"""Device resolution and matmul precision shared by the port's entry
points."""

import contextlib

import torch

# matmul precision names accepted by the fits (the JAX package's set), each
# with the number of bfloat16 limbs that the float32 operand of the fits'
# products is split into: the JAX package's own definition of its names
# (evcouplings_tpu/ops/plm.py, _PrecTriple / _precision), where DEFAULT
# takes 1 limb, HIGH 2 and HIGHEST 3. The other operand of those products
# (the one-hot) is exactly bfloat16 and takes one limb. Three limbs hold a
# float32 value exactly (8 + 8 + 8 significant bits), so "highest" forms
# the products of IEEE float32 and is IEEE float32 here (None). The
# unstructured names give the same numbers as the structured ones (the
# exact operand's extra limbs are zero) and take the same route. XLA on a
# GPU may lower HIGH to TF32; the port follows the limb definition, and no
# product of the port runs in TF32.
_LIMBS = {"highest": None, "high": 2, "default": 1,
          "highest_unstructured": None, "high_unstructured": 2}
PRECISIONS = tuple(_LIMBS)


def resolve_device(device=None):
    """The torch.device an entry point runs on.

    None means the CUDA device. Without one this raises instead of
    falling back to the CPU: a fit that silently ran on the host would
    look like a working GPU run. Pass device="cpu" to run on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "No CUDA device is available; pass device='cpu' to run "
                "on the CPU."
            )
        return torch.device("cuda")
    return torch.device(device)


def precision_limbs(precision):
    """bfloat16 limbs of the float32 operand of a fit's products at this
    precision name: 1 ("default"), 2 ("high", "high_unstructured"), or
    None for IEEE float32 ("highest", "highest_unstructured"). Raises on
    an unknown name."""
    try:
        return _LIMBS[precision]
    except KeyError:
        raise ValueError("Unknown precision: {!r} (valid: {})".format(
            precision, ", ".join(PRECISIONS))) from None


@contextlib.contextmanager
def matmul_precision(precision):
    """Within the block, float32 matrix products and convolutions that
    cuBLAS and cuDNN run are IEEE float32 (TF32 off), whatever the
    caller's global setting, for every precision name; the names' limb
    passes are chosen by the products themselves (precision_limbs). Both
    flags are set explicitly and restored on exit. Raises on an unknown
    name."""
    precision_limbs(precision)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
