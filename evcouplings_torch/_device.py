"""Device resolution and matmul precision shared by the port's entry
points."""

import contextlib

import torch

# matmul precision names accepted by the fits (the JAX package's set).
# "highest*" is IEEE float32 (TF32 off); "high*" and "default" let
# cuBLAS/cuDNN run float32 products in TF32.
PRECISIONS = ("highest", "high", "default",
              "highest_unstructured", "high_unstructured")


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


@contextlib.contextmanager
def matmul_precision(precision):
    """Within the block, float32 matrix products and convolutions run in
    IEEE float32 for "highest" (TF32 off for cuBLAS and cuDNN) and may
    use TF32 for "high"/"default". Both flags are set explicitly, never
    left at their defaults, and restored on exit."""
    if precision not in PRECISIONS:
        raise ValueError("Unknown precision: {!r} (valid: {})".format(
            precision, ", ".join(PRECISIONS)))
    allow = not precision.startswith("highest")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
