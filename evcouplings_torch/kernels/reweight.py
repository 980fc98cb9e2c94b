"""
Python wrapper of K1, the hand-written CUDA neighbor-count kernel
(evcouplings_torch/csrc/reweight.cu), which replaces the TPU kernel
evcouplings_tpu/ops/weights_pallas.py::_reweight_kernel.

ops/weights.py routes CUDA tensors here; its plain PyTorch version
(_num_cluster_members_plain) computes the same counts for CPU tensors.
"""

import ctypes

import torch

from evcouplings_torch.kernels import _build

SOURCE = "reweight"
_SYMBOLS = {
    "evc_neighbor_counts": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ],
}


def neighbor_counts(codes, min_count):
    """Per-row neighbor counts on the GPU.

    codes : (n, L) int8 CUDA tensor, contiguous; codes >= 0 are symbols,
        negative codes match nothing
    min_count : int identity cutoff (a pair is neighbors iff at least
        min_count sites hold the same valid code)

    Returns (n,) int32 counts (each row counts itself when its own
    identity reaches min_count).
    """
    if not codes.is_cuda:
        raise ValueError("neighbor_counts needs a CUDA tensor")
    if codes.dtype != torch.int8 or codes.dim() != 2:
        raise ValueError(
            "codes must be a 2-D int8 tensor, got {} {}".format(
                codes.dtype, tuple(codes.shape)))
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    n, L = codes.shape
    if n == 0 or L == 0:
        raise ValueError("codes must be non-empty, got {}".format((n, L)))
    if -(-n // 64) > 65535:
        raise ValueError("at most 65535 * 64 rows, got {}".format(n))
    lib = _build.load(SOURCE, _SYMBOLS)
    counts = torch.zeros(n, dtype=torch.int32, device=codes.device)
    with torch.cuda.device(codes.device):
        err = lib.evc_neighbor_counts(
            ctypes.c_void_p(codes.data_ptr()), n, L, int(min_count),
            ctypes.c_void_p(counts.data_ptr()), _build.stream_of(codes),
        )
    _build.check_launch(lib, err, "evc_neighbor_counts")
    neighbor_counts.launches += 1
    return counts


neighbor_counts.launches = 0
