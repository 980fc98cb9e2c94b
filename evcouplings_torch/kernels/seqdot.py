"""
Python wrapper of K4, the sequential float32 dot product
(evcouplings_torch/csrc/seqdot.cu), and of its plain host version
(csrc/seqdot_host.c).

The LBFGS engine (ops/lbfgs.py) takes its dot products through
sequential_dot in parity mode (float32, precision "highest"): one chain
of fused multiply-adds in index order, the rounding of the JAX package's
engine on the CPU, which its golden fixtures carry. A CUDA tensor
launches K4; a CPU tensor runs the host version. Both give the same
bits.
"""

import ctypes

import torch

from evcouplings_torch.kernels import _build

_SYMBOLS = {
    "evc_seq_dot": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p,
    ],
}
_HOST_SYMBOLS = {
    "evc_seq_dot_host": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ],
}


def _check(x, y):
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError("sequential_dot takes float32 vectors, got {} "
                         "and {}".format(x.dtype, y.dtype))
    if x.dim() != 1 or x.shape != y.shape:
        raise ValueError("sequential_dot takes two 1-D vectors of one "
                         "length, got {} and {}".format(
                             tuple(x.shape), tuple(y.shape)))
    if x.device != y.device:
        raise ValueError("x is on {}, y on {}".format(x.device, y.device))


def _sequential_dot_plain(x, y):
    """Plain host version: (n,) float32 CPU vectors -> 0-d float32."""
    lib = _build.load("seqdot_host", _HOST_SYMBOLS, restype=ctypes.c_float)
    x = x.contiguous()
    y = y.contiguous()
    return torch.tensor(lib.evc_seq_dot_host(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
        x.numel()), dtype=torch.float32)


def _sequential_dot_cuda(x, y):
    """Launch K4 on (n,) float32 contiguous CUDA vectors; returns a 0-d
    float32 CUDA tensor (no host synchronisation)."""
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("sequential_dot needs contiguous CUDA vectors")
    lib = _build.load("seqdot", _SYMBOLS)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.evc_seq_dot(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
            x.numel(), ctypes.c_void_p(out.data_ptr()),
            _build.stream_of(x))
    _build.check_launch(lib, err, "evc_seq_dot")
    sequential_dot.launches += 1
    return out


def sequential_dot(x, y):
    """sum_i x[i] y[i] as one fused multiply-add chain in index order."""
    _check(x, y)
    if x.is_cuda:
        return _sequential_dot_cuda(x, y)
    if x.device.type != "cpu":
        raise ValueError("no sequential_dot for device {}".format(x.device))
    return _sequential_dot_plain(x, y)


sequential_dot.launches = 0
