"""
Python wrapper of K4, the sequential float32 dot product
(evcouplings_torch/csrc/seqdot.cu), and of its plain host version
(csrc/seqdot_host.c).

The LBFGS engine (ops/lbfgs.py) takes its dot products through
sequential_dot and sequential_dots in parity mode (float32, precision
"highest"): one chain of fused multiply-adds in index order per pair,
the rounding of the JAX package's engine on the CPU, which its golden
fixtures carry. sequential_dots takes a batch of independent pairs in one
launch (one chain per pair, each on its own SM); sequential_dot is a
batch of one. CUDA tensors launch K4; CPU tensors run the host version.
Both give the same bits.
"""

import ctypes

import torch

from evcouplings_torch.kernels import _build

# pairs per launch (kMaxBatch in csrc/seqdot.cu); larger batches take
# several launches
MAX_BATCH = 16

_SYMBOLS = {
    "evc_seq_dots": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
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


def _sequential_dots_cuda(xs, ys):
    """Launch K4 on pairs of (n,) float32 contiguous CUDA vectors; returns
    a (k,) float32 CUDA tensor (no host synchronisation)."""
    if not all(v.is_contiguous() for v in xs + ys):
        raise ValueError("sequential_dots needs contiguous CUDA vectors")
    device = xs[0].device
    if any(v.device != device for v in xs + ys):
        raise ValueError("sequential_dots takes pairs on one device")
    lib = _build.load("seqdot", _SYMBOLS)
    out = torch.empty(len(xs), dtype=torch.float32, device=device)
    for start in range(0, len(xs), MAX_BATCH):
        px, py = xs[start:start + MAX_BATCH], ys[start:start + MAX_BATCH]
        k = len(px)
        x_ptrs = (ctypes.c_void_p * k)(*(v.data_ptr() for v in px))
        y_ptrs = (ctypes.c_void_p * k)(*(v.data_ptr() for v in py))
        ns = (ctypes.c_longlong * k)(*(v.numel() for v in px))
        with torch.cuda.device(device):
            err = lib.evc_seq_dots(
                x_ptrs, y_ptrs, ns, k,
                ctypes.c_void_p(out[start:].data_ptr()), _build.stream_of(
                    out))
        _build.check_launch(lib, err, "evc_seq_dots")
        sequential_dots.launches += 1
        sequential_dots.chains += k
    return out


def sequential_dots(xs, ys):
    """[sum_i xs[p][i] ys[p][i] for each pair p], each one fused
    multiply-add chain in index order; the chains of a batch are
    independent of each other (on the card: one launch, one SM each).
    Returns a list of 0-d float32 tensors on the pairs' device."""
    xs, ys = list(xs), list(ys)
    if len(xs) != len(ys) or not xs:
        raise ValueError("sequential_dots takes one or more pairs, got {} "
                         "x and {} y".format(len(xs), len(ys)))
    for x, y in zip(xs, ys):
        _check(x, y)
    if xs[0].is_cuda:
        return list(_sequential_dots_cuda(xs, ys).unbind())
    if any(v.device.type != "cpu" for v in xs):
        raise ValueError("no sequential_dots for device {}".format(
            xs[0].device))
    return [_sequential_dot_plain(x, y) for x, y in zip(xs, ys)]


def sequential_dot(x, y):
    """sum_i x[i] y[i] as one fused multiply-add chain in index order (a
    batch of one of sequential_dots)."""
    return sequential_dots([x], [y])[0]


# launches of K4 (serial chain latencies) and chains they ran
sequential_dots.launches = 0
sequential_dots.chains = 0
