"""
Python wrapper of K1, the hand-written CUDA neighbor-count kernel
(evcouplings_torch/csrc/reweight.cu), which replaces the TPU kernel
evcouplings_tpu/ops/weights_pallas.py::_reweight_kernel.

ops/weights.py routes CUDA tensors here; its plain PyTorch version
(_num_cluster_members_plain) computes the same counts for CPU tensors.
The kernel takes the identity counts as an int8 one-hot product on the
tensor cores; the wrapper reads the number of symbols q = max code + 1
from the codes (one host read per call), which sets the one-hot's depth
(one 32-byte slab per site and per 32 symbols), and pads the rows with -1
(matches nothing) to a multiple of 32 sites, the kernel's register load.

The kernel's blocks are the upper-triangle tiles of the 128-row tile grid,
numbered row by row; a launch may cover a contiguous range of them
(tile_blocks, tile_range), which is how the ranks of a sharded run split
the work (evcouplings_torch.parallel.num_cluster_members_sharded).
"""

import ctypes

import torch

from evcouplings_torch.kernels import _build

SOURCE = "reweight"
# sites per register load of the kernel (kChunk in csrc/reweight.cu): rows
# are padded to a multiple of it
_CHUNK = 32
# rows of a tile (kTile in csrc/reweight.cu)
TILE = 128
_SYMBOLS = {
    "evc_neighbor_counts_range": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p,
    ],
}


def tile_blocks(n):
    """Number of upper-triangle tiles (kernel blocks) for n rows."""
    tiles = -(-n // TILE)
    return tiles * (tiles + 1) // 2


def tile_range(n, index, count):
    """(begin, count) of the index-th of `count` contiguous, nearly equal
    ranges of the upper-triangle tiles for n rows."""
    blocks = tile_blocks(n)
    begin = index * blocks // count
    return begin, (index + 1) * blocks // count - begin


def pad_codes(codes):
    """(n, L) int8 CUDA codes -> (n, Lp) with Lp a multiple of 32 sites,
    padded with -1 (matches nothing): the layout K1 reads."""
    n, L = codes.shape
    padded = torch.full((n, -(-L // _CHUNK) * _CHUNK), -1, dtype=torch.int8,
                        device=codes.device)
    padded[:, :L] = codes
    return padded


def launch(padded, q, min_count, tiles=None):
    """Launch K1 on codes laid out by pad_codes, with q symbols, over the
    upper-triangle tiles `tiles` = (begin, count) (None: all of them);
    returns (n,) int32 counts, the range's contributions (no host
    synchronisation). An empty range launches nothing."""
    n, lp = padded.shape
    if not (padded.is_cuda and padded.dtype == torch.int8
            and padded.is_contiguous() and lp % _CHUNK == 0):
        raise ValueError("launch takes int8 CUDA codes laid out by "
                         "pad_codes")
    begin, count = (0, tile_blocks(n)) if tiles is None else tiles
    lib = _build.load(SOURCE, _SYMBOLS)
    counts = torch.zeros(n, dtype=torch.int32, device=padded.device)
    with torch.cuda.device(padded.device):
        err = lib.evc_neighbor_counts_range(
            ctypes.c_void_p(padded.data_ptr()), n, lp, max(q, 0),
            int(min_count), int(begin), int(count),
            ctypes.c_void_p(counts.data_ptr()), _build.stream_of(padded),
        )
    _build.check_launch(lib, err, "evc_neighbor_counts_range")
    if count:
        neighbor_counts.launches += 1
    return counts


def neighbor_counts(codes, min_count, tiles=None):
    """Per-row neighbor counts on the GPU.

    codes : (n, L) int8 CUDA tensor, contiguous; codes >= 0 are symbols,
        negative codes match nothing
    min_count : int identity cutoff (a pair is neighbors iff at least
        min_count sites hold the same valid code)
    tiles : (begin, count) of the upper-triangle tiles to launch (see
        tile_range); None launches all

    Returns (n,) int32 counts (each row counts itself when its own
    identity reaches min_count); with `tiles`, the contributions of those
    tiles alone.
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
    q = int(codes.max()) + 1
    if q > 127:
        raise ValueError("at most 127 symbols (codes up to 126), got a "
                         "code of {}".format(q - 1))
    return launch(pad_codes(codes), q, min_count, tiles)


# launches of K1 (by launch(), which neighbor_counts calls)
neighbor_counts.launches = 0
