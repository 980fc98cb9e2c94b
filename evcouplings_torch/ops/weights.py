"""
O(N^2 L) sequence-identity reweighting (port of
evcouplings_tpu/ops/weights.py).

num_cluster_members counts, for each sequence, the sequences (itself
included) whose identity to it reaches the threshold; identity is the
number of matching columns over L, gaps participating, code -1 matching
nothing. A CUDA tensor goes to K1, the hand-written kernel in
csrc/reweight.cu (kernels/reweight.py); a CPU tensor goes to the plain
version below, a blocked one-hot matrix product. There is no size or
platform heuristic and no fallback: a CUDA input launches K1 or raises.
"""

import math

import numpy as np
import torch

from evcouplings_torch._device import resolve_device
from evcouplings_torch.ops.encode import one_hot

# rows per block of the plain version's (B, N) identity tile
_PLAIN_BLOCK = 4096


def _identity_count_threshold(L, identity_threshold):
    """Smallest integer k with k / L >= identity_threshold (exact, f64).

    Thresholding integer identity counts against an integer cutoff avoids
    any float-division edge cases on device.
    """
    k = int(math.ceil(identity_threshold * L))
    while k > 0 and (k - 1) / L >= identity_threshold:
        k -= 1
    while k <= L and k / L < identity_threshold:
        k += 1
    return k


def _num_cluster_members_plain(codes, min_count, tiles=None):
    """Plain PyTorch version of K1: (n, L) int8 codes -> (n,) int32
    neighbor counts.

    The identity count of two rows is the inner product of their one-hot
    encodings. The products run in float32, which is exact here: the
    operands are 0/1 and every sum is an integer <= L < 2^24. (An int8
    product on the CPU would return int8 and wrap past 127.)

    tiles: (begin, count) of K1's upper-triangle tiles (128 x 128, numbered
    row by row, kernels/reweight.tile_range): only those tiles contribute,
    a tile (ti, tj > ti) its row sums to its rows and its column sums to its
    columns, a diagonal tile its row sums, as the kernel's range launch adds
    them. None counts every pair.
    """
    n, L = codes.shape
    q = max(int(codes.max()) + 1, 1)
    oh = one_hot(codes, q, dtype=torch.float32).reshape(n, L * q)
    if tiles is not None:
        return _plain_tile_range(oh, min_count, *tiles)
    counts = torch.empty(n, dtype=torch.int32, device=codes.device)
    for start in range(0, n, _PLAIN_BLOCK):
        ids = oh[start:start + _PLAIN_BLOCK] @ oh.T
        counts[start:start + _PLAIN_BLOCK] = (
            (ids >= min_count).sum(dim=1, dtype=torch.int32)
        )
    return counts


def _plain_tile_range(oh, min_count, begin, count):
    """Counts of the tiles [begin, begin + count) of the row-by-row
    upper-triangle numbering, from the (n, Lq) float32 one-hot; each tile
    row's share of the range is one product."""
    from evcouplings_torch.kernels.reweight import TILE

    n = oh.shape[0]
    tiles = -(-n // TILE)
    counts = torch.zeros(n, dtype=torch.int32, device=oh.device)
    first = 0                                 # number of tile (ti, ti)
    for ti in range(tiles):
        lo = max(begin, first) - first + ti   # tj range of this row
        hi = min(begin + count, first + tiles - ti) - first + ti
        first += tiles - ti
        if lo >= hi:
            continue
        rows = slice(ti * TILE, (ti + 1) * TILE)
        c0 = lo * TILE
        hit = (oh[rows] @ oh[c0:hi * TILE].T) >= min_count
        counts[rows] += hit.sum(dim=1, dtype=torch.int32)
        # off-diagonal tiles add their column sums too
        off = max(ti + 1, lo) * TILE - c0
        counts[c0 + off:hi * TILE] += hit[:, off:].sum(dim=0,
                                                      dtype=torch.int32)
    return counts


def _neighbor_counts(codes, min_count, tiles=None):
    """(n,) int32 counts of int8 codes: K1 on a CUDA tensor, the plain
    version on a CPU tensor (tiles: a range of K1's tiles, or None)."""
    if codes.is_cuda:
        from evcouplings_torch.kernels.reweight import neighbor_counts

        return neighbor_counts(codes, min_count, tiles)
    if codes.device.type == "cpu":
        return _num_cluster_members_plain(codes, min_count, tiles)
    raise ValueError(
        "no reweighting path for device {}".format(codes.device))


def _as_tensor(matrix_mapped, device):
    """A tensor input stays on its device; anything else goes to
    `device` (None: the CUDA device)."""
    if isinstance(matrix_mapped, torch.Tensor):
        return matrix_mapped
    return torch.as_tensor(
        np.asarray(matrix_mapped), device=resolve_device(device))


def _codes_tensor(matrix_mapped, device):
    """Contiguous int8 codes (symbols 0..126; larger codes would wrap
    negative in int8 and silently match nothing, so they raise)."""
    codes = _as_tensor(matrix_mapped, device)
    if codes.numel() and int(codes.max()) > 126:
        raise ValueError(
            "reweighting supports symbol codes up to 126, got {}".format(
                int(codes.max())))
    return codes.to(torch.int8).contiguous()


def num_cluster_members(matrix_mapped, identity_threshold, device=None):
    """Number of cluster members (inverse sequence weight) per sequence.

    Parameters
    ----------
    matrix_mapped : (N, L) int codes, numpy array or tensor (a tensor
        stays on its device; anything else goes to `device`)
    identity_threshold : float
    device : torch device for non-tensor input (None: the CUDA device)

    Returns
    -------
    (N,) float64 tensor of cluster sizes, on the codes' device
    """
    codes = _codes_tensor(matrix_mapped, device)
    min_count = _identity_count_threshold(codes.shape[1], identity_threshold)
    return _neighbor_counts(codes, min_count).to(torch.float64)


def identities_to_seq(seq_mapped, matrix_mapped, device=None):
    """Number of identities of every alignment row to a target sequence,
    as an (N,) float64 tensor (negative codes match nothing)."""
    codes = _as_tensor(matrix_mapped, device).long()
    seq = torch.as_tensor(np.asarray(seq_mapped), device=codes.device).long()
    match = (codes == seq[None, :]) & (seq[None, :] >= 0)
    return match.sum(dim=1).to(torch.float64)
