"""
Minimum-atom distances between residue sets (port of
evcouplings_tpu/ops/distances.py, which computes them in host numpy).

For residues i and j, each an inclusive range of rows of an (N_atoms, 3)
coordinate array, dists[i, j] is the least Euclidean distance between an
atom of i and an atom of j. Atom lists are padded to the largest residue
(A atoms), giving (N, A, 3) arrays and a padding mask. Per block of
residue rows, the squared distances of all atom pairs are
|x|^2 + |y|^2 - 2 x.y^T: one float64 GEMM of depth 3 (cuBLAS DGEMM on the
card), with padding atoms carrying an infinite |x|^2 so that they never
win, then the minimum over both atom axes.

The GEMM form picks each residue pair's closest atom pair; the distance
itself is then taken from that pair's coordinate difference. In the GEMM
form d^2 carries about |x|^2 * 1e-16 of cancellation (|x|^2 ~ 1e4 A^2
for a protein: ~1e-12 A^2). Away from d = 0 that is ~1e-12 A in d, but at
d = 0 (a residue against itself) the square root turns it into ~1e-6 A,
and card and host round it differently. The difference form is exact to
rounding for every d, and card and host round its three products, two
sums and square root the same way (IEEE), so both return the same bits
when they pick the same atom pair. Everything runs in float64: in float32
the cancellation alone would be ~1e-3 A^2 in d^2, enough to flip a
contact at a 5 A cutoff. Do not enable TF32 for this product.
"""

import numpy as np
import torch

from evcouplings_torch._device import resolve_device


def _pad_atoms(atom_ranges, coords):
    """Expand (first, last) atom ranges into a padded (N, A, 3) float64
    array and its (N, A) padding mask (True = no atom), with one
    vectorized scatter."""
    atom_ranges = np.asarray(atom_ranges, dtype=np.int64).reshape(-1, 2)
    coords = np.asarray(coords, dtype=np.float64).reshape(-1, 3)
    counts = atom_ranges[:, 1] - atom_ranges[:, 0] + 1
    N = len(atom_ranges)
    A = int(counts.max()) if N > 0 else 1

    slot = np.arange(A)
    mask = slot[None, :] >= counts[:, None]
    padded = np.zeros((N, A, 3))
    padded[~mask] = coords[(atom_ranges[:, :1] + slot[None, :])[~mask]]
    return padded, mask


def block_bytes(n_block, atoms_i, n_j, atoms_j):
    """Bytes of one block's float64 squared-distance matrix:
    (n_block * atoms_i) x (n_j * atoms_j) x 8. At block_rows=512 and 14
    atoms per residue against a 1000-residue chain: 0.80 GB."""
    return n_block * atoms_i * n_j * atoms_j * 8


def min_atom_distances(atom_ranges_i, coords_i, atom_ranges_j, coords_j,
                       symmetric=False, block_rows=512, device=None):
    """(N_i, N_j) float64 numpy matrix of minimum atom distances between
    residues.

    atom_ranges are (N, 2) inclusive index ranges into the (N_atoms, 3)
    coordinate arrays. `symmetric` is accepted for API parity (the full
    matrix is computed either way). `device`: None means the CUDA device
    (raises without one), "cpu" the host. One block of `block_rows`
    residue rows holds block_bytes(block_rows, A_i, N_j, A_j) bytes of
    squared distances on the device.
    """
    device = resolve_device(device)
    xi_np, mask_i_np = _pad_atoms(atom_ranges_i, coords_i)
    xj_np, mask_j_np = _pad_atoms(atom_ranges_j, coords_j)
    N_i, A_i, _ = xi_np.shape
    N_j, A_j, _ = xj_np.shape

    xi = torch.as_tensor(xi_np, device=device)
    xj = torch.as_tensor(xj_np, device=device)
    mask_i = torch.as_tensor(mask_i_np, device=device)

    flat_j = xj.reshape(N_j * A_j, 3)
    sq_j = flat_j.square().sum(1).masked_fill_(
        torch.as_tensor(mask_j_np.reshape(-1), device=device), np.inf)
    cols = torch.arange(N_j, device=device)

    dists = torch.empty((N_i, N_j), dtype=torch.float64, device=device)
    for start in range(0, N_i, block_rows):
        stop = min(start + block_rows, N_i)
        B = stop - start
        xb = xi[start:stop]                                 # (B, A_i, 3)
        sq_b = xb.square().sum(2).masked_fill_(mask_i[start:stop], np.inf)

        # squared distances of every atom pair: one DGEMM of depth 3 into
        # the block's only (B A_i, N_j A_j) buffer
        d2 = torch.addmm(sq_j[None, :], xb.reshape(-1, 3), flat_j.T,
                         alpha=-2.0).add_(sq_b.reshape(-1, 1))
        d2 = d2.view(B, A_i, N_j, A_j)

        # closest atom pair of each residue pair
        best_j, idx_j = d2.min(dim=3)                      # (B, A_i, N_j)
        del d2
        idx_i = best_j.argmin(dim=1)                       # (B, N_j)
        idx_j = idx_j.gather(1, idx_i[:, None, :])[:, 0]   # (B, N_j)

        # its distance from the coordinate difference
        rows = torch.arange(B, device=device)[:, None]
        diff = xb[rows, idx_i] - xj[cols[None, :], idx_j]  # (B, N_j, 3)
        dx, dy, dz = diff.unbind(-1)
        dists[start:stop] = (dx * dx + dy * dy + dz * dz).sqrt()

    return dists.cpu().numpy()
