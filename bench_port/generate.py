"""Inputs made from the seed: synthetic protein-family alignments, on the
device, and their a2m files.

A rewrite of the port's chip_smoke.synthetic_codes and write_a2m on a
torch.Generator: rows drawn from `families` random centres with a
`mutate` share of their sites resampled (duplicates and near-duplicates,
so cluster counts exceed 1), and a `gap_rows` share of rows with half
their sites set to the gap code 0. The same seed on the same kind of
device gives the same codes.
"""

import numpy as np
import torch

from bench_port.reference import GAP_ALPHABET


def generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 64)
    return g


def synthetic_codes(g, n, L, q, families, mutate, gap_rows):
    """(n, L) int8 codes on the generator's device."""
    dev = g.device
    centres = torch.randint(0, q, (families, L), generator=g, device=dev,
                            dtype=torch.int8)
    codes = centres[torch.randint(0, families, (n,), generator=g,
                                  device=dev)]
    resample = torch.rand((n, L), generator=g, device=dev) < mutate
    fresh = torch.randint(0, q, (n, L), generator=g, device=dev,
                          dtype=torch.int8)
    codes = torch.where(resample, fresh, codes)
    gappy = torch.rand((n, 1), generator=g, device=dev) < gap_rows
    half = torch.rand((n, L), generator=g, device=dev) < 0.5
    return torch.where(gappy & half, torch.zeros_like(codes), codes)


def focus_codes(L):
    """Codes of the gap-free focus row: residues 1..20 in turn."""
    return 1 + np.arange(L) % 20


def write_a2m(path, g, codes, inserts):
    """Write an a2m alignment: a gap-free focus row TARGET/1-W, then the
    rows seq<k>. W = L + inserts columns; `inserts` of them, at positions
    drawn from g, are insert columns (lowercase in the focus row, a
    lowercase residue or '.' in the others), so that only focus mode
    (the focus row's uppercase columns) selects the L match columns.
    Returns the insert positions."""
    n, L = codes.shape
    width = L + inserts
    dev = g.device
    pos = torch.randperm(width, generator=g, device=dev)[:inserts]
    pos = np.sort(pos.cpu().numpy())
    ins_res = torch.randint(0, 20, (n, inserts), generator=g, device=dev)
    ins_gap = torch.rand((n, inserts), generator=g, device=dev) < 0.5
    match = np.ones(width, bool)
    match[pos] = False
    upper = np.array(list(GAP_ALPHABET))
    lower = np.array([c.lower() for c in GAP_ALPHABET[1:]])
    rows = np.empty((n + 1, width), dtype="<U1")
    rows[0, match] = upper[focus_codes(L)]
    rows[0, ~match] = lower[np.arange(inserts) % 20]
    rows[1:, match] = upper[codes.cpu().numpy()]
    rows[1:, ~match] = np.where(ins_gap.cpu().numpy(), ".",
                                lower[ins_res.cpu().numpy()])
    with open(path, "w") as f:
        f.write(">TARGET/1-{}\n{}\n".format(width, "".join(rows[0])))
        for k in range(n):
            f.write(">seq{}/1-{}\n{}\n".format(k, width, "".join(rows[k + 1])))
    return pos
