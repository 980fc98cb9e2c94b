"""
Structure-model ranking by secondary-structure twist (dihedral
statistics of predicted helices and sheets); port of
evcouplings_tpu/fold/ranking.py (a reimplementation of
make_alpha_beta_score_table.m).

Host numpy in float64, as in the JAX package: a model has a few hundred
CA dihedrals, too little work for a device launch.
"""

from collections import defaultdict
from itertools import combinations

import numpy as np
import pandas as pd

from evcouplings_torch.compare.pdb import ClassicPDB
from evcouplings_torch.utils.calculations import dihedral_angle
from evcouplings_torch.utils.config import InvalidParameterError
from evcouplings_torch.visualize.pairs import (
    find_secondary_structure_segments,
)

# dihedral-angle windows (radians) and their score weights; the alpha
# windows count with left-open/right-closed bounds, the beta windows
# with left-closed/right-open bounds (make_alpha_beta_score_table.m)
_ALPHA_WEIGHTS = [
    (0.2, 0.44, 0.52),
    (0.4, 0.52, 0.61),
    (0.6, 0.61, 0.70),
    (0.8, 0.70, 0.78),
    (1.0, 0.78, 0.96),
    (0.8, 0.96, 1.05),
    (0.6, 1.05, 1.13),
    (0.4, 1.13, 1.22),
    (0.2, 1.22, 1.31),
]

_BETA_WEIGHTS = [
    (0.2, -0.3, -0.1),
    (0.4, -0.4, -0.3),
    (0.6, -0.5, -0.4),
    (0.8, -0.6, -0.5),
    (1.0, -0.8, -0.6),
    (0.8, -0.9, -0.8),
    (0.6, -1.0, -0.9),
    (0.4, -1.1, -1.0),
    (0.2, -1.2, -1.1),
]

_BETA_COLUMNS = ("i", "j", "strand_i", "strand_j", "dihedral")


def _ca_trace(coords, keep="first"):
    """{position: CA xyz vector} from a coordinate table. With
    duplicate positions (alternate locations surviving upstream
    filters), keep="first" retains the first occurrence — matching the
    reference's row-lookup semantics in the helix path — while
    keep="last" retains the last, matching its dict(zip(...)) in the
    strand path."""
    trace = {}
    for pos, vec in zip(coords.i, coords.loc[:, ["x", "y", "z"]].values):
        if keep == "last" or pos not in trace:
            trace[pos] = vec
    return trace


def _alpha_dihedrals(coords, segments):
    """CA-dihedral angles inside helical segments (segment end
    exclusive); returns DataFrame (helix, i, dihedral)."""
    trace = _ca_trace(coords, keep="first")

    rows = []
    for helix, (seg_start, seg_end) in enumerate(segments):
        for pos in range(seg_start, seg_end):
            # the dihedral at pos needs the CA window pos-1 .. pos+2
            window = (pos - 1, pos, pos + 1, pos + 2)
            if all(p in trace for p in window):
                rows.append((
                    helix, pos,
                    dihedral_angle(*(trace[p] for p in window)),
                ))

    return pd.DataFrame(rows, columns=["helix", "i", "dihedral"])


def _vote_strand_orientation(trace, pair_rows, original):
    """+1 .. -1 parallel-vs-antiparallel vote over paired residues.

    Votes compare the distance of the two strands' +2 anchors against
    an antiparallel alternative; original=True anchors that
    alternative at i-2 (2011 protocol), original=False at j-2 (which
    the 2011 residue-presence checks do not guard — a missing j-2
    raises, faithfully to the reference)."""
    agree = voted = 0
    for i, j in pair_rows:
        if not ((i - 2) in trace and (i + 2) in trace
                and (j + 2) in trace):
            continue
        d_parallel = np.linalg.norm(trace[i + 2] - trace[j + 2])
        if original:
            d_opposite = np.linalg.norm(trace[i - 2] - trace[j + 2])
        else:
            d_opposite = np.linalg.norm(trace[i + 2] - trace[j - 2])
        voted += 1
        agree += d_parallel <= d_opposite

    return 0 if voted == 0 else agree / voted * 2 - 1


def _strand_pair_dihedrals(trace, pair_rows, strand_i, strand_j,
                           parallel, original):
    """Dihedral rows (i, j, strand_i, strand_j, angle) for one
    strand pairing. The +-2 offset on strand j follows its
    orientation; which residues must be present differs between the
    2011 (original) and the consistent variant — the 2011 checks do
    not cover the i+2 anchor the angle itself uses."""
    j_offset = 2 if parallel else -2

    rows = []
    for i, j in pair_rows:
        if original:
            required = (j + 2, i + j_offset)
        else:
            required = (i + 2, j + j_offset)
        if not all(p in trace for p in required):
            continue
        rows.append((
            i, j, strand_i, strand_j,
            dihedral_angle(
                trace[i], trace[i + 2], trace[j + j_offset], trace[j]
            ),
        ))

    return pd.DataFrame(rows, columns=_BETA_COLUMNS)


def _nearest_partner_span(trace, seg_i, seg_j, max_strand_distance):
    """For two strand segments: the per-residue nearest-partner pairs
    (pos_i, pos_j) restricted to the span between the first and last
    close pair, plus the minimal close distance. Returns (None, None)
    when the strands never come within max_strand_distance."""
    pos_i = [p for p in range(*seg_i) if p in trace]
    pos_j = [p for p in range(*seg_j) if p in trace]
    if not pos_i or not pos_j:
        return None, None

    gap = np.linalg.norm(
        np.asarray([trace[p] for p in pos_i])[:, None, :]
        - np.asarray([trace[p] for p in pos_j])[None, :, :],
        axis=-1,
    )

    # nearest pos_j per pos_i; distance ties resolve to the smaller
    # pos_j (argmin takes the first hit over the ascending pos_j axis)
    best = gap.argmin(axis=1)
    best_dist = gap[np.arange(len(pos_i)), best]

    close = (best_dist <= max_strand_distance).nonzero()[0]
    if close.size == 0:
        return None, None

    span = range(close[0], close[-1] + 1)
    pairs = [(pos_i[k], pos_j[best[k]]) for k in span]
    return pairs, best_dist[close].min()


def _beta_dihedrals(coords, segments, max_strand_distance=7,
                    original=True):
    """Inter-strand CA-dihedral angles for proximal strand pairs
    (parallel/antiparallel determined by majority vote); returns
    DataFrame (i, j, strand_i, strand_j, dihedral).

    original=True reproduces the exact residue selections of the 2011
    ranking protocol (which are inconsistent between orientation vote
    and angle computation); False uses the consistent variant.
    """
    trace = _ca_trace(coords, keep="last")

    # candidate pairings per strand, found by 3D proximity
    pairings = defaultdict(list)
    for (strand_i, seg_i), (strand_j, seg_j) in combinations(
        enumerate(segments), 2
    ):
        pairs, pair_gap = _nearest_partner_span(
            trace, seg_i, seg_j, max_strand_distance
        )
        if pairs is None:
            continue

        parallel = _vote_strand_orientation(trace, pairs, original) > 0
        pairings[strand_i].append((
            pair_gap, strand_j,
            _strand_pair_dihedrals(
                trace, pairs, strand_i, strand_j, parallel, original
            ),
        ))

    # each strand participates in at most two pairings, closest first
    tables = []
    links = defaultdict(int)
    for strand_i, candidates in pairings.items():
        candidates.sort(key=lambda entry: entry[0])
        for _, strand_j, dihedrals in candidates:
            if links[strand_i] < 2 and links[strand_j] < 2:
                tables.append(dihedrals)
                links[strand_i] += 1
                links[strand_j] += 1

    if not tables:
        return pd.DataFrame(columns=list(_BETA_COLUMNS))
    return pd.concat(tables, ignore_index=True)


def _windowed_score(angles, windows, left_open):
    """Sum of weight * (number of angles inside each window); the
    alpha table counts lo < angle <= hi, the beta table
    lo <= angle < hi."""
    if angles.size == 0:
        return 0
    total = 0.0
    for weight, lo, hi in windows:
        if left_open:
            inside = (lo < angles) & (angles <= hi)
        else:
            inside = (lo <= angles) & (angles < hi)
        total += weight * np.count_nonzero(inside)
    return total


def dihedral_ranking_score(structure, residues,
                           sec_struct_column="sec_struct_3state",
                           original=True):
    """Helix/sheet twist quality of one structure model.

    Returns (num alpha dihedrals, alpha score, num beta dihedrals,
    beta score).
    """
    ca_only = structure.filter_atoms(atom_name="CA")
    placed = ca_only.residues.merge(
        ca_only.coords, left_index=True, right_on="residue_index"
    )

    # attach the 3D coordinates to the secondary-structure prediction
    # rows (PDB residue identifiers are strings)
    annotated = residues.assign(id=residues.i.astype(str)).merge(
        placed, on="id", how="left", suffixes=("", "_")
    )

    _, _, segments = find_secondary_structure_segments(
        "".join(annotated.loc[:, sec_struct_column]),
        offset=annotated.i.min(),
    )
    spans = defaultdict(list)
    for seg_type, seg_start, seg_end in segments:
        spans[seg_type].append((seg_start, seg_end))

    resolved = annotated.dropna(subset=["x", "y", "z"])
    helix_table = _alpha_dihedrals(resolved, spans["H"])
    sheet_table = _beta_dihedrals(resolved, spans["E"],
                                  original=original)

    return (
        len(helix_table),
        _windowed_score(helix_table.dihedral.values, _ALPHA_WEIGHTS,
                        left_open=True),
        len(sheet_table),
        _windowed_score(sheet_table.dihedral.values, _BETA_WEIGHTS,
                        left_open=False),
    )


def dihedral_ranking(structure_files, residues, chain=None,
                     sec_struct_column="sec_struct_3state", model=0):
    """Rank a set of PDB structure models by their combined helix +
    sheet dihedral scores (column ranking_score)."""
    rows = []
    for filename in structure_files:
        structure = ClassicPDB.from_file(filename)

        if chain is None:
            candidates = structure.model_to_chains[model]
            if len(candidates) != 1:
                raise InvalidParameterError(
                    "Model has more than one chain, need to "
                    "specify chain parameter to disambiguate."
                )
            chain = candidates[0]

        scores = dihedral_ranking_score(
            structure.get_chain(chain, model), residues,
            sec_struct_column, original=False,
        )
        rows.append((filename, *scores))

    ranking = pd.DataFrame(rows, columns=[
        "filename", "num_alpha_dihedrals", "alpha_dihedral_score",
        "num_beta_dihedrals", "beta_dihedral_score",
    ])

    # normalize by the best-case dihedral count over the model set
    # (beta counts depend on strand contacts actually made in 3D);
    # floor of 1 so a set with no dihedrals at all stays defined
    denominator = max(
        1,
        ranking.num_alpha_dihedrals.max()
        + ranking.num_beta_dihedrals.max(),
    )
    ranking["ranking_score"] = (
        ranking.alpha_dihedral_score + ranking.beta_dihedral_score
    ) / denominator
    return ranking
