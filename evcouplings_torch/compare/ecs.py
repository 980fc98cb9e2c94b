"""
EC <-> 3D-distance comparison: distance annotation and precision at each
rank (port of evcouplings_tpu/compare/ecs.py; host pandas).
"""

import numpy as np


def _drop_short_range(ec_table, min_sequence_dist):
    """Rows with sequence separation |i - j| >= min_sequence_dist
    (all rows when the threshold is None)."""
    if min_sequence_dist is None:
        return ec_table
    separation = (ec_table.i - ec_table.j).abs()
    return ec_table[separation >= min_sequence_dist]


def add_distances(ec_table, dist_map, target_column="dist"):
    """Annotate each EC pair (columns i, j) with its distance from the
    map (NaN where unavailable)."""
    pair_distances = [
        dist_map.dist(i, j, raise_na=False)
        for i, j in zip(ec_table.i, ec_table.j)
    ]
    return ec_table.assign(**{target_column: pair_distances})


def add_precision(ec_table, dist_cutoff=5, score="cn",
                  min_sequence_dist=6, target_column="precision",
                  dist_column="dist"):
    """Cumulative precision of ECs as contact predictors: at each rank,
    TP / (TP + FP) where TP = pairs with distance <= dist_cutoff."""
    ranked = _drop_short_range(
        ec_table.sort_values(by=score, ascending=False, kind="stable"),
        min_sequence_dist,
    )

    # running counts down the ranking: contacts vs resolved pairs
    distances = ranked.loc[:, dist_column]
    contacts_so_far = (distances <= dist_cutoff).cumsum()
    resolved_so_far = distances.notnull().cumsum()

    return ranked.assign(
        **{target_column: contacts_so_far / resolved_so_far}
    )


def coupling_scores_compared(ec_table, dist_map, dist_map_multimer=None,
                             dist_cutoff=5, output_file=None, score="cn",
                             min_sequence_dist=6):
    """Build the "CouplingScoresCompared"-style table: distances (min
    of monomer/multimer if both given) plus precision column."""
    if dist_map_multimer is None:
        compared = add_distances(ec_table, dist_map)
    else:
        compared = add_distances(ec_table, dist_map, "dist_intra")
        compared = add_distances(
            compared, dist_map_multimer, "dist_multimer"
        )
        compared = compared.assign(
            dist=np.fmin(compared.dist_intra, compared.dist_multimer)
        )

    compared = _drop_short_range(compared, min_sequence_dist)

    if dist_cutoff is not None:
        compared = add_precision(
            compared, dist_cutoff, score=score,
            min_sequence_dist=min_sequence_dist,
        )

    if output_file is not None:
        compared.to_csv(output_file, index=False)

    return compared
