"""
Genome-distance-based concatenation (port of
evcouplings_tpu/complex/distance.py): CDS partner enumeration and best
reciprocal matching, on the host (pandas), as in the JAX package.

The all-pairs-per-genome enumeration is a per-genome cross merge; the
closest partner of each side is a grouped idxmin (the first minimal
row), so ties are broken as the JAX package breaks them.
plot_distance_distribution imports matplotlib where it draws.
"""

import numpy as np
import pandas as pd


def get_distance(annotation_1, annotation_2):
    """Distance in bases between two CDS locations on one genome
    (0 if they overlap)."""
    lo1, hi1 = sorted(annotation_1)
    lo2, hi2 = sorted(annotation_2)
    # gap between whichever interval ends first and the other's start
    return max(lo2 - hi1, lo1 - hi2, 0)


def find_possible_partners(gene_location_table_1, gene_location_table_2):
    """All cross-genome CDS pairings with their genomic distances.

    Returns DataFrame with columns uniprot_id_1, uniprot_id_2, distance
    (full_id x full_id for every shared genome).
    """
    def _clean(table, suffix):
        table = table.dropna(axis=0).copy()
        table[["gene_start", "gene_end"]] = table[
            ["gene_start", "gene_end"]
        ].astype(int)
        table = table.drop_duplicates()
        # normalized interval [lo, hi] per CDS
        lo = table[["gene_start", "gene_end"]].min(axis=1)
        hi = table[["gene_start", "gene_end"]].max(axis=1)
        return pd.DataFrame({
            "genome_id": table["genome_id"].values,
            "uniprot_id" + suffix: table["full_id"].values,
            "lo" + suffix: lo.values,
            "hi" + suffix: hi.values,
        })

    t1 = _clean(gene_location_table_1, "_1")
    t2 = _clean(gene_location_table_2, "_2")

    # all CDS pairs sharing a genome, then the interval distance
    merged = t1.merge(t2, on="genome_id")
    if len(merged) == 0:
        return pd.DataFrame(
            columns=["uniprot_id_1", "uniprot_id_2", "distance"]
        )

    gap_12 = merged.lo_2 - merged.hi_1      # CDS 1 before CDS 2
    gap_21 = merged.lo_1 - merged.hi_2      # CDS 2 before CDS 1
    distance = np.maximum(np.maximum(gap_12, gap_21), 0)

    return pd.DataFrame({
        "uniprot_id_1": merged.uniprot_id_1.values,
        "uniprot_id_2": merged.uniprot_id_2.values,
        "distance": distance.values,
    })


_PAIRING_COLUMNS = ["uniprot_id_1", "uniprot_id_2", "distance"]


def best_reciprocal_matching(possible_partners):
    """Pairs where each member is the other's closest CDS on the genome:
    each side's closest-partner row by a grouped idxmin (the first
    minimal row), then the pairs both sides agree on.

    Returns DataFrame with columns uniprot_id_1, uniprot_id_2, distance.
    """
    if len(possible_partners) == 0:
        return pd.DataFrame(columns=_PAIRING_COLUMNS)

    def closest_rows(side):
        picked = possible_partners.groupby(side).distance.idxmin()
        return possible_partners.loc[picked, _PAIRING_COLUMNS]

    reciprocal = closest_rows("uniprot_id_1").merge(
        closest_rows("uniprot_id_2")[["uniprot_id_1", "uniprot_id_2"]],
        on=["uniprot_id_1", "uniprot_id_2"],
    )
    return reciprocal.reset_index(drop=True)


def plot_distance_distribution(id_pair_to_distance, outfile):
    """Cumulative histogram of genome distances of the final pairing
    (matplotlib is imported here)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    distances = sorted(id_pair_to_distance["distance"])
    if len(distances) == 0:
        raise ValueError("No valid distances provided")

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.semilogx(distances, range(len(distances)))
    ax.set_xlim(xmin=1, xmax=max(distances))
    ax.set(xlabel="Genome distance (bases)",
           ylabel="Number of sequences")
    fig.savefig(outfile)
    plt.close(fig)
