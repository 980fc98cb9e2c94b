"""
Species-similarity-based concatenation helpers (port of
evcouplings_tpu/complex/similarity.py): per-species best hits, paralog
detection, and best-reciprocal filtering.

The tables are pandas on the host, as in the JAX package; the paralog
identity counts run on `device` (None: the CUDA device, "cpu": the host)
through Alignment.identities_to. Ties are broken as the JAX package
breaks them (a stable ascending sort on identity, the last row of each
species), so the pairing, and with it the concatenated alignment, is the
JAX package's.
"""

import numpy as np
import pandas as pd

from evcouplings_torch.align.alignment import Alignment, parse_header
from evcouplings_torch.utils.config import InvalidParameterError

SPECIES_ANNOTATION_COLUMNS = ["OS", "Tax"]


def read_species_annotation_table(annotation_file):
    """Load annotation.csv and derive a "species" column from whichever
    of OS (UniProt) / Tax (UniRef) is better populated."""
    data = pd.read_csv(annotation_file, dtype=str)

    # strictly-better population wins, so ties keep the earlier column
    # (OS preferred over Tax)
    populated = {
        column: data[column].notnull().sum()
        for column in SPECIES_ANNOTATION_COLUMNS
        if column in data
    }
    best_column, best_count = None, 0
    for column, count in populated.items():
        if count > best_count:
            best_column, best_count = column, count

    if best_column is None:
        raise InvalidParameterError(
            "provided annotation file {} has no annotation "
            "information".format(annotation_file)
        )

    return data.assign(species=data.loc[:, best_column])[
        ["id", "name", "species"]
    ]


def most_similar_by_organism(similarities, id_to_organism):
    """Per species, the sequence most similar to the target.

    similarities: identities.csv contents; id_to_organism:
    annotation table with species column. Returns rows with columns
    id, species, identity_to_query.
    """
    annotated = similarities.merge(id_to_organism, on="id")

    # ascending sort + last() = the highest-identity row per species
    best = annotated.sort_values(by="identity_to_query") \
        .groupby("species").last()
    return best.assign(species=best.index).reset_index(drop=True)


def find_paralogs(target_id, id_to_organism, similarities,
                  identity_threshold):
    """Sequences from the target's own species that are diverged below
    the identity threshold (putative paralogs)."""
    base_query_id, _, _ = parse_header(target_id)

    annotated = similarities.merge(id_to_organism, on="id")

    # species the query itself appears under (substring match on id)
    own_species = annotated.species[
        [base_query_id in hit for hit in annotated.id]
    ].dropna()

    return annotated[
        annotated.species.isin(list(own_species))
        & (annotated.identity_to_query < identity_threshold)
    ]


def filter_best_reciprocal(alignment, paralogs, most_similar_in_species,
                           allowed_error=0.02, device=None):
    """Keep only per-species best hits that are best reciprocal hits:
    not closer to any paralog than to the query (within allowed_error).
    The paralog x sequence identities are counted on `device`."""
    ali = Alignment.from_path(alignment, "fasta", device=device)

    # paralog x sequence identity matrix (one identity count per paralog)
    to_paralogs = np.array([
        ali.identities_to(ali[ali.id_to_index[paralog_id]])
        for paralog_id in paralogs.id
    ], dtype=float).reshape(len(paralogs), len(ali.ids))

    # best reciprocal = no paralog matches the hit better than the query
    # does (within the error margin); one column per hit
    columns = to_paralogs[:, [ali.id_to_index[hit_id]
                              for hit_id in most_similar_in_species.id]]
    reciprocal = np.all(
        columns < most_similar_in_species.identity_to_query.to_numpy(float)
        + allowed_error, axis=0,
    )
    keep = list(most_similar_in_species.index[reciprocal])
    return most_similar_in_species.loc[keep, :]
