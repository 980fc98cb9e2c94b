"""
UniProt -> EMBL/ENA coding-sequence mapping for genomic-distance-based
complex pairing (port of evcouplings_tpu/align/ena.py): extract_cds_ids,
extract_embl_annotation, add_full_header. Table formats:
uniprot_to_embl_table rows are `uniprot_ac <x> genome1:cds1,genome2:cds2`;
ena_genome_location_table is TSV `cds_id genome_id uniprot_ac start end`.
"""

from collections import Counter

import pandas as pd

from evcouplings_torch.align.ids import retrieve_sequence_ids

ANNOTATION_COLUMNS = [
    "cds", "genome_id", "uniprot_ac", "gene_start", "gene_end",
]


def _aligned_id_info(alignment_file):
    """(id list, id -> full headers) for the alignment members."""
    with open(alignment_file) as handle:
        return retrieve_sequence_ids(handle)


def extract_cds_ids(alignment_file, uniprot_to_embl_table):
    """Map the alignment's UniProt ACs to EMBL CDS ids, keeping only
    CDSs that map unambiguously to a single genome.

    Returns a list of (uniprot_ac, cds_id) pairs (ACs may repeat).
    """
    aligned = set(_aligned_id_info(alignment_file)[0])

    hits = []
    with open(uniprot_to_embl_table) as table:
        for raw in table:
            # mapping field is 'genome1:cds1,genome2:cds2,...'
            ac, _, mapping = raw.rstrip().split(" ")
            if ac not in aligned:
                continue
            # a CDS hit by more than one genome entry is ambiguous
            # and dropped (duplicate entries count as ambiguity too,
            # matching the reference's per-genome list counting)
            genome_hits = Counter(
                entry.split(":")[1] for entry in mapping.split(",")
            )
            hits.extend(
                (ac, cds) for cds, n in genome_hits.items() if n == 1
            )
    return hits


def extract_embl_annotation(uniprot_and_cds, ena_genome_location_table,
                            genome_location_filename):
    """Pull genomic locations for the given CDS ids from the ENA table.

    Returns a DataFrame with columns
    cds, genome_id, uniprot_ac, gene_start, gene_end (one row per CDS).
    The uniprot_ac column comes from the input pairing, not the table
    (the table's AC mapping can be ambiguous).

    genome_location_filename is accepted but unused — signature parity
    with the reference (align/ena.py:111-180, equally unused there);
    the caller writes the CSV itself, index column included, so the
    artifact matches reference-produced files byte for byte.
    """
    ac_by_cds = {cds: ac for ac, cds in uniprot_and_cds}

    def _wanted_rows():
        with open(ena_genome_location_table) as table:
            for raw in table:
                # strict five-field TSV rows (cds, genome, table AC,
                # start, end) — malformed rows fail loudly
                cds, genome, _table_ac, start, end = \
                    raw.rstrip().split("\t")
                ac = ac_by_cds.get(cds)
                if ac is not None:
                    yield [cds, genome, ac, start, end]

    return pd.DataFrame(list(_wanted_rows()),
                        columns=ANNOTATION_COLUMNS)


def add_full_header(table, alignment_file):
    """Expand the genome-location table with a full_id column: one row
    per alignment header that carries the row's UniProt AC."""
    headers_by_id = _aligned_id_info(alignment_file)[1]

    expanded = [
        {**row, "full_id": full_id}
        for row in table.to_dict("records")
        for full_id in headers_by_id[row["uniprot_ac"]]
    ]
    return pd.DataFrame(expanded,
                        columns=list(table.columns) + ["full_id"])
