"""
Pfam domain identification and family utilities (port of
evcouplings_tpu/align/pfam.py): create_family_size_table,
remove_clan_overlaps, pfam_hits (hmmscan through align.tools).
"""

import gzip
from itertools import combinations

import pandas as pd

from evcouplings_torch.align.tools import read_hmmer_domtbl, run_hmmscan
from evcouplings_torch.utils.helpers import range_overlap

# columns of Pfam-A.clans.tsv
_CLAN_COLUMNS = ("pfam_id", "clan_id", "clan_name", "family_name",
                 "family_text")


def create_family_size_table(full_pfam_file, outfile=None):
    """Parse per-family sequence counts out of the Pfam-A.full.gz
    Stockholm flatfile; returns DataFrame (pfam_id, num_seqs)."""
    families = []
    record = {}

    with gzip.open(full_pfam_file, "rt", encoding="latin-1") as flat:
        for line in flat:
            if line.startswith("#=GF AC"):
                record["pfam_id"] = line[10:17]
            elif line.startswith("#=GF SQ"):
                record["num_seqs"] = int(line[10:])
            elif line.startswith("//"):
                # only complete entries count; partial state carries
                # over until both fields arrived (reference behavior)
                if len(record) == 2:
                    families.append(record)
                    record = {}

    table = pd.DataFrame(families, columns=["pfam_id", "num_seqs"])

    if outfile is not None:
        table.to_csv(outfile, index=False)
    return table


def remove_clan_overlaps(pfam_table):
    """Remove lower-scoring overlapping hits from the same Pfam clan
    (PfamScan.pl behavior, resolved by domain bitscore)."""
    def alignment_span(hit):
        return int(hit["ali_from"]), int(hit["ali_to"]) + 1

    by_clan = pfam_table.sort_values(
        by="domain_score", ascending=False
    ).groupby(by=["query_name", "clan_id"], as_index=False, sort=False)

    losers = []
    for (_, clan_name), clan_hits in by_clan:
        # grouping must only ever combine hits of an actual clan
        assert clan_name.startswith("CL")

        for pair in combinations(clan_hits.iterrows(), 2):
            # order each pair by index label: the reference's nested
            # loop only processes (idx1 < idx2) orderings, and on score
            # ties the smaller label survives
            (idx1, hit1), (idx2, hit2) = sorted(
                pair, key=lambda entry: entry[0]
            )
            if range_overlap(
                alignment_span(hit1), alignment_span(hit2)
            ) <= 0:
                continue
            better_is_1 = (
                float(hit1["domain_score"]) >= float(hit2["domain_score"])
            )
            losers.append(idx2 if better_is_1 else idx1)

    return pfam_table.loc[~pfam_table.index.isin(losers)]


def pfam_hits(query_file, hmm_database, prefix, clan_table_file,
              size_table_file, resolve_overlaps=True, **kwargs):
    """Scan query sequence(s) against the Pfam-A HMM database; returns
    a hit table annotated with clan membership and family sizes,
    optionally with same-clan overlaps resolved."""
    if resolve_overlaps and clan_table_file is None:
        raise ValueError(
            "Need to specify clan_table_file to resolve "
            "overlapping hits from same clan."
        )

    scan = run_hmmscan(query_file, hmm_database, prefix, **kwargs)
    hits = read_hmmer_domtbl(scan.domtblout)

    # strip version suffix from family accession
    hits = hits.assign(
        pfam_id=hits.target_accession.str.split(".").str[0]
    )

    # clan annotation (Pfam-A.clans.tsv) enables overlap resolution
    if clan_table_file is not None:
        hits = hits.merge(
            pd.read_csv(
                clan_table_file, sep="\t", names=list(_CLAN_COLUMNS)
            ),
            on="pfam_id", how="left",
        )

    if size_table_file is not None:
        hits = hits.merge(
            pd.read_csv(size_table_file), on="pfam_id", how="left"
        )
        hits = hits.assign(
            num_seqs_over_len=(
                hits.num_seqs
                / pd.to_numeric(hits.target_len, errors="raise")
            )
        )

    if resolve_overlaps:
        hits = remove_clan_overlaps(hits)

    return hits
