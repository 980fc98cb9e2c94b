"""
UniProt <-> PDB structure identification and index mapping via the
SIFTS database (https://www.ebi.ac.uk/pdbe/docs/sifts/); port of
evcouplings_tpu/compare/sifts.py (host pandas).

The SIFTS table and the UniProt sequence file are downloaded only when
the files named are missing; a job on a machine without network names
local files. Structure identification by sequence search (by_alignment,
find_homologs) runs jackhmmer or hmmbuild + hmmsearch on the host
through the align stage's search protocols.
"""

import json
import time
from collections import OrderedDict
from copy import deepcopy
from os import path

import pandas as pd

from evcouplings_torch.align.alignment import (
    Alignment,
    parse_header,
    read_fasta,
)
from evcouplings_torch.align.protocol import (
    hmmbuild_and_search,
    jackhmmer_search,
)
from evcouplings_torch.align.tools import read_hmmer_domtbl
from evcouplings_torch.compare.mapping import map_indices
from evcouplings_torch.utils.config import (
    InvalidParameterError,
    check_required,
)
from evcouplings_torch.utils.helpers import range_overlap
from evcouplings_torch.utils.system import (
    ResourceError,
    get_urllib,
    temp,
    tempdir,
    valid_file,
)

UNIPROT_MAPPING_URL = "https://rest.uniprot.org"
SIFTS_URL = (
    "ftp://ftp.ebi.ac.uk/pub/databases/msd/sifts/flatfiles/csv/"
    "uniprot_segments_observed.csv.gz"
)
SIFTS_REST_API = (
    "http://www.ebi.ac.uk/pdbe/api/mappings/uniprot_segments/{}"
)

# default parametrization for homolog search against the PDB seqres
# database (overridden by by_alignment kwargs); key set mirrors the
# align-stage search protocols' config contract
HMMER_CONFIG = {
    "prefix": None,
    "sequence_id": None,
    "sequence_file": None,
    "region": None,
    "first_index": 1,
    # search thresholds
    "use_bitscores": True,
    "domain_threshold": 0.5,
    "sequence_threshold": 0.5,
    "iterations": 1,
    "database": "sequence_database",
    # execution knobs
    "extract_annotation": False,
    "cpu": 1,
    "nobias": False,
    "reuse_alignment": False,
    "checkpoints_hmm": False,
    "checkpoints_ali": False,
    # database wiring (hmmbuild/hmmsearch defaults make the
    # pdb_alignment_method="hmmsearch" path usable without explicit
    # binary kwargs, mirroring the jackhmmer default)
    "jackhmmer": "jackhmmer",
    "hmmbuild": "hmmbuild",
    "hmmsearch": "hmmsearch",
    "sequence_database": None,
    "sequence_download_url":
        "http://rest.uniprot.org/uniprot/{}.fasta",
}


def fetch_uniprot_mapping(ids, from_db="UniProtKB_AC-ID",
                          to_db="UniProtKB", format="fasta",
                          isoforms=True, polling_interval=3,
                          max_polls=200, retry_kws=None):
    """Run a UniProt ID-mapping job and return the raw result text.

    Mirrors the 2022 UniProt id-mapping REST flow (submit job, poll,
    fetch results; reference sifts.py:77-183). retry_kws matches the
    reference keyword (there: requests.adapters.Retry kwargs); here
    the transport is urllib, so "total" maps to retries per GET
    request ("total": None, unlimited in requests, is capped at 100)
    and "backoff_factor" to the wait between them. Like the
    reference's session (which mounts retries on the GETs only, with
    status_forcelist 500/502/503/504), only transient failures of the
    result GETs are retried: permanent 4xx errors raise immediately,
    and the job-submitting POST is never re-sent (a dropped response
    to a completed POST must not double-submit the mapping job).
    """
    import urllib.error
    import urllib.parse
    import urllib.request

    if retry_kws is None:
        retry_kws = {"total": 5, "backoff_factor": 0.25}
    total = retry_kws.get("total", 5)
    http_retries = 100 if total is None else int(total)
    http_wait = float(retry_kws.get("backoff_factor", 0.25) or 0)
    RETRY_STATUS = tuple(
        retry_kws.get("status_forcelist", (500, 502, 503, 504))
    )

    def _with_retry(fn):
        last = None
        for attempt in range(http_retries + 1):
            try:
                return fn()
            except urllib.error.HTTPError as e:
                if e.code not in RETRY_STATUS:
                    raise
                last = e
            except urllib.error.URLError as e:
                last = e
            if attempt < http_retries and http_wait:
                time.sleep(http_wait)
        raise last

    def _post(url, data):
        payload = urllib.parse.urlencode(data).encode()
        with urllib.request.urlopen(url, payload) as r:
            return json.loads(r.read().decode())

    def _get_json(url):
        def go():
            with urllib.request.urlopen(url) as r:
                return json.loads(r.read().decode()), dict(r.headers)

        return _with_retry(go)

    def _get_text(url):
        def go():
            with urllib.request.urlopen(url) as r:
                return r.read().decode()

        return _with_retry(go)

    job = _post(
        "{}/idmapping/run".format(UNIPROT_MAPPING_URL),
        {"from": from_db, "to": to_db, "ids": ",".join(ids)},
    )
    job_id = job["jobId"]

    for _ in range(max_polls):
        status, _headers = _get_json(
            "{}/idmapping/status/{}".format(UNIPROT_MAPPING_URL, job_id)
        )
        if status.get("jobStatus") in (None, "FINISHED"):
            break
        if status.get("jobStatus") in ("RUNNING", "NEW", "QUEUED"):
            time.sleep(polling_interval)
        else:
            raise ResourceError(
                "UniProt mapping job failed: {}".format(status)
            )
    else:
        raise ResourceError(
            "UniProt mapping job {} still not finished after {} polls "
            "({}s apart) — raise max_polls or retry later".format(
                job_id, max_polls, polling_interval)
        )

    details, _ = _get_json(
        "{}/idmapping/details/{}".format(UNIPROT_MAPPING_URL, job_id)
    )
    url = details["redirectURL"]
    # use the stream endpoint: the paged /results/ endpoint caps each
    # response (size<=500) and would silently truncate large chunks
    # unless Link-header pagination were followed (reference
    # sifts.py:164-171 streams for the same reason)
    if "/stream/" not in url:
        url = url.replace("/results/", "/results/stream/")
    url += "?format={}".format(format)
    if isoforms:
        url += "&includeIsoform=true"
    return _get_text(url)


def find_homologs(pdb_alignment_method="jackhmmer", **kwargs):
    """Find homologs of the query in a sequence database using
    jackhmmer or hmmbuild+hmmsearch (on the host); returns (alignment,
    hit table). Hit names are UniProt-style db|AC|ID."""
    config = {**HMMER_CONFIG, **kwargs}

    if config["prefix"] is None:
        config["prefix"] = path.join(tempdir(), "compare")

    check_required(config, ["prefix"])

    if pdb_alignment_method == "hmmsearch":
        updated_config = deepcopy(config)
        updated_config["alignment_file"] = config.get(
            "raw_focus_alignment_file"
        )
        ar = hmmbuild_and_search(**updated_config)

        # raw focus alignment guarantees the query sequence is present
        with open(ar["raw_focus_alignment_file"]) as a:
            ali = Alignment.from_file(a, "fasta")
    elif pdb_alignment_method == "jackhmmer":
        ar = jackhmmer_search(**config)

        with open(ar["raw_alignment_file"]) as a:
            ali = Alignment.from_file(a, "stockholm")

        with open(config["prefix"] + "_raw.fasta", "w") as f:
            ali.write(f)
    else:
        raise InvalidParameterError(
            "Invalid pdb_alignment_method selected. Valid options "
            "are: jackhmmer, hmmsearch"
        )

    hits = read_hmmer_domtbl(ar["hittable_file"])

    hits = hits.assign(
        uniprot_ac=hits.target_name.map(lambda x: x.split("|")[1]),
        uniprot_id=hits.target_name.map(lambda x: x.split("|")[2]),
    ).rename(columns={
        "domain_score": "bitscore",
        "domain_i_Evalue": "e_value",
        "ali_from": "alignment_start",
        "ali_to": "alignment_end",
        "hmm_from": "hmm_start",
        "hmm_to": "hmm_end",
    })

    hits = hits.assign(
        alignment_start=pd.to_numeric(hits.alignment_start).astype(int),
        alignment_end=pd.to_numeric(hits.alignment_end).astype(int),
    )
    hits = hits.assign(
        alignment_id=(
            hits.target_name + "/"
            + hits.alignment_start.astype(str) + "-"
            + hits.alignment_end.astype(str)
        ),
    )

    hits = hits.loc[
        :, ["alignment_id", "uniprot_ac", "uniprot_id",
            "alignment_start", "alignment_end", "bitscore", "e_value"]
    ]
    return ali, hits


class SIFTSResult:
    """Structure hits + per-hit (seqres -> target numbering) maps."""

    def __init__(self, hits, mapping):
        self.hits = hits
        self.mapping = mapping


class SIFTS:
    """UniProt-to-PDB mapper based on the SIFTS segment table."""

    def __init__(self, sifts_table_file, sequence_file=None):
        # create table on first use (downloads the SIFTS flatfile)
        if not valid_file(sifts_table_file):
            self._create_mapping_table(sifts_table_file)

        # default NA handling would turn a chain literally named
        # "NA" into NaN, silently dropping it from every groupby —
        # keep "NA" as a string while still recognizing missing values
        self.table = pd.read_csv(
            sifts_table_file, comment="#", keep_default_na=False,
            na_values=["", "nan", "NaN", "None", "null", "NULL",
                       "N/A", "n/a"],
        )

        # drop entries with inconsistent segment lengths
        self.table = self.table.query(
            "(resseq_end - resseq_start) == (uniprot_end - uniprot_start)"
        )

        self.sequence_file = sequence_file

        if sequence_file is not None and not valid_file(sequence_file):
            self.create_sequence_file(sequence_file)

        if self.sequence_file is not None:
            self._add_uniprot_ids()

    def _create_mapping_table(self, sifts_table_file):
        """Download the SIFTS uniprot_segments_observed table and store
        it with internal column names."""
        temp_download_file = temp()
        get_urllib(SIFTS_URL, temp_download_file)

        table = pd.read_csv(
            temp_download_file, comment="#", compression="gzip"
        ).rename(columns={
            "PDB": "pdb_id",
            "CHAIN": "pdb_chain",
            "SP_PRIMARY": "uniprot_ac",
            "RES_BEG": "resseq_start",
            "RES_END": "resseq_end",
            "PDB_BEG": "coord_start",
            "PDB_END": "coord_end",
            "SP_BEG": "uniprot_start",
            "SP_END": "uniprot_end",
        })

        table.to_csv(sifts_table_file, index=False)

    def _add_uniprot_ids(self):
        """Derive the uniprot_id column from sequence-file headers
        (db|AC|ID format)."""
        ac_to_id = {}
        with open(self.sequence_file) as f:
            for seq_id, _ in read_fasta(f):
                _, ac, id_ = seq_id.split(" ")[0].split("|")
                ac_to_id[ac] = id_

        self.table = self.table.assign(
            uniprot_id=self.table.uniprot_ac.map(ac_to_id)
        )

    def create_sequence_file(self, output_file, chunk_size=1000,
                             max_retries=100):
        """Fetch all UniProt sequences referenced by the SIFTS table via
        the UniProt id-mapping API and store them as one FASTA file."""
        ids = self.table.uniprot_ac.unique().tolist()

        with open(output_file, "w") as f:
            for start in range(0, len(ids), chunk_size):
                chunk = ids[start:start + chunk_size]

                for retry in range(max_retries):
                    try:
                        text = fetch_uniprot_mapping(chunk)
                        f.write(text)
                        break
                    except Exception:
                        if retry == max_retries - 1:
                            raise
                        time.sleep(5)

        self.sequence_file = output_file
        # attach ID-based lookups immediately (the reference's
        # create_sequence_file ends the same way) — without this,
        # by_uniprot_id on a freshly built sequence file silently
        # returned nothing
        self._add_uniprot_ids()

    def _finalize_hits(self, hit_segments):
        """Collapse SIFTS segments per (pdb_id, chain) into hit rows +
        range-based seqres->uniprot mappings."""
        hits = []
        mappings = {}

        for i, ((pdb_id, pdb_chain), chain_grp) in enumerate(
            hit_segments.groupby(["pdb_id", "pdb_chain"])
        ):
            mapping = {
                (r["resseq_start"], r["resseq_end"]):
                    (r["uniprot_start"], r["uniprot_end"])
                for _, r in chain_grp.iterrows()
            }
            hits.append([pdb_id, pdb_chain, i])
            mappings[i] = mapping

        hits_df = pd.DataFrame(
            hits, columns=["pdb_id", "pdb_chain", "mapping_index"]
        )
        return SIFTSResult(hits_df, mappings)

    def by_pdb_id(self, pdb_id, pdb_chain=None, uniprot_id=None):
        """Hits + mappings for one PDB entry (optionally one chain /
        one UniProt entry to disambiguate chimeras)."""
        table = self.table
        has_up_id = "uniprot_id" in table.columns

        keep = table.pdb_id == pdb_id.lower()
        if pdb_chain is not None:
            keep &= table.pdb_chain == pdb_chain
        if uniprot_id is not None:
            up_match = table.uniprot_ac == uniprot_id
            if has_up_id:
                up_match |= table.uniprot_id == uniprot_id
            keep &= up_match

        hits = table[keep]

        distinct_acs = hits.uniprot_ac.unique()
        if len(distinct_acs) > 1:
            names = ", ".join(distinct_acs)
            if has_up_id:
                # ACs absent from the sequence file map to NaN ids
                names += " or " + ", ".join(
                    str(u) for u in hits.uniprot_id.dropna().unique()
                )
            raise ValueError(
                "Multiple Uniprot sequences on chains, "
                "please disambiguate using uniprot_id "
                "parameter: " + names
            )

        return self._finalize_hits(hits)

    def by_uniprot_id(self, uniprot_id, reduce_chains=False):
        """Hits + mappings for one UniProt AC (or ID when the sequence
        file was attached)."""
        query = "uniprot_ac == @uniprot_id"
        if "uniprot_id" in self.table.columns:
            query += " or uniprot_id == @uniprot_id"

        x = self.table.query(query)
        hit_table = self._finalize_hits(x)

        if reduce_chains:
            hit_table.hits = hit_table.hits.groupby(
                "pdb_id"
            ).first().reset_index()

        return hit_table

    def by_alignment(self, min_overlap=20, reduce_chains=False, **kwargs):
        """Find structures by aligning the query against the SIFTS
        sequence database (jackhmmer / hmmsearch), then intersecting
        hit regions with structural coverage."""
        def _create_mapping(r):
            _, query_start, query_end = parse_header(ali.ids[0])

            # query -> PDB-entry UniProt numbering
            m = map_indices(
                ali[0], query_start, query_end,
                ali[r["alignment_id"]],
                r["alignment_start"], r["alignment_end"],
            )

            # PDB-entry UniProt numbering -> seqres numbering
            n = pd.DataFrame({
                "j": [
                    str(v) for v in
                    range(r["uniprot_start"], r["uniprot_end"] + 1)
                ],
                "k": [
                    str(v) for v in
                    range(r["resseq_start"], r["resseq_end"] + 1)
                ],
            })

            mn = m.merge(n, on="j", how="inner").dropna()
            return dict(zip(mn.k, mn.i)), mn

        if self.sequence_file is None:
            raise ValueError(
                "Need to have SIFTS sequence file. "
                "Create using create_sequence_file() "
                "method or constructor."
            )

        ali, hits = find_homologs(
            sequence_database=self.sequence_file, **kwargs
        )

        hits = hits.merge(self.table, on="uniprot_ac", suffixes=("", "_"))

        # +1: range_overlap treats ends as exclusive. Deliberate
        # deviation from the reference, which feeds inclusive ends
        # straight in — undercounting every overlap by one residue
        # (a hit whose true overlap EQUALS min_overlap passes here
        # but is dropped there) and crashing on single-residue
        # segments
        hits = hits.assign(overlap=[
            range_overlap(
                (r["uniprot_start"], r["uniprot_end"] + 1),
                (r["alignment_start"], r["alignment_end"] + 1),
            )
            for _, r in hits.iterrows()
        ])

        mappings = {}
        mapping_rows = []

        # multiple segments per hit+chain are merged into one mapping
        hit_columns = ["alignment_id", "pdb_id", "pdb_chain"]
        for i, (hit, grp) in enumerate(hits.groupby(hit_columns)):
            agg_mapping = {}
            agg_df_raw = []
            for _, r in grp.iterrows():
                map_j, map_j_df = _create_mapping(r)
                agg_mapping.update(map_j)
                agg_df_raw.append(map_j_df)

            agg_df = pd.concat(agg_df_raw)
            mapping_rows.append(list(hit) + [i, len(grp) > 1])
            mappings[i] = agg_mapping

            prefix = kwargs.get("prefix", None)
            if prefix is not None:
                agg_df.rename(columns={
                    "j": "uniprot_of_pdb_index",
                    "A_j": "uniprot_of_pdb_residue",
                    "k": "pdb_seqres_index",
                }).to_csv(
                    "{}_mapping{}.csv".format(prefix, i), index=False
                )

        mapping_df = pd.DataFrame(
            mapping_rows,
            columns=hit_columns + ["mapping_index", "grouped_segments"],
        )

        def _residue_sort_key(res):
            # PDB coordinate ids may carry a trailing insertion code
            # letter; order numerically first, then by the letter.
            # Missing ("nan") and float-formatted values (the SIFTS
            # table stores None for unobserved coordinates) sort last
            # instead of crashing the whole by_alignment call
            text = str(res)
            if text in ("", "nan", "None"):
                return float("inf"), ""
            if text[-1].isalpha():
                num, ins = text[:-1], text[-1]
            else:
                num, ins = text, ""
            try:
                return float(num), ins
            except ValueError:
                return float("inf"), text

        def _agg_rule(col):
            # coordinate bounds respect insertion-code order; plain
            # index bounds are numeric min/max; overlaps add up;
            # anything else keeps the first segment's value
            if col == "overlap":
                return "sum"
            if col == "coord_start":
                return lambda vals: sorted(
                    vals, key=_residue_sort_key
                )[0]
            if col == "coord_end":
                return lambda vals: sorted(
                    vals, key=_residue_sort_key
                )[-1]
            if col.endswith("_start"):
                return "min"
            if col.endswith("_end"):
                return "max"
            return "first"

        agg_types = OrderedDict(
            (c, _agg_rule(c)) for c in hits.columns
            if c not in hit_columns
        )

        if len(hits) > 0:
            hits_grouped = hits.groupby(hit_columns).agg(
                agg_types
            ).reset_index()
        else:
            hits_grouped = hits

        hits_grouped = hits_grouped.merge(mapping_df, on=hit_columns)
        hits_grouped = hits_grouped.query("overlap >= @min_overlap")

        hits_grouped = hits_grouped.assign(
            bitscore=pd.to_numeric(
                hits_grouped.bitscore, errors="coerce"
            )
        ).sort_values(by="bitscore", ascending=False)

        if reduce_chains:
            hits_grouped = hits_grouped.groupby(
                "pdb_id"
            ).first().reset_index()
            hits_grouped = hits_grouped.sort_values(
                by="bitscore", ascending=False
            )

        # drop mappings not kept in the final table
        mappings = {
            idx: map_ for idx, map_ in mappings.items()
            if idx in hits_grouped.mapping_index.values
        }

        return SIFTSResult(hits_grouped, mappings)
