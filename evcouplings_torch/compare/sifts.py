"""
UniProt <-> PDB structure identification and index mapping via the
SIFTS database (https://www.ebi.ac.uk/pdbe/docs/sifts/); port of
evcouplings_tpu/compare/sifts.py (host pandas).

The SIFTS table and the UniProt sequence file are downloaded only when
the files named are missing; a job on a machine without network names
local files. Structure identification by sequence search (by_alignment,
find_homologs) needs jackhmmer or hmmsearch through the align stage's
search protocols, which the port does not run yet: both raise
NotImplementedError naming ROADMAP A19.
"""

import json
import time

import pandas as pd

from evcouplings_torch.align.alignment import read_fasta
from evcouplings_torch.utils.system import (
    ResourceError,
    get_urllib,
    temp,
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

_SEARCH_NOT_PORTED = (
    "structure identification by sequence search (jackhmmer/hmmsearch "
    "against the SIFTS sequence database) is not ported yet (ROADMAP "
    "A19); use by_alignment: False with a SIFTS lookup of sequence_id"
)


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
    """Homolog search of the query in a sequence database (jackhmmer or
    hmmbuild+hmmsearch): not ported yet (ROADMAP A19)."""
    raise NotImplementedError(_SEARCH_NOT_PORTED)


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
        """Structures found by aligning the query against the SIFTS
        sequence database: not ported yet (ROADMAP A19)."""
        raise NotImplementedError(_SEARCH_NOT_PORTED)
