"""
Alignment-stage protocols (port of evcouplings_tpu/align/protocol.py):
build or ingest a multiple sequence alignment, focus it on the target
sequence, filter, and emit statistics.

Config keys, output file names, outcfg keys and table columns are the
JAX package's. The homology search (jackhmmer, hmmbuild + hmmsearch) and
the hhfilter identity filter (seqid_filter) run on the host as external
programs through align.tools, as in the JAX package; the target sequence
is downloaded only when no local sequence_file is named. The numeric work
(identities, frequencies, conservation, N_eff through K1) runs on the
job's `device` (None: the CUDA device, "cpu": the host) through the
Alignment container. The `complex` protocol needs the complex pipeline
(ROADMAP A19c) and raises NotImplementedError.
"""

import os
from collections import OrderedDict
from collections.abc import Iterable
import re
from shutil import copy

import numpy as np
import pandas as pd

from evcouplings_torch import BailoutException
from evcouplings_torch._device import resolve_device
from evcouplings_torch.align import tools as at
from evcouplings_torch.align.alignment import (
    Alignment,
    detect_format,
    parse_header,
    read_fasta,
    write_fasta,
)
from evcouplings_torch.couplings.mapping import Segment
from evcouplings_torch.utils.config import (
    InvalidParameterError,
    MissingParameterError,
    check_required,
    read_config_file,
    write_config_file,
)
from evcouplings_torch.utils.system import (
    ResourceError,
    create_prefix_folders,
    get,
    valid_file,
    verify_resources,
)


# ---------------------------------------------------------------------------
# shared building blocks
# ---------------------------------------------------------------------------

def _require_clean_identifier(sequence_id):
    """Reject missing / non-string / whitespace-containing target ids."""
    problem = None
    if sequence_id is None:
        problem = ("Target sequence identifier (sequence_id) must be "
                   "defined and cannot be None/null.")
    elif not isinstance(sequence_id, str):
        problem = ("Target sequence identifier (sequence_id) must be "
                   "a string")
    elif sequence_id != sequence_id.strip() or " " in sequence_id \
            or len(sequence_id.split()) != 1:
        problem = ("Target sequence identifier (sequence_id) may not "
                   "contain any whitespace (spaces, tabs, ...)")
    if problem:
        raise InvalidParameterError(problem)


def _as_fraction(value):
    """Coverage thresholds may be given as percent ints or fractions."""
    return value / 100 if isinstance(value, int) else value


def _write_aligned(path, alignment, format="fasta"):
    with open(path, "w") as handle:
        alignment.write(handle, format)


def _load_autodetected(path, device, label="Input alignment",
                       filename_hint=True):
    """Open an alignment of unknown on-disk format whose numerics run on
    `device`.

    filename_hint=False detects from the content only (hmmbuild_and_search
    does): an .a3m-named aligned-FASTA input must not be reshaped by the
    a3m parser there."""
    verify_resources("{} does not exist".format(label), path)
    with open(path) as handle:
        fmt = detect_format(handle, filepath=path if filename_hint else "")
    if fmt is None:
        raise InvalidParameterError(
            "Format of input alignment {} could not be "
            "automatically detected.".format(path)
        )
    return Alignment.from_path(path, fmt, device=device), fmt


def _locate_row(ali, sequence_id):
    """Row index whose identifier starts with sequence_id."""
    hits = (
        row for row, name in enumerate(ali.ids)
        if name.startswith(sequence_id)
    )
    row = next(hits, None)
    if row is None:
        raise InvalidParameterError(
            "Target sequence {} could not be found in alignment".format(
                sequence_id
            )
        )
    return row


def _promote_row(ali, row):
    """Reorder so the given row becomes row 0 (swap, order otherwise
    preserved) — downstream code assumes the target sits first."""
    if row == 0:
        return ali
    order = np.arange(len(ali))
    order[[0, row]] = order[[row, 0]]
    return ali.select(sequences=order)


def _focus_on_target(ali_raw, focus_index, first_index,
                     prefer_header=False):
    """Restrict an alignment to the target row's residue columns and
    derive its region numbering.

    prefer_header=False (the `existing` protocol): an explicit
    first_index always wins over header-derived numbering.
    prefer_header=True (`hmmbuild_and_search`): first_index only fills
    in when the header has no /start-end range.

    Returns dict(ali, header, id, sequence, region_start, region_end).
    """
    target_row = ali_raw[focus_index]
    residue_cols = np.fromiter(
        (c not in (ali_raw._match_gap, ali_raw._insert_gap)
         for c in target_row),
        dtype=bool, count=len(target_row),
    )
    focused = ali_raw.select(columns=residue_cols)
    residues = "".join(focused[focus_index])

    raw_header = ali_raw.ids[focus_index]
    name, start, end = parse_header(raw_header.split()[0])

    override = first_index is not None and (
        start is None or end is None if prefer_header else True
    )
    if override:
        start = first_index
        end = start + len(residues) - 1

    if start is None or end is None:
        raise InvalidParameterError(
            "Could not extract region information "
            "from sequence header {} "
            "and first_index parameter is not given.".format(raw_header)
        )

    header = "{}/{}-{}".format(name, start, end)
    focused.ids[focus_index] = header
    return {
        "ali": focused, "header": header, "id": name,
        "sequence": residues,
        "region_start": start, "region_end": end,
    }


def _search_with_reuse(outcfg_file, kwargs, perform_search):
    """Run an external homology search, or restart from the saved
    search outcfg when reuse_alignment is set."""
    if kwargs["reuse_alignment"] and valid_file(outcfg_file):
        saved = read_config_file(outcfg_file)
        verify_resources(
            "Tried to reuse alignment, but empty or does not exist",
            saved["alignment"], saved["domtblout"],
        )
        return saved

    result = perform_search()
    # the bulky stdout log is dropped immediately
    try:
        os.remove(result["output"])
    except OSError:
        pass
    write_config_file(outcfg_file, result)
    return result


def _region_segment(sequence_id, start, end):
    span = range(start, end + 1)
    return [Segment("aa", sequence_id, start, end, span).to_list()]


# ---------------------------------------------------------------------------
# sequence helpers
# ---------------------------------------------------------------------------

def fetch_sequence(sequence_id, sequence_file, sequence_download_url,
                   out_file):
    """Obtain the target sequence from a local file, or by download when
    no sequence_file is named.

    Returns (path, (header, sequence)).
    """
    if sequence_file is not None:
        try:
            copy(sequence_file, out_file)
        except FileNotFoundError:
            raise ResourceError(
                "sequence_file does not exist: {}".format(sequence_file)
            )
    else:
        url = sequence_download_url.format(sequence_id)
        get(url, out_file, allow_redirects=True)

    verify_resources("Input sequence missing", out_file)

    with open(out_file) as handle:
        record = next(read_fasta(handle))
    return out_file, record


def cut_sequence(sequence, sequence_id, region=None, first_index=None,
                 out_file=None):
    """Cut a sequence to a subregion (inclusive end) and optionally save
    it with a `>id/start-end` header.

    Returns ((start, end), subsequence).
    """
    origin = 1 if first_index is None else first_index

    if region is None:
        region = (origin, origin + len(sequence) - 1)
        subsequence = sequence
    else:
        lo = region[0] - origin
        hi = region[1] - origin + 1
        if lo < 0 or hi > len(sequence):
            raise InvalidParameterError(
                "Invalid sequence range: "
                "region={} first_index={} len(sequence)={}".format(
                    region, origin, len(sequence)
                )
            )
        subsequence = sequence[lo:hi]

    if out_file is not None:
        record = ("{}/{}-{}".format(sequence_id, *region), subsequence)
        with open(out_file, "w") as handle:
            write_fasta([record], handle)

    return region, subsequence


def _bitscore_flag(value, seq_len):
    """Bitscores: floats are target-length-relative, ints/strings
    absolute."""
    if isinstance(value, float):
        return "{:.1f}".format(value * seq_len)
    return str(value)


def _evalue_flag(value):
    """E-values: ints are negative decimal exponents (2 -> "1E-2"),
    floats/strings literal."""
    if isinstance(value, int):
        return "1E{}".format(-value)
    return str(value).upper()


def search_thresholds(use_bitscores, seq_threshold, domain_threshold,
                      seq_len):
    """Normalize HMMER inclusion thresholds to command-line strings.

    The sequence-level threshold defaults to the domain-level one.
    """
    if domain_threshold is None:
        raise MissingParameterError(
            "domain_threshold must be explicitly defined "
            "and may not be None/empty"
        )

    def render(value):
        if use_bitscores:
            return _bitscore_flag(value, seq_len)
        return _evalue_flag(value)

    domain_flag = render(domain_threshold)
    seq_flag = (
        domain_flag if seq_threshold is None else render(seq_threshold)
    )
    return seq_flag, domain_flag


# annotation fields extracted from UniProt/UniRef headers
_ANNOTATION_COLUMNS = OrderedDict([
    ("GN", "gene"),
    ("OS", "organism"),
    ("PE", "existence_evidence"),
    ("SV", "sequence_version"),
    ("n", "num_cluster_members"),
    ("Tax", "taxon"),
    ("RepID", "representative_member"),
])


def extract_header_annotation(alignment, from_annotation=True):
    """Parse UniProt/UniRef `KEY=value` annotations out of sequence
    headers (or Stockholm GS DE lines) into a DataFrame."""
    key_splitter = re.compile(
        r"\s({})=".format("|".join(_ANNOTATION_COLUMNS))
    )

    def description_of(header):
        """(seq_id, free-text annotation or None) for one entry."""
        if from_annotation:
            # Stockholm: annotation rides in GS DE lines, not headers
            per_seq = alignment.annotation.get("GS", {}).get(header, {})
            return header, per_seq.get("DE")
        parts = header.split(maxsplit=1)
        if len(parts) < 2:
            # empty headers (a bare ">") yield no parts at all
            return header, None
        return parts[0], parts[1]

    rows = []
    for entry in alignment.ids:
        seq_id, text = description_of(entry)
        row = {"id": seq_id}
        if text is not None:
            tokens = ["id", seq_id, "name"] + re.split(key_splitter, text)
            row = dict(zip(tokens[::2], tokens[1::2]))
        rows.append(row)

    wanted = ["id", "name"] + list(_ANNOTATION_COLUMNS)
    return pd.DataFrame(rows).reindex(wanted, axis=1)


# ---------------------------------------------------------------------------
# statistics writers
# ---------------------------------------------------------------------------

def describe_seq_identities(alignment, target_seq_index=0):
    """Identity of every sequence to the target sequence (on the
    alignment's device)."""
    return pd.DataFrame({
        "id": alignment.ids,
        "identity_to_query": alignment.identities_to(
            alignment[target_seq_index]
        ),
    })


def describe_frequencies(alignment, first_index, target_seq_index=None):
    """Per-position symbol frequencies + conservation table.

    Lowercase (non-match) positions get NaN statistics.
   
    """
    symbols = list(alignment.alphabet)
    freq = alignment.frequencies

    table = pd.DataFrame(
        freq[:, [alignment.alphabet_map[s] for s in symbols]],
        columns=symbols,
    )
    table.insert(0, "conservation", alignment.conservation())
    table.insert(
        0, "A_i",
        # no target row: empty strings, NOT float NaN — the lowercase
        # mask below needs the .str accessor to work (and "" is not
        # its own lowercase-able letter, so no row masks out)
        np.full(alignment.L, "", dtype=object)
        if target_seq_index is None
        else alignment[target_seq_index],
    )
    table.insert(0, "i", np.arange(alignment.L) + first_index)

    stat_columns = ["conservation"] + symbols
    lowercase_rows = (
        (table.A_i.str.lower() == table.A_i) & (table.A_i != "")
    )
    table.loc[lowercase_rows, stat_columns] = np.nan
    return table


def describe_coverage(alignment, prefix, first_index,
                      minimum_column_coverage):
    """buildali-style coverage statistics table, one row per column-
    coverage threshold."""
    thresholds = (
        minimum_column_coverage
        if isinstance(minimum_column_coverage, Iterable)
        else [minimum_column_coverage]
    )

    numbering = np.arange(alignment.L) + first_index
    gap_symbol = alignment._match_gap
    gap_freq = alignment.frequencies[
        :, alignment.alphabet_map[gap_symbol]
    ]

    rows = []
    for raw_threshold in thresholds:
        # None = column-coverage filtering disabled: every column
        # counts as covered
        threshold = _as_fraction(raw_threshold)
        covered = (
            np.ones(alignment.L, dtype=bool) if threshold is None
            else gap_freq <= 1 - threshold
        )
        where_covered = np.flatnonzero(covered)

        if where_covered.size:
            span_lo = int(where_covered[0])
            span_hi = int(where_covered[-1])
            holes_in_span = int(
                np.count_nonzero(~covered[span_lo:span_hi + 1])
            )
        else:
            # nothing meets the threshold: empty span, no holes —
            # not an IndexError
            span_lo = span_hi = 0
            holes_in_span = 0
        n_covered = int(covered.sum())

        rows.append({
            "prefix": prefix,
            "minimum_column_coverage": threshold,
            "num_seqs": alignment.N,
            "seqlen": alignment.L,
            "num_cov": n_covered,
            "num_lc": alignment.L - n_covered,
            "perc_cov": n_covered / covered.size,
            "1st_uc": numbering[span_lo],
            "last_uc": numbering[span_hi],
            "len_cov": numbering[span_hi] - numbering[span_lo] + 1,
            "num_lc_cov": holes_in_span,
            "N_eff": np.nan,
        })

    return pd.DataFrame(rows, columns=[
        "prefix", "minimum_column_coverage", "num_seqs",
        "seqlen", "num_cov", "num_lc", "perc_cov",
        "1st_uc", "last_uc", "len_cov", "num_lc_cov", "N_eff",
    ])


# ---------------------------------------------------------------------------
# alignment post-processing
# ---------------------------------------------------------------------------

def modify_alignment(focus_ali, target_seq_index, target_seq_id,
                     region_start, **kwargs):
    """Apply identity/fragment/column-coverage filtering to a focus
    alignment and write statistics + the final .a2m.

    Returns (outcfg, alignment).
    """
    check_required(
        kwargs,
        [
            "prefix", "seqid_filter", "hhfilter",
            "minimum_sequence_coverage", "minimum_column_coverage",
            "compute_num_effective_seqs", "theta",
        ],
    )

    prefix = kwargs["prefix"]
    create_prefix_folders(prefix)

    focus_fasta_file = prefix + "_raw_focus.fasta"

    outcfg = {
        "alignment_file": prefix + ".a2m",
        "statistics_file": prefix + "_alignment_statistics.csv",
        "frequencies_file": prefix + "_frequencies.csv",
        "identities_file": prefix + "_identities.csv",
        "raw_focus_alignment_file": focus_fasta_file,
    }

    ali = _promote_row(focus_ali, target_seq_index)
    target_seq_index = 0
    _write_aligned(focus_fasta_file, ali)

    # optional pairwise identity filter via external hhfilter
    if kwargs["seqid_filter"] is not None:
        filtered_file = prefix + "_filtered.a3m"
        at.run_hhfilter(
            focus_fasta_file, filtered_file,
            threshold=kwargs["seqid_filter"],
            columns="first", binary=kwargs["hhfilter"],
        )
        with open(filtered_file) as handle:
            ali = Alignment.from_file(handle, "a3m", device=ali.device)
        _write_aligned(prefix + "_raw_focus_filtered.fasta", ali)

    # fragment filter: drop rows covering too little of the target
    if kwargs["minimum_sequence_coverage"] is not None:
        min_cov = _as_fraction(kwargs["minimum_sequence_coverage"])
        row_coverage = 1 - ali.count("-", axis="seq")
        ali = ali.select(sequences=row_coverage >= min_cov)

    describe_seq_identities(
        ali, target_seq_index=target_seq_index
    ).to_csv(outcfg["identities_file"], float_format="%.3f", index=False)

    describe_frequencies(
        ali, region_start, target_seq_index=target_seq_index
    ).to_csv(outcfg["frequencies_file"], float_format="%.3f", index=False)

    coverage_stats = describe_coverage(
        ali, prefix, region_start, kwargs["minimum_column_coverage"]
    )

    numbering = np.arange(ali.L, dtype="int32") + region_start

    # lowercase columns exceeding the gap threshold; they are excluded
    # from inference downstream, so the position list drops them too
    lowered = None
    if kwargs["minimum_column_coverage"] is not None:
        max_gaps = 1 - _as_fraction(kwargs["minimum_column_coverage"])
        lowered = ali.count(ali._match_gap, axis="pos") > max_gaps
        ali = ali.lowercase_columns(lowered)
        numbering = numbering[~lowered]

    # optional N_eff computation on the inference columns
    n_eff = None
    if kwargs["compute_num_effective_seqs"]:
        inference_ali = (
            ali if lowered is None else ali.select(columns=~lowered)
        )
        inference_ali.set_weights(kwargs["theta"])
        n_eff = float(inference_ali.weights.sum())
        coverage_stats.loc[:, "N_eff"] = n_eff

        weights_file = prefix + "_inverse_sequence_weights.csv"
        outcfg["sequence_weights_file"] = weights_file
        pd.DataFrame({
            "id": inference_ali.ids,
            "num_cluster_members": inference_ali.num_cluster_members,
        }).to_csv(weights_file, index=False)

    coverage_stats.to_csv(
        outcfg["statistics_file"], float_format="%.3f", index=False
    )

    outcfg.update({
        "num_sites": len(numbering),
        "num_sequences": len(ali),
        "effective_sequences": n_eff,
        "region_start": region_start,
        "segments": [
            Segment(
                "aa", target_seq_id, region_start,
                region_start + ali.L - 1, numbering,
            ).to_list()
        ],
    })

    _write_aligned(outcfg["alignment_file"], ali)
    return outcfg, ali


# ---------------------------------------------------------------------------
# protocols
# ---------------------------------------------------------------------------

def existing(**kwargs):
    """Protocol: start from a user-supplied alignment, focus on the
    target sequence, then filter as usual.

    This is the hermetic entry point of the pipeline (no external
    binaries needed). The optional `device` key (None: the CUDA device,
    "cpu": the host) selects where the alignment's numerics run.
    """
    check_required(
        kwargs,
        ["prefix", "input_alignment", "sequence_id", "first_index",
         "extract_annotation"],
    )

    device = resolve_device(kwargs.get("device"))
    prefix = kwargs["prefix"]
    create_prefix_folders(prefix)

    ali_raw, fmt = _load_autodetected(kwargs["input_alignment"],
                                      device=device)

    annotation_file = None
    if kwargs["extract_annotation"]:
        annotation_file = prefix + "_annotation.csv"
        extract_header_annotation(
            ali_raw, from_annotation=(fmt == "stockholm")
        ).to_csv(annotation_file, index=False)

    sequence_id = kwargs["sequence_id"]
    _require_clean_identifier(sequence_id)

    focus_index = _locate_row(ali_raw, sequence_id)
    target = _focus_on_target(
        ali_raw, focus_index, kwargs["first_index"]
    )

    target_sequence_file = prefix + ".fa"
    with open(target_sequence_file, "w") as handle:
        write_fasta([(target["header"], target["sequence"])], handle)

    mod_outcfg, _ali = modify_alignment(
        target["ali"], focus_index, target["id"],
        target["region_start"], **kwargs
    )

    outcfg = dict(
        mod_outcfg,
        sequence_id=sequence_id,
        sequence_file=target_sequence_file,
        first_index=target["region_start"],
        target_sequence_file=target_sequence_file,
        focus_sequence=target["header"],
        focus_mode=True,
    )
    if annotation_file is not None:
        outcfg["annotation_file"] = annotation_file

    write_config_file(prefix + ".align_existing.outcfg", outcfg)
    return outcfg


def jackhmmer_search(**kwargs):
    """Protocol: iterative jackhmmer search against a sequence database
    (on the host), restarting from the saved search outcfg when
    reuse_alignment is set."""
    check_required(
        kwargs,
        [
            "prefix", "sequence_id", "sequence_file",
            "sequence_download_url", "region", "first_index",
            "use_bitscores", "domain_threshold", "sequence_threshold",
            "database", "iterations", "cpu", "nobias", "reuse_alignment",
            "checkpoints_hmm", "checkpoints_ali", "jackhmmer",
            "extract_annotation",
        ],
    )
    prefix = kwargs["prefix"]
    _require_clean_identifier(kwargs["sequence_id"])
    create_prefix_folders(prefix)

    target_sequence_file = prefix + ".fa"
    full_sequence_file = prefix + "_full.fa"

    _, (_full_id, full_seq) = fetch_sequence(
        kwargs["sequence_id"], kwargs["sequence_file"],
        kwargs["sequence_download_url"], full_sequence_file,
    )

    (region_start, region_end), query_seq = cut_sequence(
        full_seq, kwargs["sequence_id"], kwargs["region"],
        kwargs["first_index"], target_sequence_file,
    )

    def perform_search():
        seq_flag, domain_flag = search_thresholds(
            kwargs["use_bitscores"], kwargs["sequence_threshold"],
            kwargs["domain_threshold"], len(query_seq),
        )
        passthrough = {
            name: kwargs[name] for name in (
                "use_bitscores", "iterations", "nobias", "cpu",
                "checkpoints_hmm", "checkpoints_ali",
            )
        }
        hits = at.run_jackhmmer(
            query=target_sequence_file,
            database=kwargs[kwargs["database"]],
            prefix=prefix,
            domain_threshold=domain_flag,
            seq_threshold=seq_flag,
            binary=kwargs["jackhmmer"],
            **passthrough,
        )
        return dict(hits._asdict())

    ali = _search_with_reuse(
        prefix + ".align_jackhmmer_search.outcfg", kwargs, perform_search
    )

    return {
        "sequence_id": kwargs["sequence_id"],
        "target_sequence_file": target_sequence_file,
        "sequence_file": full_sequence_file,
        "first_index": kwargs["first_index"],
        "focus_mode": True,
        "raw_alignment_file": ali["alignment"],
        "hittable_file": ali["domtblout"],
        "segments": _region_segment(
            kwargs["sequence_id"], region_start, region_end
        ),
        "focus_sequence": "{}/{}-{}".format(
            kwargs["sequence_id"], region_start, region_end
        ),
    }


def _assemble_hmmsearch_fasta(alignment_result, prefix):
    """Prepend the (RF-gapped) query sequence to an hmmsearch Stockholm
    result and save as FASTA, so downstream focusing/numbering works."""
    with open(alignment_result["target_sequence_file"]) as handle:
        query_ali = Alignment.from_file(handle, format="fasta")

    out_path = prefix + "_raw.fasta"
    search_hits = alignment_result["raw_alignment_file"]

    if not valid_file(search_hits):
        # empty search result: the "alignment" is just the query
        _write_aligned(out_path, query_ali)
        return out_path

    hits_ali = Alignment.from_path(search_hits, "stockholm")

    rf = hits_ali.annotation.get("GC", {}).get("RF")
    if rf is None:
        raise ValueError(
            "Stockholm alignment {} missing RF annotation of match "
            "states".format(search_hits)
        )

    is_match = [symbol == "x" for symbol in rf]
    if sum(is_match) != query_ali.L:
        raise ValueError(
            "HMMsearch result {} does not have a one-to-one mapping to "
            "the query sequence columns".format(search_hits)
        )

    # distribute query residues over match states, gaps elsewhere
    residues = iter(query_ali.matrix[0, :])
    gapped_query = "".join(
        next(residues) if m else "-" for m in is_match
    )

    with open(out_path, "w") as handle:
        Alignment.from_dict({query_ali.ids[0]: gapped_query}).write(handle)
        hits_ali.write(handle)
    return out_path


def hmmbuild_and_search(**kwargs):
    """Protocol: build an HMM from an input alignment and search it
    against a sequence database (both on the host). Stops at the raw
    focus alignment: the downstream stages run the filtering."""
    # all columns of the input alignment become match states
    SYMFRAC_HMMBUILD = 0.0

    check_required(
        kwargs,
        [
            "prefix", "sequence_id", "alignment_file",
            "use_bitscores", "domain_threshold", "sequence_threshold",
            "database", "cpu", "nobias", "reuse_alignment",
            "hmmbuild", "hmmsearch", "first_index",
        ],
    )
    prefix = kwargs["prefix"]
    _require_clean_identifier(kwargs["sequence_id"])
    create_prefix_folders(prefix)

    # --- focus the input alignment on the target sequence ---
    ali_raw, _fmt = _load_autodetected(
        kwargs["alignment_file"], device=kwargs.get("device"),
        filename_hint=False,
    )

    focus_index = _locate_row(ali_raw, kwargs["sequence_id"])
    target = _focus_on_target(
        ali_raw, focus_index, kwargs["first_index"], prefer_header=True
    )
    region_start = target["region_start"]
    region_end = target["region_end"]

    target_sequence_file = prefix + ".fa"
    with open(target_sequence_file, "w") as handle:
        write_fasta([(target["header"], target["sequence"])], handle)

    focus_fasta_file = prefix + "_raw_focus_input.fasta"
    _write_aligned(
        focus_fasta_file, _promote_row(target["ali"], focus_index)
    )

    # --- hmmbuild + hmmsearch (or restart from saved outcfg) ---
    def perform_search():
        seq_flag, domain_flag = search_thresholds(
            kwargs["use_bitscores"], kwargs["sequence_threshold"],
            kwargs["domain_threshold"], region_end - region_start + 1,
        )
        built = at.run_hmmbuild(
            alignment_file=focus_fasta_file,
            prefix=prefix,
            symfrac=SYMFRAC_HMMBUILD,
            cpu=kwargs["cpu"],
            binary=kwargs["hmmbuild"],
        )
        hits = at.run_hmmsearch(
            hmmfile=built.hmmfile,
            database=kwargs[kwargs["database"]],
            prefix=prefix,
            use_bitscores=kwargs["use_bitscores"],
            domain_threshold=domain_flag,
            seq_threshold=seq_flag,
            nobias=kwargs["nobias"],
            cpu=kwargs["cpu"],
            binary=kwargs["hmmsearch"],
        )
        return dict(hits._asdict(), hmmfile=built.hmmfile)

    ali = _search_with_reuse(
        prefix + ".align_hmmbuild_and_search.outcfg", kwargs,
        perform_search,
    )

    outcfg = {
        "sequence_file": target_sequence_file,
        "first_index": region_start,
        "input_raw_focus_alignment": focus_fasta_file,
        "target_sequence_file": target_sequence_file,
        "focus_mode": True,
        "raw_alignment_file": ali["alignment"],
        "hittable_file": ali["domtblout"],
    }
    outcfg["raw_focus_alignment_file"] = _assemble_hmmsearch_fasta(
        outcfg, prefix
    )
    outcfg["segments"] = _region_segment(
        kwargs["sequence_id"], region_start, region_end
    )
    outcfg["focus_sequence"] = "{}/{}-{}".format(
        kwargs["sequence_id"], region_start, region_end
    )
    return outcfg


def standard(**kwargs):
    """Protocol: jackhmmer search (on the host), then focus/filter the
    result with its numerics on the job's `device` (buildali4
    workflow)."""
    check_required(kwargs, ["prefix", "extract_annotation"])

    device = resolve_device(kwargs.get("device"))
    prefix = kwargs["prefix"]
    create_prefix_folders(prefix)

    search_outcfg = jackhmmer_search(**kwargs)

    segment = Segment.from_list(search_outcfg["segments"][0])

    ali_raw = Alignment.from_path(
        search_outcfg["raw_alignment_file"], "stockholm", device=device
    )

    annotation_file = None
    if kwargs["extract_annotation"]:
        annotation_file = prefix + "_annotation.csv"
        extract_header_annotation(ali_raw).to_csv(
            annotation_file, index=False
        )

    # jackhmmer puts the query first; focus on its non-gap columns
    query_has_residue = ali_raw[0] != "-"
    focus_ali = ali_raw.select(columns=query_has_residue)

    mod_outcfg, ali = modify_alignment(
        focus_ali, 0, segment.sequence_id, segment.region_start, **kwargs
    )

    outcfg = {**search_outcfg, **mod_outcfg}
    if annotation_file is not None:
        outcfg["annotation_file"] = annotation_file

    write_config_file(prefix + ".align_standard.outcfg", outcfg)

    if len(ali) <= 1:
        raise BailoutException("align: No sequences found")

    return outcfg


def complex(**kwargs):
    """Not ported yet (ROADMAP A19c): a monomer alignment protocol plus
    the genome-location annotations complex pairing needs."""
    raise NotImplementedError(
        "align protocol 'complex' needs the complex pipeline, which is "
        "not ported yet (ROADMAP A19c)")


# protocol registry: function names double as the config-facing names
PROTOCOLS = {
    fn.__name__: fn
    for fn in (
        standard, jackhmmer_search, hmmbuild_and_search, existing,
        complex,
    )
}


def run(**kwargs):
    """Dispatch to the alignment protocol named by kwargs["protocol"]."""
    check_required(kwargs, ["protocol"])

    selected = kwargs["protocol"]
    if selected not in PROTOCOLS:
        raise InvalidParameterError(
            "Invalid protocol selection: {}. Valid protocols are: "
            "{}".format(selected, ", ".join(PROTOCOLS))
        )

    return PROTOCOLS[selected](**kwargs)
