"""
Alignment-stage protocols (port of evcouplings_tpu/align/protocol.py):
ingest a multiple sequence alignment, focus it on the target sequence,
filter, and emit statistics.

The `existing` protocol is ported: it runs no external binary. Config
keys, output file names, outcfg keys and table columns are the JAX
package's. The numeric work (identities, frequencies, conservation,
N_eff through K1) runs on the job's `device` through the Alignment
container. The protocols that run jackhmmer/hmmbuild/hmmsearch or
download sequences (jackhmmer_search, hmmbuild_and_search, standard,
complex), and the hhfilter identity filter (seqid_filter), raise
NotImplementedError naming ROADMAP A19.
"""

from collections import OrderedDict
from collections.abc import Iterable
import re

import numpy as np
import pandas as pd

from evcouplings_torch._device import resolve_device
from evcouplings_torch.align.alignment import (
    Alignment,
    detect_format,
    parse_header,
    write_fasta,
)
from evcouplings_torch.couplings.mapping import Segment
from evcouplings_torch.utils.config import (
    InvalidParameterError,
    check_required,
    write_config_file,
)
from evcouplings_torch.utils.system import (
    create_prefix_folders,
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


def _load_autodetected(path, device, label="Input alignment"):
    """Open an alignment of unknown on-disk format (detected from its
    content and file extension) whose numerics run on `device`."""
    verify_resources("{} does not exist".format(label), path)
    with open(path) as handle:
        fmt = detect_format(handle, filepath=path)
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


def _focus_on_target(ali_raw, focus_index, first_index):
    """Restrict an alignment to the target row's residue columns and
    derive its region numbering (an explicit first_index wins over the
    header's /start-end range).

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

    if first_index is not None:
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

    # optional pairwise identity filter: the external hhfilter binary
    if kwargs["seqid_filter"] is not None:
        raise NotImplementedError(
            "seqid_filter runs the external hhfilter binary, which the "
            "port does not call yet (ROADMAP A19)")

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


def _external_search(name):
    """Protocols that run external search binaries (jackhmmer, hmmbuild,
    hmmsearch, hhfilter) or download sequences raise until the port
    calls them."""
    def protocol(**kwargs):
        raise NotImplementedError(
            "align protocol {!r} runs external binaries or downloads "
            "that the port does not call yet (ROADMAP A19); use "
            "protocol: existing".format(name))
    protocol.__name__ = name
    protocol.__doc__ = "Not ported yet (ROADMAP A19): {}.".format(name)
    return protocol


jackhmmer_search = _external_search("jackhmmer_search")
hmmbuild_and_search = _external_search("hmmbuild_and_search")
standard = _external_search("standard")
complex = _external_search("complex")


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
