"""
Concatenation protocols for protein complexes (port of
evcouplings_tpu/complex/protocol.py): pair putatively interacting
sequences from two monomer alignments (best hit per species, or
reciprocally closest genes on one genome), write the concatenated
alignment, and filter it as the align stage filters a monomer's.

Config keys, output file names and outcfg keys are the JAX package's
(the outcfg key concatentation_statistics_file keeps its spelling). The
pairing runs on the host (pandas); the concatenated alignment's numerics
(the best-reciprocal identities, identities to the target, frequencies,
N_eff through K1) run on the job's `device` (None: the CUDA device,
"cpu": the host). genome_distance draws its distance plot with
matplotlib, imported where it draws.
"""

from collections import Counter

import numpy as np
import pandas as pd

from evcouplings_torch._device import resolve_device
from evcouplings_torch.align.protocol import modify_alignment
from evcouplings_torch.complex.alignment import write_concatenated_alignment
from evcouplings_torch.complex.distance import (
    best_reciprocal_matching,
    find_possible_partners,
    plot_distance_distribution,
)
from evcouplings_torch.complex.similarity import (
    filter_best_reciprocal,
    find_paralogs,
    most_similar_by_organism,
    read_species_annotation_table,
)
from evcouplings_torch.couplings.mapping import Segment
from evcouplings_torch.utils.config import (
    InvalidParameterError,
    check_required,
)
from evcouplings_torch.utils.system import (
    create_prefix_folders,
    verify_resources,
)


def modify_complex_segments(outcfg, **kwargs):
    """Rename the monomer segments of the concatenated alignment to
    A_1, A_2, ..., B_1, ... (first/second monomer prefixes)."""
    def _relabel(config_key, letter):
        renamed = []
        for number, entry in enumerate(kwargs[config_key], start=1):
            segment = Segment.from_list(entry)
            segment.segment_id = "{}_{}".format(letter, number)
            renamed.append(segment.to_list())
        return renamed

    outcfg["segments"] = (
        _relabel("first_segments", "A") + _relabel("second_segments", "B")
    )
    return outcfg


def _count_embl_cds(genome_location_filename):
    """Distinct uniprot ACs with a genome location, or NaN when the
    table is absent or carries no uniprot_ac column."""
    if genome_location_filename is None:
        return np.nan
    locations = pd.read_csv(genome_location_filename)
    if "uniprot_ac" not in locations.columns:
        return np.nan
    return len(set(locations.uniprot_ac))


def describe_concatenation(annotation_file_1, annotation_file_2,
                           genome_location_filename_1,
                           genome_location_filename_2, outfile):
    """Write summary statistics of the two monomer alignments and their
    species overlap (a one-row CSV)."""
    species_1 = read_species_annotation_table(
        annotation_file_1
    ).species.values
    species_2 = read_species_annotation_table(
        annotation_file_2
    ).species.values

    # CDS counts only when both genome tables exist
    both_present = (genome_location_filename_1 is not None
                    and genome_location_filename_2 is not None)
    embl_cds1 = _count_embl_cds(
        genome_location_filename_1 if both_present else None
    )
    embl_cds2 = _count_embl_cds(
        genome_location_filename_2 if both_present else None
    )

    def median_copies(species):
        return float(np.median(list(Counter(species).values())))

    statistics = {
        "num_seqs_1": len(species_1),
        "num_seqs_2": len(species_2),
        "num_nonred_species_1": len(set(species_1)),
        "num_nonred_species_2": len(set(species_2)),
        "num_species_overlap": len(set(species_1) & set(species_2)),
        "median_num_per_species_1": median_copies(species_1),
        "median_num_per_species_2": median_copies(species_2),
        "num_with_embl_cds_1": embl_cds1,
        "num_with_embl_cds_2": embl_cds2,
    }
    pd.DataFrame([statistics]).to_csv(outfile)


def _run_describe_concatenation(outcfg, **kwargs):
    stats_file = kwargs["prefix"] + "_concatenation_statistics.csv"
    describe_concatenation(
        kwargs["first_annotation_file"],
        kwargs["second_annotation_file"],
        kwargs.get("first_genome_location_file"),
        kwargs.get("second_genome_location_file"),
        stats_file,
    )
    # the key is spelled as in the JAX package (concatentation)
    outcfg["concatentation_statistics_file"] = stats_file
    return outcfg


def _write_and_filter_concatenated(id_pairing, kwargs, device):
    """Shared tail of both protocols: concatenate, save raw + monomer
    alignments, run modify_alignment filtering, assemble outcfg."""
    prefix = kwargs["prefix"]
    target_seq_id, target_seq_index, raw_ali, mon_ali_1, mon_ali_2 = \
        write_concatenated_alignment(
            id_pairing,
            kwargs["first_alignment_file"],
            kwargs["second_alignment_file"],
            kwargs["first_focus_sequence"],
            kwargs["second_focus_sequence"],
            device=device,
        )

    def save(alignment, tag):
        filename = prefix + tag + ".fasta"
        with open(filename, "w") as handle:
            alignment.write(handle)
        return filename

    raw_alignment_file = save(raw_ali, "_raw")

    outcfg, _ = modify_alignment(
        raw_ali,
        target_seq_index,
        target_seq_id,
        kwargs["first_region_start"],
        **kwargs,
    )
    outcfg.update({
        "raw_alignment_file": raw_alignment_file,
        "first_concatenated_monomer_alignment_file":
            save(mon_ali_1, "_monomer_1"),
        "second_concatenated_monomer_alignment_file":
            save(mon_ali_2, "_monomer_2"),
        "focus_sequence": target_seq_id,
    })

    outcfg = modify_complex_segments(outcfg, **kwargs)
    return _run_describe_concatenation(outcfg, **kwargs)


# configuration keys shared by both concatenation protocols
_COMMON_REQUIRED = [
    "prefix",
    "first_alignment_file", "second_alignment_file",
    "first_focus_sequence", "second_focus_sequence",
    "first_focus_mode", "second_focus_mode",
    "first_segments", "second_segments",
    "first_annotation_file", "second_annotation_file",
]


def genome_distance(**kwargs):
    """Protocol: pair sequences whose coding sequences are reciprocally
    closest on the same genome (operon-based pairing)."""
    check_required(
        kwargs,
        _COMMON_REQUIRED + [
            "first_region_start", "second_region_start",
            "genome_distance_threshold",
            "first_genome_location_file", "second_genome_location_file",
        ],
    )
    device = resolve_device(kwargs.get("device"))

    verify_resources(
        "Input alignment does not exist",
        kwargs["first_alignment_file"], kwargs["second_alignment_file"],
    )
    verify_resources(
        "Genome location file does not exist",
        kwargs["first_genome_location_file"],
        kwargs["second_genome_location_file"],
    )
    create_prefix_folders(kwargs["prefix"])

    candidates = find_possible_partners(
        pd.read_csv(kwargs["first_genome_location_file"], header=0),
        pd.read_csv(kwargs["second_genome_location_file"], header=0),
    )
    reciprocal_best = best_reciprocal_matching(candidates)

    threshold = kwargs["genome_distance_threshold"]
    if threshold:
        paired = reciprocal_best[reciprocal_best.distance < threshold]
    else:
        paired = reciprocal_best

    paired = paired.assign(
        id_1=paired.uniprot_id_1, id_2=paired.uniprot_id_2
    )

    outcfg = _write_and_filter_concatenated(paired, kwargs, device)

    outcfg["distance_plot_file"] = kwargs["prefix"] + "_distplot.pdf"
    plot_distance_distribution(
        reciprocal_best, outcfg["distance_plot_file"]
    )
    return outcfg


def _best_hits_per_species(kwargs, side, device):
    """Per-species most-similar hits for one monomer ("first"/
    "second"), optionally restricted to best-reciprocal hits with
    paralog filtering."""
    def cfg(name):
        return kwargs["{}_{}".format(side, name)]

    annotations = read_species_annotation_table(cfg("annotation_file"))
    similarities = pd.read_csv(cfg("identities_file"))

    hits = most_similar_by_organism(similarities, annotations)
    if kwargs["use_best_reciprocal"]:
        hits = filter_best_reciprocal(
            cfg("alignment_file"),
            find_paralogs(
                cfg("focus_sequence"), annotations, similarities,
                kwargs["paralog_identity_threshold"],
            ),
            hits,
            device=device,
        )
    return hits


def best_hit(**kwargs):
    """Protocol: pair the per-species best (optionally best reciprocal)
    hits to the two target sequences."""
    check_required(
        kwargs,
        _COMMON_REQUIRED + [
            "first_identities_file", "second_identities_file",
            "use_best_reciprocal", "paralog_identity_threshold",
        ],
    )
    device = resolve_device(kwargs.get("device"))

    verify_resources(
        "Input alignment does not exist",
        kwargs["first_alignment_file"], kwargs["second_alignment_file"],
    )
    create_prefix_folders(kwargs["prefix"])

    # per-species pairing: intersection of species in both alignments
    species_intersection = _best_hits_per_species(
        kwargs, "first", device
    ).merge(
        _best_hits_per_species(kwargs, "second", device),
        how="inner",
        on="species",
        suffixes=("_1", "_2"),
    )

    return _write_and_filter_concatenated(species_intersection, kwargs,
                                          device)


PROTOCOLS = {
    # concatenate based on genomic distance ("operon-based")
    "genome_distance": genome_distance,
    # concatenate based on best hit per species
    "best_hit": best_hit,
}


def run(**kwargs):
    """Dispatch to the concatenation protocol named by
    kwargs["protocol"]."""
    check_required(kwargs, ["protocol"])

    if kwargs["protocol"] not in PROTOCOLS:
        raise InvalidParameterError(
            "Invalid protocol selection: "
            "{}. Valid protocols are: {}".format(
                kwargs["protocol"], ", ".join(PROTOCOLS.keys())
            )
        )

    return PROTOCOLS[kwargs["protocol"]](**kwargs)
