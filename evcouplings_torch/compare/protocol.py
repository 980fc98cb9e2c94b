"""
Compare-stage protocols (port of evcouplings_tpu/compare/protocol.py):
validate a monomer job's ECs against 3D structures. `standard` finds
structures through the SIFTS table, computes intra-chain and homomultimer
distance maps on the job's `device` (None: the CUDA device, "cpu": the
host), compares the ECs with them, writes the remapped and renumbered
structures and the Pymol script, and draws the contact maps last.

matplotlib is imported inside plot_cm (and print_pdb_structure_info)
only: a config whose plot settings select no figure (no
plot_probability_cutoffs, plot_lowest_count above plot_highest_count)
runs the whole stage without it; one that asks for figures on a machine
without matplotlib raises ImportError. Structures are found by a SIFTS
lookup of sequence_id, or with by_alignment: True by a sequence search
(jackhmmer, or hmmbuild + hmmsearch) against the SIFTS sequence
database on the host. The `complex` protocol needs the complex pipeline
(ROADMAP A19c) and raises NotImplementedError.
"""

from copy import deepcopy
from math import ceil

import pandas as pd

from evcouplings_torch._device import resolve_device
from evcouplings_torch.align.alignment import parse_header, read_fasta
from evcouplings_torch.compare.distances import (
    intra_dists,
    multimer_dists,
    remap_chains,
)
from evcouplings_torch.compare.ecs import coupling_scores_compared
from evcouplings_torch.compare.pdb import load_structures
from evcouplings_torch.compare.sifts import SIFTS
from evcouplings_torch.utils.config import (
    InvalidParameterError,
    check_required,
)
from evcouplings_torch.utils.system import (
    create_prefix_folders,
    insert_dir,
    verify_resources,
)
from evcouplings_torch.visualize import misc, pairs


SIFTS_TABLE_FORMAT_STR = (
    "{pdb_id}:{pdb_chain} ({coord_start}-{coord_end})"
)


def _as_list(value):
    """Config values that may be a scalar or a list (plot cutoffs)."""
    if not value:
        return []
    return value if isinstance(value, list) else [value]


def _covered_site_count(ec_table):
    """Number of distinct residue positions appearing in the table."""
    return len(set(ec_table.i.unique()) | set(ec_table.j.unique()))


def _count_or_fraction(value, num_sites):
    """EC-count plot parameters: ints are absolute counts, floats are
    fractions of the covered site count."""
    if isinstance(value, float):
        value = ceil(value * num_sites)
    return int(value)


def print_pdb_structure_info(sifts_result,
                             format_string=SIFTS_TABLE_FORMAT_STR,
                             header_text=None, hits_per_row=4,
                             separator=", ", location=(0.5, -0.08),
                             text_kwargs=None, ax=None):
    """Annotate a plot with the PDB chains used for comparison."""
    import matplotlib.pyplot as plt

    ax = ax or plt.gca()

    if text_kwargs is None:
        text_kwargs = {"ha": "center", "va": "top"}

    if len(sifts_result.hits) == 0:
        return

    try:
        pdb_texts = [
            format_string.format(**r)
            for _, r in sifts_result.hits.iterrows()
        ]
    except KeyError:
        # hit table may lack coord columns (e.g. by_pdb_id results)
        pdb_texts = [
            "{}:{}".format(r["pdb_id"], r["pdb_chain"])
            for _, r in sifts_result.hits.iterrows()
        ]

    pdb_lines = [
        separator.join(pdb_texts[i:i + hits_per_row])
        for i in range(0, len(pdb_texts), hits_per_row)
    ]
    if header_text is not None:
        pdb_lines = [header_text] + pdb_lines

    ax.text(
        *location, "\n".join(pdb_lines),
        transform=ax.transAxes, **text_kwargs,
    )


def _identify_structures(**kwargs):
    """Identify 3D structures (via SIFTS lookup or sequence search);
    returns (filtered SIFTSResult, unfiltered SIFTSResult)."""
    def _restrict_to_pdb_ids(result, id_list):
        trimmed = deepcopy(result)
        keep = trimmed.hits.pdb_id.isin(id_list)
        trimmed.hits = trimmed.hits.loc[keep]
        return trimmed

    check_required(
        kwargs,
        [
            "prefix", "pdb_ids", "compare_multimer",
            "max_num_hits", "max_num_structures",
            "pdb_mmtf_dir",
            "sifts_mapping_table", "sifts_sequence_db",
            "by_alignment", "pdb_alignment_method",
            "alignment_min_overlap",
            "sequence_id", "sequence_file", "region",
            "use_bitscores", "domain_threshold",
            "sequence_threshold",
        ],
    )

    s = SIFTS(
        kwargs["sifts_mapping_table"], kwargs["sifts_sequence_db"]
    )

    # multimer comparison needs every chain of a structure; monomer
    # comparison reduces to one chain per structure
    reduce_chains = not kwargs["compare_multimer"]

    if kwargs["by_alignment"]:
        method = kwargs["pdb_alignment_method"]
        if method not in ("jackhmmer", "hmmsearch"):
            raise InvalidParameterError(
                "Invalid pdb search method: "
                "{}. Valid selections are: jackhmmer, "
                "hmmsearch".format(method)
            )
        sifts_map = s.by_alignment(
            reduce_chains=reduce_chains,
            min_overlap=kwargs["alignment_min_overlap"],
            **kwargs,
        )
    else:
        sifts_map = s.by_uniprot_id(
            kwargs["sequence_id"], reduce_chains=reduce_chains
        )

    sifts_map_full = deepcopy(sifts_map)

    # user-selected PDB subset
    requested = kwargs["pdb_ids"]
    if requested is not None:
        if not isinstance(requested, list):
            requested = [requested]
        sifts_map = _restrict_to_pdb_ids(
            sifts_map, [x.lower() for x in requested]
        )

    if kwargs["max_num_hits"] is not None:
        sifts_map.hits = sifts_map.hits.iloc[:kwargs["max_num_hits"]]

    if kwargs["max_num_structures"] is not None:
        first_ids = sifts_map.hits.pdb_id.unique()
        sifts_map = _restrict_to_pdb_ids(
            sifts_map, first_ids[:kwargs["max_num_structures"]]
        )

    return sifts_map, sifts_map_full


def _cutoff_sets(ecs_longrange, prefix, cutoffs):
    """(output pdf path, non-empty EC subset) per probability cutoff —
    the first plot series both contact-map makers produce."""
    for cutoff in _as_list(cutoffs):
        subset = ecs_longrange.query("probability >= @cutoff")
        if len(subset) > 0:
            yield (
                prefix + "_significant_ECs_{}.pdf".format(cutoff),
                subset,
            )


def _ramp_counts(kwargs, num_sites):
    """EC counts of the count-ramp plot series (lowest..highest by
    increase, each resolvable as an absolute count or a fraction of
    the covered sites)."""
    lowest, highest, step = (
        _count_or_fraction(kwargs[key], num_sites)
        for key in ("plot_lowest_count", "plot_highest_count",
                    "plot_increase")
    )
    return range(lowest, highest + 1, step)


def _make_contact_maps(ec_table, d_intra, d_multimer, sifts_map,
                       **kwargs):
    """Contact-map PDFs at probability cutoffs and EC-count steps."""
    def plot_cm(ecs, output_file=None):
        import matplotlib.pyplot as plt

        with misc.plot_context("Arial"):
            fig = plt.figure(figsize=(10, 10))
            if kwargs["scale_sizes"]:
                rel = ecs.score.values / ecs.score.max()
                ecs = ecs.assign(size=rel.clip(min=0))

            pairs.plot_contact_map(
                ecs, d_intra, d_multimer, margin=5,
                distance_cutoff=kwargs["distance_cutoff"],
                boundaries=kwargs["boundaries"],
                show_secstruct=kwargs["draw_secondary_structure"],
            )

            if (kwargs.get("print_pdb_information", True)
                    and sifts_map is not None
                    and len(sifts_map.hits) > 0):
                print_pdb_structure_info(
                    sifts_map, ax=plt.gca(),
                    header_text="PDB structures:",
                )

            plt.suptitle("{} evolutionary couplings".format(len(ecs)),
                         fontsize=14)
            if output_file is not None:
                plt.savefig(output_file, bbox_inches="tight")
                plt.close(fig)

    check_required(
        kwargs,
        [
            "prefix", "min_sequence_distance",
            "plot_probability_cutoffs",
            "boundaries", "plot_lowest_count",
            "plot_highest_count", "plot_increase",
            "draw_secondary_structure",
        ],
    )
    prefix = kwargs["prefix"]

    min_dist = kwargs["min_sequence_distance"]
    ecs_longrange = ec_table.query("abs(i - j) >= @min_dist")

    cm_files = []
    for output_file, ec_set in _cutoff_sets(
            ecs_longrange, prefix, kwargs["plot_probability_cutoffs"]):
        plot_cm(ec_set, output_file=output_file)
        cm_files.append(output_file)

    num_sites = _covered_site_count(ec_table)
    for count in _ramp_counts(kwargs, num_sites):
        output_file = prefix + "_{}_ECs.pdf".format(count)
        plot_cm(ecs_longrange.iloc[:count], output_file=output_file)
        cm_files.append(output_file)

    return cm_files


def _individual_distance_map_config_result(individual_distance_map_table):
    """Flatten an individual-distance-map table into {filename: info}
    outcfg entries."""
    individual_maps_result = {}
    file_keys = ["residue_table", "distance_matrix"]

    for file_key in file_keys:
        current = {
            r[file_key]: {
                "file_type": file_key,
                **{
                    k: v for k, v in r.items() if k not in file_keys
                },
            }
            for _, r in individual_distance_map_table.iterrows()
        }
        individual_maps_result = {**individual_maps_result, **current}

    return individual_maps_result


def standard(**kwargs):
    """Protocol: compare monomer ECs to 3D structures; the distance
    maps are computed on kwargs["device"] (absent: the CUDA device)."""
    check_required(
        kwargs,
        [
            "prefix", "ec_file", "min_sequence_distance",
            "pdb_mmtf_dir", "atom_filter", "compare_multimer",
            "distance_cutoff", "target_sequence_file",
            "scale_sizes",
        ],
    )
    device = resolve_device(kwargs.get("device"))

    prefix = kwargs["prefix"]

    outcfg = {
        "ec_compared_all_file":
            prefix + "_CouplingScoresCompared_all.csv",
        "ec_compared_longrange_file":
            prefix + "_CouplingScoresCompared_longrange.csv",
        "pdb_structure_hits_file": prefix + "_structure_hits.csv",
        "pdb_structure_hits_unfiltered_file":
            prefix + "_structure_hits_unfiltered.csv",
        # distmap prefixes deliberately do not end in _file (each is a
        # .csv/.npy pair)
        "distmap_monomer": prefix + "_distance_map_monomer",
        "distmap_multimer": prefix + "_distance_map_multimer",
        "distmap_monomer_residues_file":
            prefix + "_distance_map_monomer_residues.csv",
    }

    verify_resources("EC file does not exist", kwargs["ec_file"])

    # auxiliary outputs live in their own subdirectory
    aux_prefix = insert_dir(prefix, "aux", rootname_subdir=False)
    for p in (prefix, aux_prefix):
        create_prefix_folders(p)

    # Step 1: identify structures
    sifts_map, sifts_map_full = _identify_structures(
        **dict(kwargs, prefix=aux_prefix)
    )

    for hits_map, key in (
        (sifts_map, "pdb_structure_hits_file"),
        (sifts_map_full, "pdb_structure_hits_unfiltered_file"),
    ):
        hits_map.hits.to_csv(outcfg[key], index=True)

    # Step 2: distance maps
    structures = load_structures(
        sifts_map.hits.pdb_id, kwargs["pdb_mmtf_dir"],
        raise_missing=False,
    )

    if len(sifts_map.hits) > 0:
        # structures were loaded tolerantly (raise_missing=False
        # above), so the distance computations must skip missing
        # entries too instead of KeyError-ing on them (latent crash
        # in the reference, which leaves the default True here)
        d_intra = intra_dists(
            sifts_map, structures, atom_filter=kwargs["atom_filter"],
            output_prefix=aux_prefix + "_distmap_intra",
            raise_missing=False, device=device,
        )
        # None when EVERY hit's structure failed to load (all skipped
        # by the tolerant path): degrade like the no-hits branch
        if d_intra is None:
            outcfg["distmap_monomer"] = None
            outcfg["distmap_monomer_residues_file"] = None
        else:
            residue_table_filename, dist_mat_filename = (
                d_intra.to_file(outcfg["distmap_monomer"])
            )
            d_intra.aggregated_residue_maps.to_csv(
                outcfg["distmap_monomer_residues_file"], index=False
            )
            outcfg["distmap_monomer_files"] = {
                residue_table_filename: {
                    "file_type": "residue_table"},
                dist_mat_filename: {"file_type": "distance_matrix"},
            }

            if d_intra.individual_distance_map_table is not None:
                outcfg["distmap_monomer_individual_files"] = (
                    _individual_distance_map_config_result(
                        d_intra.individual_distance_map_table
                    )
                )

            outcfg["monomer_contacts_file"] = (
                prefix + "_contacts_monomer.csv"
            )
            d_intra.contacts(kwargs["distance_cutoff"]).to_csv(
                outcfg["monomer_contacts_file"], index=False
            )

        if kwargs["compare_multimer"]:
            d_multimer = multimer_dists(
                sifts_map, structures,
                atom_filter=kwargs["atom_filter"],
                output_prefix=aux_prefix + "_distmap_multimer",
                raise_missing=False, device=device,
            )
        else:
            d_multimer = None

        if d_multimer is not None:
            residue_table_filename, dist_mat_filename = (
                d_multimer.to_file(outcfg["distmap_multimer"])
            )
            outcfg["distmap_multimer_files"] = {
                residue_table_filename: {"file_type": "residue_table"},
                dist_mat_filename: {"file_type": "distance_matrix"},
            }
            if d_multimer.individual_distance_map_table is not None:
                outcfg["distmap_multimer_individual_files"] = (
                    _individual_distance_map_config_result(
                        d_multimer.individual_distance_map_table
                    )
                )

            outcfg["multimer_contacts_file"] = (
                prefix + "_contacts_multimer.csv"
            )
            d_multimer.contacts(kwargs["distance_cutoff"]).to_csv(
                outcfg["multimer_contacts_file"], index=False
            )
        else:
            outcfg["distmap_multimer"] = None

        # remapped/renumbered structures for folding comparison etc.
        verify_resources(
            "Target sequence file does not exist",
            kwargs["target_sequence_file"],
        )
        with open(kwargs["target_sequence_file"]) as f:
            header, seq = next(read_fasta(f))

        seq_id, seq_start, seq_end = parse_header(header)
        seqmap = dict(zip(range(seq_start, seq_end + 1), seq))

        for name, sequence_map, atom_filter in [
            ("remapped", seqmap, ("N", "CA", "C", "O")),
            ("renumbered", None, None),
        ]:
            outcfg[name + "_pdb_files"] = {
                filename: mapping_index
                for mapping_index, filename in remap_chains(
                    sifts_map,
                    "{}_{}".format(aux_prefix, name),
                    sequence=sequence_map,
                    structures=structures,
                    atom_filter=atom_filter,
                    raise_missing=False,
                ).items()
            }
    else:
        d_intra = d_multimer = None
        for absent in ("distmap_monomer", "distmap_multimer",
                       "remapped_pdb_files", "renumbered_pdb_files",
                       "distmap_monomer_residues_file"):
            outcfg[absent] = None

    # Step 3: compare ECs to distances
    ec_table = pd.read_csv(kwargs["ec_file"])

    num_sites = _covered_site_count(ec_table)

    comparisons = (
        ("ec_compared_longrange_file", kwargs["min_sequence_distance"]),
        ("ec_compared_all_file", 0),
    )
    for out_file, min_seq_dist in comparisons:
        if d_intra is None:
            outcfg[out_file] = None
            continue
        coupling_scores_compared(
            ec_table, d_intra, d_multimer, score="score",
            min_sequence_dist=min_seq_dist,
            dist_cutoff=kwargs["distance_cutoff"],
            output_file=outcfg[out_file],
        )

    if outcfg["ec_compared_longrange_file"] is not None:
        ecs_longrange = pd.read_csv(
            outcfg["ec_compared_longrange_file"]
        )
        outcfg["ec_lines_compared_pml_file"] = (
            prefix + "_draw_ec_lines_compared.pml"
        )
        pairs.ec_lines_pymol_script(
            ecs_longrange.iloc[:num_sites, :],
            outcfg["ec_lines_compared_pml_file"],
            distance_cutoff=kwargs["distance_cutoff"],
            score_column="score",
        )

    # Step 4: contact maps (EC-only plot if no structures)
    outcfg["contact_map_files"] = _make_contact_maps(
        ec_table, d_intra, d_multimer, sifts_map, **kwargs
    )

    return outcfg


def complex(**kwargs):
    """Protocol: compare complex ECs (intra + inter) to 3D structures.
    Not ported yet (ROADMAP A19c)."""
    raise NotImplementedError(
        "the compare stage's complex protocol is not ported yet "
        "(ROADMAP A19c)")


PROTOCOLS = {
    # standard monomer comparison
    "standard": standard,
    # comparison for protein complexes
    "complex": complex,
}


def run(**kwargs):
    """Dispatch to the compare protocol named by kwargs["protocol"]."""
    check_required(kwargs, ["protocol"])

    if kwargs["protocol"] not in PROTOCOLS:
        raise InvalidParameterError(
            "Invalid protocol selection: "
            "{}. Valid protocols are: {}".format(
                kwargs["protocol"], ", ".join(PROTOCOLS.keys())
            )
        )

    return PROTOCOLS[kwargs["protocol"]](**kwargs)
