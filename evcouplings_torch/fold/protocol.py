"""
Fold-stage protocols: EC-restrained 3D structure prediction (EVfold)
and complex docking restraint generation; port of
evcouplings_tpu/fold/protocol.py (host code, as there): secondary_structure,
compare_models_maxcluster, maxcluster_clustering_table, standard,
complex_dock, PROTOCOLS/run, with the JAX package's config keys, output
file names and outcfg fields. Both protocols draw their EC-subset
schedule from one planner (`_ec_subset_schedule`).

Folding sub-runs execute on a process pool because cns_dgsa_fold chdirs
and os.chdir is process-global. Unlike the JAX package's pool, the
port's never forks: its workers are spawned fresh. By the time the
fold stage runs, a job has usually made a CUDA context in this process
(the couplings stage), which a forked child must not touch, and forking
a process that runs threads can deadlock the child.
"""

import multiprocessing
import shutil
from concurrent.futures import ProcessPoolExecutor
from functools import partial
from math import ceil
from os import path

import pandas as pd

from evcouplings_torch.align.alignment import parse_header, read_fasta
from evcouplings_torch.compare.pdb import ClassicPDB
from evcouplings_torch.couplings.mapping import Segment
from evcouplings_torch.fold.cns import cns_dgsa_fold
from evcouplings_torch.fold.filter import secstruct_clashes
from evcouplings_torch.fold.haddock import haddock_dist_restraint
from evcouplings_torch.fold.ranking import dihedral_ranking
from evcouplings_torch.fold.restraints import docking_restraints
from evcouplings_torch.fold.tools import (
    read_psipred_prediction,
    run_maxcluster_cluster,
    run_maxcluster_compare,
    run_psipred,
)
from evcouplings_torch.utils.config import (
    InvalidParameterError,
    check_required,
)
from evcouplings_torch.utils.system import (
    create_prefix_folders,
    insert_dir,
    temp,
    valid_file,
    verify_resources,
)
from evcouplings_torch.visualize.pymol import pymol_secondary_structure

# all maxcluster clustering modes; one cluster/cluster_size column
# pair per mode in the clustering table
_CLUSTER_MODES = ("single", "average", "maximum", "pairs_min",
                  "pairs_abs")


def _target_start_index(segments, seq_file):
    """Residue number of the first target position — taken from the
    leading segment when segment info exists, otherwise from the
    id/start-end range in the FASTA header."""
    if segments is not None:
        return Segment.from_list(segments[0]).region_start

    with open(seq_file) as handle:
        header, _ = next(read_fasta(handle))

    start = None
    if header is not None:
        _, start, _ = parse_header(header)

    if start is None:
        raise InvalidParameterError(
            "FASTA header must carry an explicit residue range "
            "(id/start-end) so predictions can be renumbered; "
            "got: {!r}".format(header)
        )

    return start


def secondary_structure(**kwargs):
    """Load (sec_struct_file) or predict (psipred) secondary structure
    for the target sequence; returns residue table (i, A_i,
    sec_struct_3state)."""
    check_required(
        kwargs,
        [
            "prefix",
            "target_sequence_file",
            "segments",
            "sec_struct_method",
            "sec_struct_file",
            "psipred",
        ],
    )

    prefix = kwargs["prefix"]
    create_prefix_folders(prefix)

    supplied = kwargs["sec_struct_file"]
    if supplied is not None:
        verify_resources(
            "secondary structure file missing or empty", supplied
        )
        return pd.read_csv(supplied)

    method = kwargs["sec_struct_method"]
    if method != "psipred":
        raise InvalidParameterError(
            "unknown secondary structure method {!r} "
            "(available: psipred)".format(method)
        )

    seq_file = kwargs["target_sequence_file"]
    verify_resources("target sequence file missing or empty", seq_file)
    start = _target_start_index(kwargs["segments"], seq_file)

    psipred_dir = path.join(path.dirname(prefix), "psipred")
    _ss2, horiz = run_psipred(
        seq_file, psipred_dir, binary=kwargs["psipred"]
    )
    return read_psipred_prediction(horiz, first_index=start)


def _load_single_chain(filename):
    """The one chain of a single-model, single-chain PDB file (the
    only shape maxcluster accepts), plus its residue ids as strings."""
    structure = ClassicPDB.from_file(filename)
    models = list(structure.model_to_chains)

    if not models:
        raise InvalidParameterError(
            "{}: file holds no structure model (empty after "
            "mapping?)".format(filename)
        )
    if len(models) > 1:
        raise InvalidParameterError(
            "{}: maxcluster needs a single-model file but this one "
            "has {} models".format(filename, len(models))
        )

    chain_names = structure.model_to_chains[models[0]]
    if len(chain_names) != 1:
        raise InvalidParameterError(
            "{}: maxcluster needs a single-chain file; chains "
            "present: {}".format(filename, ",".join(chain_names))
        )

    chain = structure.get_chain(chain_names[0], models[0])
    return chain, chain.residues.id.astype(str).values


def _dedup_atom_locations(chain):
    """Write the chain to a temp PDB with alternate atom locations
    collapsed to the highest-occupancy one (maxcluster rejects
    duplicate atoms); returns the temp filename."""
    coords = chain.coords.sort_values(
        "occupancy", ascending=False, kind="stable"
    )
    coords = coords.drop_duplicates(["residue_index", "atom_name"])
    chain.coords = coords.sort_index()

    out = temp()
    with open(out, "w") as handle:
        chain.to_file(handle)
    return out


def compare_models_maxcluster(experiments, predictions,
                              norm_by_intersection=True,
                              distance_cutoff=None,
                              binary="maxcluster"):
    """Compare predicted models to experimental structures with
    maxcluster (TM normalized over the position intersection by
    default); returns (full table, {experiment file: table})."""
    if not predictions:
        raise InvalidParameterError(
            "at least one predicted structure is required"
        )

    # all predictions are assumed to share positions, so the first
    # one defines the predicted position set
    _, pred_positions = _load_single_chain(predictions[0])

    per_experiment = {}
    blocks = []
    for exp_file in experiments:
        chain, exp_positions = _load_single_chain(exp_file)
        cleaned = _dedup_atom_locations(chain)

        shared = set(exp_positions) & set(pred_positions)
        norm_len = (
            len(shared) if norm_by_intersection else len(exp_positions)
        )

        table = run_maxcluster_compare(
            predictions, cleaned,
            normalization_length=norm_len,
            distance_cutoff=distance_cutoff, binary=binary,
        )
        table = table.assign(
            filename_experimental=exp_file,
            L_experiment=len(exp_positions),
            L_prediction=len(pred_positions),
            L_joint=len(shared),
            L_normalization=norm_len,
        ).sort_values("tm", ascending=False)

        per_experiment[exp_file] = table
        # the combined table keeps one block PER LIST ENTRY (the dict
        # would collapse duplicate experiment paths)
        blocks.append(table)

    combined = pd.concat(blocks) if blocks else pd.DataFrame()

    return combined, per_experiment


def maxcluster_clustering_table(structures, binary):
    """Clustering results for all maxcluster clustering methods, one
    cluster/cluster_size column pair per method."""
    tables = []
    for mode in _CLUSTER_MODES:
        result = run_maxcluster_cluster(
            structures, method=mode, binary=binary
        )
        tables.append(result.rename(columns={
            "cluster": "cluster_" + mode,
            "cluster_size": "cluster_size_" + mode,
        }))

    merged = tables[0]
    for extra in tables[1:]:
        merged = merged.merge(extra, on="filename", how="outer")
    return merged


def _ec_subset_schedule(ec_table, prob_cutoffs, lowest, highest,
                        increase, n_sites, suffix_pattern):
    """Plan the EC subsets both fold protocols iterate over: one
    subset per probability cutoff (skipped when empty), then a ramp
    of top-k prefixes from `lowest` to `highest` by `increase`
    (fractions are interpreted relative to n_sites). Returns
    [(subset table, filename suffix)]."""
    plan = []

    if prob_cutoffs is not None and "probability" in ec_table.columns:
        if not isinstance(prob_cutoffs, list):
            prob_cutoffs = [prob_cutoffs]
        for p in prob_cutoffs:
            subset = ec_table[ec_table.probability >= p]
            if len(subset):
                tag = "significant_ECs_{}".format(p)
                plan.append((subset, suffix_pattern.format(tag)))

    if None not in (lowest, highest, increase):
        def as_count(value):
            if isinstance(value, float):
                value = ceil(value * n_sites)
            return int(value)

        ramp = range(
            as_count(lowest), as_count(highest) + 1, as_count(increase)
        )
        plan.extend(
            (ec_table.iloc[:k], suffix_pattern.format(k))
            for k in ramp
        )

    return plan


def _write_experiment_comparisons(ranking, models, remapped_files,
                                  stage_dir, prefix, binary):
    """Run the maxcluster comparison of predicted models against each
    remapped experimental structure and persist the combined + the
    per-experiment tables; returns the outcfg fields."""
    combined, singles = compare_models_maxcluster(
        list(remapped_files.keys()), models,
        norm_by_intersection=True, distance_cutoff=None,
        binary=binary,
    )

    out = {"folding_comparison_file": prefix + "_comparison.csv"}
    ranking.merge(combined, on="filename", how="left") \
        .sort_values("tm", ascending=False) \
        .to_csv(out["folding_comparison_file"], index=False)

    per_file = {}
    for exp_file, table in singles.items():
        stem = path.splitext(path.basename(exp_file))[0]
        csv_path = path.join(stage_dir, stem + ".csv")
        ranking.merge(table, on="filename", how="left") \
            .sort_values("tm", ascending=False) \
            .to_csv(csv_path, index=False)
        # keyed by csv path, valued by the original remap key
        per_file[csv_path] = remapped_files[exp_file]

    out["folding_individual_comparison_files"] = per_file
    return out


def standard(**kwargs):
    """Protocol: EC-restrained folding (CNS dg/sa), model ranking,
    clustering, and optional comparison to remapped structures."""
    check_required(
        kwargs,
        [
            "prefix",
            "engine",
            "ec_file",
            "target_sequence_file",
            "segments",
            "folding_config_file",
            "cut_to_alignment_region",
            "cns", "maxcluster",
            "sec_struct_method",
            "reuse_sec_struct",
            "sec_struct_file",
            "filter_sec_struct_clashes",
            "min_sequence_distance",
            "fold_probability_cutoffs",
            "fold_lowest_count",
            "fold_highest_count",
            "fold_increase",
            "num_models",
            "psipred",
            "cpu",
            "remapped_pdb_files",
            "cleanup",
        ],
    )

    prefix = kwargs["prefix"]
    create_prefix_folders(prefix)

    out = {
        "folding_ec_file":
            prefix + "_CouplingScores_with_clashes.csv",
        "sec_struct_file": prefix + "_secondary_structure.csv",
        "secondary_structure_pml_file": prefix + "_ss_draw.pml",
    }

    # secondary structure: reuse a previous run's table if allowed,
    # else load/predict it fresh
    ss_table = None
    if kwargs["reuse_sec_struct"] and valid_file(
            out["sec_struct_file"]):
        ss_table = pd.read_csv(out["sec_struct_file"])
    if ss_table is None:
        ss_table = secondary_structure(**kwargs)

    pymol_secondary_structure(
        ss_table, out["secondary_structure_pml_file"]
    )

    # long-range ECs, annotated (and optionally filtered) for
    # secondary-structure clashes
    verify_resources("EC file does not exist", kwargs["ec_file"])
    all_ecs = pd.read_csv(kwargs["ec_file"])
    separation = (all_ecs.i - all_ecs.j).abs()
    longrange = all_ecs[
        separation > kwargs["min_sequence_distance"]
    ]

    longrange = secstruct_clashes(longrange, ss_table)
    longrange.to_csv(out["folding_ec_file"], index=False)

    fold_ecs = longrange
    if kwargs["filter_sec_struct_clashes"]:
        fold_ecs = longrange[~longrange.ss_clash]

    # which residues enter the model: everything, or only the span
    # covered by the alignment/ECs
    if kwargs["cut_to_alignment_region"]:
        segments = kwargs["segments"]
        if segments is not None:
            seg = Segment.from_list(segments[0])
            # config entries may omit the explicit position list
            covered = seg.positions if seg.positions is not None else (
                range(seg.region_start, seg.region_end + 1)
            )
        else:
            # fall back to EC positions (may under-cover when the EC
            # list is truncated, hence only the fallback)
            covered = set(longrange.i) | set(longrange.j)
        if not covered:
            raise InvalidParameterError(
                "cut_to_alignment_region=True, but no segments are "
                "configured and no EC pair passes the long-range "
                "min_sequence_distance filter — cannot determine the "
                "modeled region"
            )
        ss_table["in_model"] = ss_table.i.between(
            min(covered), max(covered)
        )
    else:
        ss_table["in_model"] = True

    ss_table.to_csv(out["sec_struct_file"], index=False)
    model_residues = ss_table[ss_table.in_model]

    # schedule the folding sub-runs; the site count that fractional
    # ramp bounds refer to comes from the unfiltered long-range table
    n_sites = len(set(longrange.i) | set(longrange.j))
    plan = _ec_subset_schedule(
        fold_ecs,
        kwargs["fold_probability_cutoffs"],
        kwargs["fold_lowest_count"],
        kwargs["fold_highest_count"],
        kwargs["fold_increase"],
        n_sites,
        "_{}",
    )

    engine = kwargs["engine"]
    if engine != "cns_dgsa":
        raise InvalidParameterError(
            "unknown folding engine {!r} "
            "(available: cns_dgsa)".format(engine)
        )

    fold_one = partial(
        cns_dgsa_fold,
        model_residues,
        config_file=kwargs["folding_config_file"],
        num_structures=kwargs["num_models"],
        log_level=None,
        binary=kwargs["cns"],
    )

    # sub-runs write into an aux subdirectory; finished models are
    # copied up to the stage directory afterwards
    aux_prefix = insert_dir(prefix, "aux", rootname_subdir=False)

    # parallelize over PROCESSES: cns_dgsa_fold chdirs, and os.chdir is
    # process-global, so threads would race; spawned, not forked (see
    # the module docstring)
    workers = 1 if kwargs["cpu"] is None else int(kwargs["cpu"])
    if workers < 1:
        # `or 1` would silently serialize a misconfigured cpu: 0
        raise InvalidParameterError(
            "cpu must be >= 1 for the folding pool "
            "(got {})".format(kwargs["cpu"])
        )
    with ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [
            pool.submit(fold_one, subset, aux_prefix + suffix)
            for subset, suffix in plan
        ]
        produced = {}
        for fut in futures:
            produced.update(fut.result())

    stage_dir = path.dirname(prefix)
    models = []
    for aux_file in produced.values():
        shutil.copy(aux_file, stage_dir)
        models.append(aux_file.replace(aux_prefix, prefix))
    out["folded_structure_files"] = models

    if kwargs["cleanup"]:
        shutil.rmtree(path.dirname(aux_prefix))

    # rank models by dihedral statistics; clustering only makes
    # sense with more than one model
    ranking = dihedral_ranking(models, ss_table)
    if len(models) > 1:
        clusters = maxcluster_clustering_table(
            models, binary=kwargs["maxcluster"]
        )
        ranking = ranking.merge(clusters, on="filename", how="left")

    ranking = ranking.sort_values("ranking_score", ascending=False)
    out["folding_ranking_file"] = prefix + "_ranking.csv"
    ranking.to_csv(out["folding_ranking_file"], index=False)

    remapped = kwargs["remapped_pdb_files"]
    if remapped:
        out.update(_write_experiment_comparisons(
            ranking, models, remapped, stage_dir, prefix,
            kwargs["maxcluster"],
        ))

    return out


def complex_dock(**kwargs):
    """Protocol: write HADDOCK docking restraint files for inter-
    segment ECs (by probability cutoffs and EC count ramp)."""
    check_required(
        kwargs,
        [
            "prefix",
            "ec_file",
            "segments",
            "dock_probability_cutoffs",
            "dock_lowest_count",
            "dock_highest_count",
            "dock_increase",
        ],
    )

    prefix = kwargs["prefix"]
    create_prefix_folders(prefix)

    verify_resources(
        "EC file does not exist and/or is empty", kwargs["ec_file"]
    )
    table = pd.read_csv(kwargs["ec_file"])
    inter = table[table.segment_i != table.segment_j]

    plan = _ec_subset_schedule(
        inter,
        kwargs["dock_probability_cutoffs"],
        kwargs["dock_lowest_count"],
        kwargs["dock_highest_count"],
        kwargs["dock_increase"],
        # set() keeps a NaN entry like the reference's
        # len(set(unique())) does; nunique() would drop it and shift
        # the fractional ramp bounds
        len(set(inter.i)) + len(set(inter.j)),
        "_{}_restraints.tbl",
    )

    written = []
    for subset, suffix in plan:
        target = prefix + suffix
        docking_restraints(subset, target, haddock_dist_restraint)
        written.append(target)

    return {"docking_restraint_files": written}


PROTOCOLS = {
    # standard EVfold protocol
    "standard": standard,
    # create docking restraints for complexes
    "complex_dock": complex_dock,
}


def run(**kwargs):
    """Dispatch to the fold protocol named by kwargs["protocol"]."""
    check_required(kwargs, ["protocol"])

    selected = kwargs["protocol"]
    try:
        runner = PROTOCOLS[selected]
    except KeyError:
        raise InvalidParameterError(
            "Invalid protocol selection: {}. Valid protocols are: "
            "{}".format(selected, ", ".join(PROTOCOLS))
        ) from None

    return runner(**kwargs)
