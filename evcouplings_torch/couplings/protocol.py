"""
Couplings-stage protocols (port of evcouplings_tpu/couplings/protocol.py):
infer evolutionary couplings from an alignment and post-process them into
scored EC tables.

The external plmc invocation of the upstream pipeline is the in-process
fitter (couplings/fitter.run_plm, on the job's `device`); the artifact
contract (raw EC file, .model, iteration table, outcfg keys) is the JAX
package's, including restart via reuse_ecs. The `standard` protocol is
ported with every fit route of couplings/fitter.run_plm (symmetric or
asymmetric parametrization, exact group-L1, mid-fit checkpoints),
`complex` (the same fit on a concatenated two-protein alignment, its
mixture model fit separately to the intra- and inter-protein ECs), and
`mean_field` (mean-field DCA, couplings/mean_field.py).

fit_devices ("all" or an int) and model_shards run the fit on a mesh of
the ranks of the torch.distributed process group (one process per rank,
started with parallel.distributed_initialize or torchrun; every rank runs
the stage with the same config): rows shard over fit_devices / model_shards
"data" ranks, and the asymmetric fit's sites over model_shards "model"
ranks (the mean-field stage splits its reweighting and its inversion's
solves over fit_devices ranks). Rank 0 runs the stage's host work and
writes its files; the other ranks take part in the fit, then receive rank
0's outcfg, so every rank returns the same one.
"""

import os
import string

import numpy as np
import pandas as pd

from evcouplings_torch import BailoutException
from evcouplings_torch._device import resolve_device
from evcouplings_torch.align.alignment import (
    ALPHABET_DNA,
    ALPHABET_PROTEIN,
    ALPHABET_PROTEIN_NOGAP,
    ALPHABET_PROTEIN_NOGAP_ORDERED,
    ALPHABET_PROTEIN_ORDERED,
    ALPHABET_RNA,
    Alignment,
    read_fasta,
)
from evcouplings_torch.couplings import fitter as ct
from evcouplings_torch.couplings import mapping, pairs
from evcouplings_torch.couplings.mean_field import MeanFieldDCA
from evcouplings_torch.couplings.model import CouplingsModel
from evcouplings_torch.parallel import (
    broadcast_object,
    make_mesh,
    make_mesh_2d,
    process_count,
    process_index,
)
from evcouplings_torch.utils.config import (
    InvalidParameterError,
    check_required,
    read_config_file,
    write_config_file,
)
from evcouplings_torch.utils.system import (
    create_prefix_folders,
    valid_file,
    verify_resources,
)
from evcouplings_torch.visualize.pairs import (
    ec_lines_pymol_script,
    enrichment_pymol_script,
)
from evcouplings_torch.visualize.parameters import evzoom_json

ALPHABET_MAP = {
    "aa": ALPHABET_PROTEIN,
    "dna": ALPHABET_DNA,
    "rna": ALPHABET_RNA,
}

SCORING_MODELS = (
    "skewnormal",
    "normal",
    "evcomplex",
)


def _resolve_fit_device_count(fit_devices):
    """Resolve the fit_devices config value ("all", an int, or None =
    all available) to a validated device count: the ranks of the
    initialized torch.distributed process group, 1 without one."""
    n_avail = process_count()
    if fit_devices in (None, "all"):
        return n_avail
    try:
        n_total = int(fit_devices)
    except (TypeError, ValueError):
        raise InvalidParameterError(
            "fit_devices must be 'all' or an integer "
            "(got {!r})".format(fit_devices)
        )
    if not 0 < n_total <= n_avail:
        raise InvalidParameterError(
            "fit_devices must be in [1, {}] (got {}): it counts the ranks "
            "of the process group, one process per rank, started with "
            "parallel.distributed_initialize or torchrun".format(
                n_avail, fit_devices)
        )
    return n_total


def _fit_mesh(fit_devices, model_shards, parametrization, device):
    """The fit's mesh from the fit_devices / model_shards settings, and the
    parametrization they imply (model_shards > 1 resolves "auto" to
    asymmetric). Every rank of the process group calls it (the mesh's
    process groups are made on all of them)."""
    if model_shards > 1:
        # site sharding only exists on the asymmetric path
        if parametrization == "auto":
            parametrization = "asymmetric"
        elif parametrization != "asymmetric":
            raise InvalidParameterError(
                "model_shards > 1 requires parametrization: asymmetric")
    n_total = _resolve_fit_device_count(fit_devices)
    if n_total % model_shards:
        raise InvalidParameterError(
            "fit_devices ({}) must be divisible by model_shards ({})".format(
                n_total, model_shards))
    if parametrization == "asymmetric":
        mesh = make_mesh_2d(n_total // model_shards, model_shards,
                            device=device)
    elif parametrization == "auto":
        # a ("data", "model"=1) mesh serves both outcomes of run_plm's
        # routing: the symmetric fit shards rows over "data", the
        # asymmetric one uses both axes
        mesh = make_mesh_2d(n_total, 1, device=device)
    else:
        mesh = make_mesh(n_total, device=device)
    return mesh, parametrization


def _run_on_ranks(body, take_part, kwargs):
    """Run a stage in a run of one or several processes.

    One process: body(**kwargs). Several: rank 0 runs body (the whole
    stage, its files included); every other rank runs take_part(**kwargs),
    its share of the stage's collectives (None: the stage uses no mesh,
    and the rank does nothing), then receives rank 0's outcfg, or raises
    when rank 0 failed."""
    if process_count() == 1:
        return body(**kwargs)
    if process_index() == 0:
        try:
            outcfg = body(**kwargs)
        except BaseException as exc:
            broadcast_object(("failed", repr(exc)))
            raise
        broadcast_object(("ok", outcfg))
        return outcfg
    if take_part is not None:
        take_part(**kwargs)
    status, outcfg = broadcast_object()
    if status != "ok":
        raise RuntimeError("rank 0 failed the stage: {}".format(outcfg))
    return outcfg


def _plm_takes_part(kwargs):
    """infer_plmc where the config asks for a mesh, else None."""
    if (kwargs.get("fit_devices") is None
            and int(kwargs.get("model_shards") or 1) == 1):
        return None
    return infer_plmc


def _ec_stage_outcfg(prefix, kwargs, model_file):
    """Base outcfg of an EC-inference stage: the artifact paths plus
    the inputs passed through for downstream stages — shared by the
    PLM and mean-field entry points."""
    return {
        "model_file": model_file,
        "raw_ec_file": prefix + "_ECs.txt",
        "ec_file": prefix + "_CouplingScores.csv",
        **{key: kwargs[key]
           for key in ("focus_mode", "focus_sequence", "segments")},
    }


def _segments_from_config(kwargs):
    """Segment objects from the config's list-of-lists form (None
    passes through)."""
    if kwargs["segments"] is None:
        return None
    return [mapping.Segment.from_list(s) for s in kwargs["segments"]]


def _validated_choice(value, choices, what):
    """value, after checking it is one of choices (InvalidParameterError
    naming the offending setting otherwise) — shared by the protocol
    dispatcher and the per-protocol enum settings."""
    if value not in choices:
        raise InvalidParameterError(
            "Invalid {}: {}. Valid options are: {}".format(
                what, value, ", ".join(choices)
            )
        )
    return value


def _resolve_alphabet(choice):
    """Alphabet string from a config value (None -> protein;
    "aa"/"dna"/"rna" shortcuts resolve through ALPHABET_MAP)."""
    if choice is None:
        return ALPHABET_PROTEIN
    return ALPHABET_MAP.get(choice, choice)


def _scaled_lambda_j(kwargs, alphabet):
    """Per-pair coupling l2 strength, optionally scaled by
    (q-1)(L-1) like plmc's CLI convention (reference
    protocol.py:157-179); L counts the target's match columns
    (uppercase or gap) in the first alignment record."""
    strength = kwargs["lambda_J"]
    if not kwargs["lambda_J_times_Lq"]:
        return strength

    q_eff = len(alphabet) - (1 if kwargs["ignore_gaps"] else 0)

    with open(kwargs["alignment_file"]) as handle:
        _, target = next(read_fasta(handle))
    gap = alphabet[0]
    n_match = sum(1 for c in target if c == c.upper() or c == gap)

    return strength * (q_eff - 1) * (n_match - 1)


def infer_plmc(**kwargs):
    """EC-inference core of the standard protocol: run (or reuse) the
    PLM fit on the job's `device` (None: the CUDA device) and load the
    raw EC table. With fit_devices / model_shards every rank of the
    process group calls it: the mesh's ranks run the fit, its first rank
    writes the files; a rank outside the mesh returns ecs None.

    Returns (outcfg, ecs, segments).
    """
    check_required(
        kwargs,
        [
            "prefix", "alignment_file",
            "focus_mode", "focus_sequence", "theta",
            "alphabet", "segments", "ignore_gaps", "iterations",
            "lambda_h", "lambda_J", "lambda_group",
            "lambda_J_times_Lq", "scale_clusters",
            "cpu", "reuse_ecs",
        ],
    )

    device = resolve_device(kwargs.get("device"))
    prefix = kwargs["prefix"]
    outcfg = _ec_stage_outcfg(prefix, kwargs, prefix + ".model")

    verify_resources(
        "Input alignment does not exist", kwargs["alignment_file"]
    )
    create_prefix_folders(prefix)

    segments = _segments_from_config(kwargs)

    alphabet = _resolve_alphabet(kwargs["alphabet"])
    lambda_J = _scaled_lambda_j(kwargs, alphabet)

    plm_outcfg_file = prefix + ".couplings_standard_plmc.outcfg"

    if kwargs["reuse_ecs"] and valid_file(plm_outcfg_file):
        plmc_result = read_config_file(plm_outcfg_file)

        required_files = [outcfg["raw_ec_file"]]
        if outcfg["model_file"] is not None:
            required_files += [outcfg["model_file"]]
        verify_resources(
            "Tried to reuse ECs, but empty or does not exist",
            *required_files,
        )
    else:
        # optional fitter knobs beyond the plmc config schema (absent /
        # None keeps plmc-parity behavior: LBFGS, float32 + "highest"
        # matmul precision, one optimizer step per call).
        # solver: "lbfgs" | "adam"; steps_per_call: optimizer steps per
        # chunk; precision:
        #   "parity"     — float32 with "highest" matmul precision (IEEE
        #                  float32 products, every LBFGS dot a sequential
        #                  FMA chain: K4 on the card)
        #   "balanced"   — float32 state, "high" matmuls (TF32 allowed)
        #   "production" — bfloat16 compute with float32 master
        #                  parameters (with the adam solver, the fused
        #                  update K2 on the card)
        # parametrization: "auto" (symmetric while the memory estimate
        # fits the device, else asymmetric), "symmetric", or
        # "asymmetric" (per-site regressions, ops/plm_sites.py)
        parametrization = kwargs.get("parametrization") or "auto"
        if parametrization not in ("auto", "symmetric", "asymmetric"):
            raise InvalidParameterError(
                "Invalid parametrization, valid options are: "
                "auto, symmetric, asymmetric"
            )
        # solver None lets run_plm pick the resolved parametrization's
        # default (lbfgs for symmetric, adam for asymmetric)
        solver = kwargs.get("solver") or None
        precision_mode = kwargs.get("precision") or "parity"
        if precision_mode not in ("parity", "balanced", "production"):
            raise InvalidParameterError(
                "Invalid precision, valid options are: "
                "parity, balanced, production"
            )
        # steps_per_call absent from the config: parity modes keep the
        # plmc-exact 1 step per chunk (convergence checked every step);
        # production mode defaults to 10, the JAX package's default
        steps_per_call = kwargs.get("steps_per_call")
        if steps_per_call is None:
            steps_per_call = 10 if precision_mode == "production" else 1
        fitter_kwargs = {
            "solver": solver,
            # group_mode (only meaningful with lambda_group > 0):
            # None/absent fits the exact nonsmooth group-L1 penalty
            # via the proximal "fista" solver; "smoothed" opts in to
            # the sqrt(||J||^2 + eps) approximation with lbfgs/adam
            "group_mode": kwargs.get("group_mode"),
            # relative-gradient convergence (libLBFGS rule); absent
            # keeps the plmc-default 1e-5
            "conv_tol": kwargs.get("conv_tol"),
            "parametrization": parametrization,
            "steps_per_call": int(steps_per_call),
            # pad_sites / pad_rows: round L / N up to these
            # multiples with inert padding (run_plm pad_sites_to /
            # pad_rows_to); padding changes float rounding — leave
            # unset for parity
            "pad_sites_to": kwargs.get("pad_sites"),
            "pad_rows_to": kwargs.get("pad_rows"),
        }

        # device-mesh knobs: fit_devices ("all" or an int) shards the
        # rows over ranks of the process group on a "data" axis;
        # model_shards also shards the asymmetric fit's sites on a "model"
        # axis. Absent: one device, no mesh.
        fit_devices = kwargs.get("fit_devices")
        model_shards = int(kwargs.get("model_shards") or 1)
        mesh = None
        if fit_devices is not None or model_shards > 1:
            mesh, parametrization = _fit_mesh(
                fit_devices, model_shards, parametrization, device)
            fitter_kwargs.update(mesh=mesh, parametrization=parametrization)
            if mesh.coords is None:
                # this rank is not in the fit's mesh
                return outcfg, None, segments

        if precision_mode == "production":
            fitter_kwargs.update(
                compute_dtype="bfloat16", matmul_precision="default",
            )
        elif precision_mode == "balanced":
            fitter_kwargs.update(
                compute_dtype="float32", matmul_precision="high",
            )

        # mid-fit crash recovery: checkpoint_every > 0 snapshots the
        # parameters and the full solver state every k iterations; a
        # killed job resumes the fit bit for bit from the snapshot on
        # re-run. A completed fit removes any snapshot under this prefix.
        checkpoint_every = int(kwargs.get("checkpoint_every") or 0)
        fit_checkpoint = prefix + ".fit_checkpoint.npz"
        if checkpoint_every > 0:
            fitter_kwargs["checkpoint_file"] = fit_checkpoint
            fitter_kwargs["checkpoint_every"] = checkpoint_every

        # fit hyperparameters passed straight from the config
        # (run_plm kwarg: config key)
        passthrough = {
            name: kwargs[key] for name, key in (
                ("theta", "theta"),
                ("scale", "scale_clusters"),
                ("ignore_gaps", "ignore_gaps"),
                ("iterations", "iterations"),
                ("lambda_h", "lambda_h"),
                ("lambda_g", "lambda_group"),
                ("cpu", "cpu"),
            )
        }
        focus = (
            kwargs["focus_sequence"] if kwargs["focus_mode"] else None
        )
        plmc_result = ct.run_plm(
            kwargs["alignment_file"],
            outcfg["raw_ec_file"],
            outcfg["model_file"],
            focus_seq=focus,
            alphabet=alphabet,
            lambda_J=lambda_J,
            device=device,
            **passthrough,
            **fitter_kwargs,
        )

        iter_table_file = prefix + "_iteration_table.csv"
        if mesh is None or mesh.is_writer:
            # a completed fit obsoletes any crash snapshot under this
            # prefix — including one left by an earlier run that had
            # checkpointing on while the current run does not (a stale
            # snapshot must never survive to poison a future fit)
            if valid_file(fit_checkpoint):
                os.remove(fit_checkpoint)
            plmc_result.iteration_table.to_csv(iter_table_file)

        plmc_result = dict(plmc_result._asdict())
        plmc_result["iteration_table"] = iter_table_file
        if mesh is None or mesh.is_writer:
            write_config_file(plm_outcfg_file, plmc_result)

    # fit statistics -> stage outputs (outcfg key: result field)
    for out_key, res_key in (
        ("num_sites", "num_valid_sites"),
        ("num_valid_sequences", "num_valid_seqs"),
        ("effective_sequences", "effective_samples"),
        ("region_start", "region_start"),
    ):
        outcfg[out_key] = plmc_result[res_key]

    ecs = pairs.read_raw_ec_file(outcfg["raw_ec_file"])

    if segments is not None:
        seg_mapper = mapping.SegmentIndexMapper(
            kwargs["focus_mode"], outcfg["region_start"], *segments
        )
        ecs = mapping.segment_map_ecs(ecs, seg_mapper)

    return outcfg, ecs, segments


def rescore_cn_score_ecs(ecs, segments, outcfg, kwargs, score="cn"):
    """Probabilistic rescoring of CN-score-based ECs.

    logistic_regression gives full rescoring (new score + probability +
    expected-true-EC counts); the mixture models only attach a
    probability on top of the CN score. Returns (ecs, outcfg_update).
    """
    check_required(
        kwargs,
        ["scoring_model", "min_sequence_distance", "theta",
         "frequencies_file"],
    )

    scoring_model = kwargs.get("scoring_model", "skewnormal")
    outcfg_update = {}

    if scoring_model == "logistic_regression":
        scorer = pairs.LogisticRegressionScorer()
        freqs = pd.read_csv(kwargs["frequencies_file"])

        num_sites = outcfg["num_sites"]
        # None is a legal config value (no distance constraint,
        # handled the same way by _postprocess_inference); the
        # reference crashes on it here with a raw TypeError
        min_seq_dist = kwargs["min_sequence_distance"] or 0

        ecs = scorer.score(
            ecs, freqs, kwargs["theta"],
            outcfg["effective_sequences"], num_sites, score=score,
        )

        # expected-true-positive counts (single segment only)
        if segments is None or len(segments) == 1:
            is_longrange = (
                (ecs.i - ecs.j).abs() >= min_seq_dist
            ).astype(int)
            ecs_lr = ecs.assign(longrange_count=is_longrange.cumsum())

            expected_all = ecs_lr.query(
                "longrange_count <= @num_sites"
            ).probability.sum()
            expected_lr = ecs_lr.query(
                "longrange_count <= @num_sites and "
                "abs(i - j) >= @min_seq_dist"
            ).probability.sum()

            outcfg_update = {
                "expected_true_ecs_all": float(expected_all),
                "expected_true_ecs_longrange": float(expected_lr),
            }
    else:
        ecs = pairs.add_mixture_probability(ecs, model=scoring_model)
        ecs = ecs.assign(score=ecs[score])

    return ecs.sort_values(by="score", ascending=False), outcfg_update


def standard(**kwargs):
    """Protocol: infer monomer ECs with the port's PLM fitter (on a mesh
    of the process group's ranks with fit_devices / model_shards)."""
    check_required(
        kwargs,
        ["prefix", "min_sequence_distance", "theta", "frequencies_file"],
    )
    return _run_on_ranks(_standard, _plm_takes_part(kwargs), kwargs)


def _standard(**kwargs):
    prefix = kwargs["prefix"]

    outcfg, ecs, segments = infer_plmc(**kwargs)
    model = CouplingsModel(outcfg["model_file"])

    ecs, rescorer_outcfg_update = rescore_cn_score_ecs(
        ecs, segments, outcfg, kwargs, score="cn"
    )
    outcfg.update(rescorer_outcfg_update)

    # enrichment + line plots only make sense for a single segment
    single = segments is None or len(segments) == 1
    outcfg.update(_postprocess_inference(
        ecs, kwargs, model, outcfg, prefix, score="score",
        generate_enrichment=single, generate_line_plot=single,
    ))

    write_config_file(prefix + ".couplings_standard.outcfg", outcfg)
    return outcfg


def _postprocess_inference(ecs, kwargs, model, outcfg, prefix,
                           generate_line_plot=False,
                           generate_enrichment=False,
                           ec_filter="abs(i - j) >= {}",
                           chain=None, score="cn"):
    """Shared post-processing: EC csv, long-range subset, pymol
    scripts, enrichment, EVzoom JSON. Returns extra outcfg entries."""
    ext_outcfg = {}

    ecs.to_csv(outcfg["ec_file"], index=False)

    # a non-positive maximum score crashes everything downstream
    if ecs[score].max() <= 0:
        raise BailoutException("couplings: No couplings identified")

    if kwargs["min_sequence_distance"] is not None:
        ext_outcfg["ec_longrange_file"] = (
            prefix + "_CouplingScores_longrange.csv"
        )
        ecs_longrange = ecs.query(
            ec_filter.format(kwargs["min_sequence_distance"])
        )
        ecs_longrange.to_csv(ext_outcfg["ec_longrange_file"], index=False)

        if generate_line_plot:
            ext_outcfg["ec_lines_pml_file"] = prefix + "_draw_ec_lines.pml"
            L = outcfg["num_sites"]
            ec_lines_pymol_script(
                ecs_longrange.iloc[:L, :],
                ext_outcfg["ec_lines_pml_file"],
                chain=chain,
                score_column=score,
            )

    if generate_enrichment:
        ext_outcfg["enrichment_file"] = prefix + "_enrichment.csv"

        min_seqdist = kwargs["min_sequence_distance"]
        ecs_enriched = pairs.enrichment(
            ecs, score=score,
            min_seqdist=0 if min_seqdist is None else min_seqdist,
        )
        ecs_enriched.to_csv(ext_outcfg["enrichment_file"], index=False)

        pml_files = []
        for sphere_view, pml_suffix in (
            (True, "_enrichment_spheres.pml"),
            (False, "_enrichment_sausage.pml"),
        ):
            pml_files.append(prefix + pml_suffix)
            enrichment_pymol_script(
                ecs_enriched, pml_files[-1], sphere_view=sphere_view
            )
        ext_outcfg["enrichment_pml_files"] = pml_files

    if outcfg.get("model_file", None) is not None:
        ext_outcfg["evzoom_file"] = prefix + "_evzoom.json"

        # EVzoom amino-acid reordering (proteins only)
        reorder = {
            ALPHABET_PROTEIN_NOGAP: ALPHABET_PROTEIN_NOGAP_ORDERED,
            ALPHABET_PROTEIN: ALPHABET_PROTEIN_ORDERED,
        }.get("".join(model.alphabet))

        with open(ext_outcfg["evzoom_file"], "w") as f:
            f.write(evzoom_json(model, reorder=reorder) + "\n")

    return ext_outcfg


def complex_probability(ecs, scoring_model, use_all_ecs=False,
                        score="cn"):
    """Attach confidence to complex ECs; by default the mixture model is
    fit separately to intra- and inter-segment ECs."""
    if use_all_ecs:
        return pairs.add_mixture_probability(ecs, model=scoring_model)

    rescored = [
        pairs.add_mixture_probability(
            part, model=scoring_model, score=score
        )
        for part in (ecs.query("segment_i == segment_j"),
                     ecs.query("segment_i != segment_j"))
    ]
    return pd.concat(rescored).sort_values(score, ascending=False)


def complex(**kwargs):
    """Protocol: infer ECs for protein complexes from the concatenated
    alignment (the fit on the job's `device`, segment-aware scoring, the
    inter-EC convenience output). The concatenation is a focus alignment
    (its target header is id1_id2/1-L), so focus_mode defaults to True
    where the config leaves it out (the JAX package requires the key)."""
    check_required(
        kwargs,
        ["prefix", "min_sequence_distance", "scoring_model",
         "use_all_ecs_for_scoring"],
    )
    kwargs = {"focus_mode": True, **kwargs}
    return _run_on_ranks(_complex, _plm_takes_part(kwargs), kwargs)


def _complex(**kwargs):
    prefix = kwargs["prefix"]

    outcfg, ecs, segments = infer_plmc(**kwargs)
    model = CouplingsModel(outcfg["model_file"])

    scoring_model = _validated_choice(
        kwargs["scoring_model"], SCORING_MODELS, "scoring_model"
    )
    use_all_ecs = bool(kwargs["use_all_ecs_for_scoring"] or False)
    ecs = complex_probability(ecs, scoring_model, use_all_ecs)

    # segment -> PDB chain convention: A, B, ... in segment order
    chain_mapping = dict(zip(
        [s.segment_id for s in segments], string.ascii_uppercase,
    ))

    outcfg = {
        **outcfg,
        **_postprocess_inference(
            ecs, kwargs, model, outcfg, prefix,
            generate_line_plot=True,
            generate_enrichment=False,
            ec_filter="segment_i != segment_j or abs(i - j) >= {}",
            chain=chain_mapping,
        ),
    }

    # inter-segment ECs as separate convenience file
    ecs = pd.read_csv(outcfg["ec_file"])
    outcfg["inter_ec_file"] = prefix + "_CouplingScores_inter.csv"
    ecs.query("segment_i != segment_j").to_csv(
        outcfg["inter_ec_file"], index=False
    )

    write_config_file(prefix + ".couplings_complex.outcfg", outcfg)
    return outcfg


def mean_field(**kwargs):
    """Protocol: infer ECs by mean-field DCA (focus mode only), on the
    job's `device` (None: the CUDA device). The covariance matrix is
    inverted in float64 there; `device_inversion: True` inverts it in
    float32 (the JAX package's device path). fit_devices ("all" or an
    int) splits the reweighting and the float64 inversion's solves over
    that many ranks of the process group."""
    check_required(kwargs, [
        "prefix", "alignment_file", "segments", "focus_mode",
        "focus_sequence", "theta", "pseudo_count", "alphabet",
        "min_sequence_distance", "ec_score_type",
    ])
    if not kwargs["focus_mode"]:
        raise InvalidParameterError(
            "For now, mean field DCA can only be run in focus mode.")
    take_part = (None if kwargs.get("fit_devices") is None
                 else _mean_field_fit)
    return _run_on_ranks(_mean_field, take_part, kwargs)


def _mean_field_fit(**kwargs):
    """The stage's mean-field model (None on a rank outside the fit's
    mesh); with fit_devices every rank of the process group calls it."""
    device = resolve_device(kwargs.get("device"))
    mesh = None
    fit_devices = kwargs.get("fit_devices")
    if fit_devices is not None:
        mesh = make_mesh(_resolve_fit_device_count(fit_devices),
                         device=device)
        if mesh.coords is None:
            return None
    input_alignment = Alignment.from_path(
        kwargs["alignment_file"], "fasta",
        alphabet=_resolve_alphabet(kwargs["alphabet"]), device=device)
    return MeanFieldDCA(input_alignment).fit(
        theta=kwargs["theta"], pseudo_count=kwargs["pseudo_count"],
        device=bool(kwargs.get("device_inversion", False)), mesh=mesh,
    )


def _mean_field(**kwargs):
    resolve_device(kwargs.get("device"))
    prefix = kwargs["prefix"]
    outcfg = _ec_stage_outcfg(prefix, kwargs, prefix + ".model")

    verify_resources("Input alignment does not exist",
                     kwargs["alignment_file"])
    create_prefix_folders(prefix)
    segments = _segments_from_config(kwargs)
    model = _mean_field_fit(**kwargs)

    model.to_raw_ec_file(outcfg["raw_ec_file"])
    if outcfg["model_file"] is not None:
        model.to_file(outcfg["model_file"], file_format="plmc_v2")

    for out_key, value in (
        ("num_sites", model.L),
        ("num_valid_sequences", model.N_valid),
        ("effective_sequences", float(round(model.N_eff, 1))),
        ("region_start", int(model.index_list[0])),
    ):
        outcfg[out_key] = value

    # the mean-field raw EC file has four score columns
    ecs = pd.read_csv(
        outcfg["raw_ec_file"], sep=" ",
        names=["i", "A_i", "j", "A_j", "mi_raw", "mi_apc", "di", "cn"],
    )
    ec_score_type = _validated_choice(
        kwargs.get("ec_score_type", "cn"),
        ("cn", "di", "mi_raw", "mi_apc"), "ec_score_type",
    )
    if ec_score_type == "cn":
        # distribution-based rescoring only applies to CN scores
        ecs, rescorer_outcfg_update = rescore_cn_score_ecs(
            ecs, segments, outcfg, kwargs, score="cn")
    else:
        ecs = ecs.assign(
            score=ecs[ec_score_type], probability=np.nan
        ).sort_values(by="score", ascending=False)
        rescorer_outcfg_update = {}

    single = segments is None or len(segments) == 1
    outcfg = {
        **outcfg,
        **rescorer_outcfg_update,
        **_postprocess_inference(
            ecs, kwargs, model, outcfg, prefix,
            generate_enrichment=single, generate_line_plot=single,
            score="score",
        ),
    }
    write_config_file(prefix + ".couplings_meanfield.outcfg", outcfg)
    return outcfg


# protocol registry: function names double as the config-facing names
PROTOCOLS = {
    fn.__name__: fn for fn in (standard, complex, mean_field)
}


def run(**kwargs):
    """Dispatch to the couplings protocol named by kwargs["protocol"]."""
    check_required(kwargs, ["protocol"])

    selected = _validated_choice(
        kwargs["protocol"], PROTOCOLS, "protocol selection"
    )
    return PROTOCOLS[selected](**kwargs)
