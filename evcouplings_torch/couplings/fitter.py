"""
In-process replacement for the external `plmc` binary (port of
evcouplings_tpu/couplings/fitter.py).

run_plm reads an alignment, reweights its sequences (K1 on the card),
fits the Potts model by pseudolikelihood (ops/plm.py), computes weighted
frequencies and FN/CN scores, and writes the plmc_v2 `.model` file and
the raw EC file, byte-compatible with plmc's.

plmc conventions reproduced:
- the focus sequence name is matched after splitting at "/"; region
  numbering is parsed from the "/start-end" suffix
- theta is the identity threshold directly
- lambda_J is the FINAL per-pair strength (any (q-1)(L-1) scaling is
  applied by the caller)
- `-g` (ignore_gaps): gap positions contribute neither a conditional
  term nor context (code -1 -> zero one-hot rows)
- raw EC file: `i A_i j A_j fn cn` rows for i < j in row-major order
"""

from collections import namedtuple

import numpy as np
import pandas as pd

from evcouplings_torch import parallel
from evcouplings_torch._device import resolve_device
from evcouplings_torch.align.alignment import (
    ALPHABET_PROTEIN,
    Alignment,
    parse_header,
)
from evcouplings_torch.couplings.model import CouplingsModel
from evcouplings_torch.ops import plm as ops_plm
from evcouplings_torch.ops import scores as _scores
from evcouplings_torch.ops.encode import device_codes, pad_rows
from evcouplings_torch.ops.frequencies import frequencies, pair_frequencies
from evcouplings_torch.ops.plm import PlmConfig, fit_plm
from evcouplings_torch.ops.plm_sites import fit_plm_asym
from evcouplings_torch.ops.weights import num_cluster_members
from evcouplings_torch.utils.system import (
    ResourceError, create_prefix_folders, verify_resources,
)

# result contract of plmc's wrapper (PlmcResult)
PlmResult = namedtuple(
    "PlmResult",
    [
        "couplings_file", "param_file",
        "iteration_table", "focus_seq_index",
        "num_valid_seqs", "num_total_seqs",
        "num_valid_sites", "num_total_sites",
        "region_start", "effective_samples",
        "optimization_status",
    ],
)


def prepare_alignment(alignment_file, focus_seq=None,
                      alphabet=ALPHABET_PROTEIN):
    """Load an alignment and prepare integer codes for the PLM fit.

    Focus mode: locate the focus sequence (name matched after stripping
    the "/start-end" range), restrict to its uppercase non-gap columns,
    and derive target numbering from its header. Non-focus mode uses all
    columns and numbering 1..L.

    Sequences with out-of-alphabet symbols in the selected columns are
    excluded from the fit but kept (weight 0) in the stored weights.

    Returns a dict with codes (N_valid, L), valid_index, target info and
    bookkeeping counts.
    """
    ali = Alignment.from_path(alignment_file, "fasta", alphabet=alphabet)
    N_total = ali.N

    if focus_seq is not None:
        focus_name = focus_seq.split("/")[0]
        focus_index = None
        for i, id_ in enumerate(ali.ids):
            if id_.split("/")[0] == focus_name or id_ == focus_seq:
                focus_index = i
                break
        if focus_index is None:
            raise ResourceError(
                "Focus sequence {} not found in alignment".format(focus_seq))

        target_row = ali.matrix[focus_index]
        focus_cols = np.array([
            c.isupper() and c not in (ali._match_gap, ali._insert_gap)
            for c in target_row
        ])

        _, region_start, _ = parse_header(ali.ids[focus_index])
        if region_start is None:
            region_start = 1

        matrix = ali.matrix[:, focus_cols]
        # numbering advances along the focus sequence: every column
        # where the focus row has a residue consumes one number
        is_residue = np.array([
            c not in (ali._match_gap, ali._insert_gap) for c in target_row
        ])
        index_list = (region_start + np.cumsum(is_residue) - 1)[focus_cols]
        target_seq = target_row[focus_cols]
    else:
        focus_index = None
        region_start = 1
        matrix = ali.matrix
        index_list = np.arange(1, ali.L + 1)
        target_seq = ali.matrix[0]

    L = matrix.shape[1]
    codes = np.full(matrix.shape, -1, dtype=np.int8)
    for idx, c in enumerate(alphabet):
        codes[matrix == c] = idx
    valid_rows = (codes >= 0).all(axis=1)

    return {
        "alignment": ali,
        "codes": codes[valid_rows],
        "valid_index": np.flatnonzero(valid_rows),
        "focus_index": focus_index,
        "target_seq": target_seq,
        "index_list": index_list,
        "region_start": int(region_start),
        "num_valid_seqs": int(valid_rows.sum()),
        "num_total_seqs": int(N_total),
        "num_valid_sites": int(L),
        "num_total_sites": int(ali.L),
        "alphabet": alphabet,
    }


def write_raw_ec_file(couplings_file, index_list, target_seq, fn, cn):
    """plmc-format raw EC file: `i A_i j A_j fn cn` for i < j."""
    L = len(index_list)
    ii, jj = np.triu_indices(L, k=1)
    with open(couplings_file, "w") as f:
        for i, j in zip(ii, jj):
            f.write("{} {} {} {} {:.6f} {:.6f}\n".format(
                index_list[i], target_seq[i],
                index_list[j], target_seq[j],
                fn[i, j], cn[i, j],
            ))


def _fmt_bytes(b):
    return ("{:.1f} GiB".format(b / 2 ** 30) if b >= 2 ** 30
            else "{:.1f} MiB".format(b / 2 ** 20))


def _symmetric_block_size(compute_dtype, n_fit, n_data_shards=1):
    """Default block size of the symmetric fit: 512 in parity mode; in
    bfloat16 mode the largest multiple of 512 up to 8192 that divides the
    512-padded row count of one "data" rank (the two-phase layout wants
    large blocks)."""
    if compute_dtype != "bfloat16":
        return 512
    k = max(1, -(-n_fit // (512 * n_data_shards)))
    return 512 * max(d for d in range(1, 17) if k % d == 0)


def run_plm(alignment, couplings_file, param_file=None, focus_seq=None,
            alphabet=None, theta=None, scale=None, ignore_gaps=False,
            iterations=None, lambda_h=None, lambda_J=None, lambda_g=None,
            cpu=None, binary=None, mesh=None, solver=None,
            group_mode=None, conv_tol=None,
            block_size=None, steps_per_call=1, pad_sites_to=None,
            pad_rows_to=None,
            compute_dtype="float32", matmul_precision="highest",
            parametrization="auto",
            callback=None, checkpoint_file=None, checkpoint_every=50,
            device=None, fused_update="auto"):
    """Fit a Potts model by pseudolikelihood maximization and write the
    plmc-compatible artifacts.

    Same signature as the JAX package's run_plm, plus `device` (None:
    the mesh's device, else the CUDA device; raises without one, pass
    "cpu" to run on the host) and `fused_update` (PlmConfig.fused_update
    of the Adam solver). `cpu` and `binary` are accepted and ignored.

    mesh: an evcouplings_torch.parallel mesh, on which every rank calls
    run_plm with the same arguments: the reweighting is split over its
    "data" ranks (parallel.num_cluster_members_sharded), rows shard over
    "data" in the fit and sites over "model" in the asymmetric one; the
    default block size and the memory routing are sized per rank. The
    mesh's first rank writes the files, the others wait for it, and every
    rank returns the same result.

    parametrization: "symmetric" (plmc semantics, ops/plm.py),
    "asymmetric" (independent per-site regressions symmetrized after the
    fit, ops/plm_sites.py; solver "adam" or per-site "lbfgs"), or "auto":
    symmetric while its estimated peak device memory fits 90% of the
    device (ops/plm.estimate_fit_hbm_bytes, device_hbm_budget), else
    asymmetric. An explicit "symmetric" past the budget raises
    MemoryError, as does an asymmetric fit past it; exact group-L1
    (lambda_g > 0 without group_mode "smoothed") on the asymmetric path
    raises ValueError. solver None picks the default: "fista" for exact
    group-L1, else "lbfgs" (symmetric) or "adam" (asymmetric).

    checkpoint_file / checkpoint_every: mid-fit snapshots and resume
    (ops/plm.fit_plm).

    pad_sites_to / pad_rows_to round the fitted site / sequence counts
    up with inert padding (code -1 columns, weight-0 rows).

    Returns PlmResult.
    """
    del cpu, binary
    device = resolve_device(
        mesh.device if device is None and mesh is not None else device)
    verify_resources("Alignment file does not exist", alignment)

    create_prefix_folders(couplings_file)
    if param_file is not None:
        create_prefix_folders(param_file)

    alphabet = ALPHABET_PROTEIN if alphabet is None else alphabet
    theta = 0.8 if theta is None else theta
    scale = 1.0 if scale is None else scale
    iterations = 100 if iterations is None else iterations
    lambda_h = 0.01 if lambda_h is None else lambda_h
    lambda_J = 0.01 if lambda_J is None else lambda_J
    lambda_g = 0.0 if lambda_g is None else lambda_g

    prep = prepare_alignment(alignment, focus_seq=focus_seq,
                             alphabet=alphabet)
    codes = prep["codes"]
    N, L = codes.shape
    q = len(alphabet)
    if N == 0:
        raise ResourceError(
            "No valid sequences to fit: every row of {} contains symbols "
            "outside the alphabet in the selected columns. A2M/A3M "
            "alignments with lowercase insert columns need focus mode "
            "(focus_seq=...) to select the uppercase match "
            "columns.".format(alignment))

    # O(N^2 L) reweighting (gaps participate in identity): K1 on the card,
    # split over the "data" ranks on a mesh
    codes_d = device_codes(codes, device=device)
    if mesh is None:
        cluster_sizes = num_cluster_members(codes_d, theta)
    else:
        cluster_sizes = parallel.num_cluster_members_sharded(
            codes_d, theta, mesh)
    cluster_sizes = cluster_sizes.cpu().numpy()
    weights = scale / cluster_sizes
    n_eff = float(weights.sum())

    # with ignore_gaps, gap positions are missing data (code -1)
    fit_codes = codes
    if ignore_gaps:
        fit_codes = np.where(codes == 0, -1, codes).astype(np.int8)

    L_fit = L
    if pad_sites_to:
        L_fit = -(-L // int(pad_sites_to)) * int(pad_sites_to)
        if L_fit != L:
            fit_codes = np.concatenate([
                fit_codes, np.full((N, L_fit - L), -1, dtype=np.int8),
            ], axis=1)
    fit_weights = weights
    if pad_rows_to:
        fit_codes, _ = pad_rows(fit_codes, int(pad_rows_to))
        fit_codes[N:] = -1
        fit_weights = np.pad(weights, (0, fit_codes.shape[0] - N))
    N_fit = fit_codes.shape[0]

    # rows shard over "data", sites over "model"
    shape = {} if mesh is None else mesh.shape
    n_data_shards = shape.get(parallel.DATA_AXIS, 1)
    n_model_shards = shape.get(parallel.MODEL_AXIS, 1)

    # each parametrization has its own default block size, resolved
    # before the preflight so the estimate sees the fit's grad layout:
    # the symmetric fit's (512 in parity mode, large blocks for the
    # two-phase layout in bfloat16), and 1024 for the asymmetric fit,
    # whose carried accumulator is small
    if block_size is None:
        sym_block = _symmetric_block_size(compute_dtype, N_fit,
                                          n_data_shards)
        asym_block = 1024
    else:
        sym_block = asym_block = int(block_size)

    if parametrization not in ("auto", "symmetric", "asymmetric"):
        raise ValueError(
            "Invalid parametrization: {!r} (valid: auto, symmetric, "
            "asymmetric)".format(parametrization))
    requested = parametrization

    # exact group-L1 needs the proximal solver; group_mode="smoothed"
    # opts out of it (the smooth approximation, which LBFGS handles)
    wants_exact_group = lambda_g > 0 and group_mode != "smoothed"
    sym_default_solver = "fista" if wants_exact_group else "lbfgs"
    budget = ops_plm.device_hbm_budget(device)

    # preflight: the symmetric fit while its estimate per rank fits 90% of
    # the device; "auto" routes past that to the asymmetric fit (a "model"
    # axis replicates the symmetric fit's rows, so only "data" divides it)
    if parametrization in ("auto", "symmetric"):
        sym_cfg = PlmConfig(solver=solver or sym_default_solver,
                            lambda_group=float(lambda_g),
                            dtype=compute_dtype, block_size=sym_block,
                            fused_update=fused_update)
        # the estimate counts the Adam step's epilogue as the fit runs it
        if fused_update == "auto":
            fused = ops_plm._resolve_fused_update(
                sym_cfg, mesh, ops_plm._acc_dtype(
                    ops_plm._compute_dtype(compute_dtype)), device)
            sym_cfg = PlmConfig(**{**sym_cfg.__dict__,
                                   "fused_update": "on" if fused else "off"})
        est = ops_plm.estimate_fit_hbm_bytes(
            N_fit, L_fit, q, sym_cfg, n_data_shards=n_data_shards)
        if est > 0.9 * budget:
            if parametrization == "symmetric":
                raise MemoryError(
                    "Symmetric PLM fit at L={} (q={}) needs an estimated {} "
                    "of device memory but only {} is available. Use "
                    "'parametrization: asymmetric', or leave parametrization "
                    "unset to route automatically.".format(
                        L, q, _fmt_bytes(est), _fmt_bytes(budget)))
            parametrization = "asymmetric"
        else:
            parametrization = "symmetric"

    asym = parametrization == "asymmetric"
    if asym:
        asym_cfg = PlmConfig(solver=solver or "adam", dtype=compute_dtype,
                             block_size=asym_block)
        est = ops_plm.estimate_fit_hbm_bytes(
            N_fit, L_fit, q, asym_cfg, "asymmetric",
            n_data_shards=n_data_shards, n_model_shards=n_model_shards)
        if est > budget:
            raise MemoryError(
                "Asymmetric PLM fit at L={} (q={}) needs an estimated {} per "
                "rank but only {} is available; shard sites across more "
                "ranks ('model_shards', currently {}).".format(
                    L, q, _fmt_bytes(est), _fmt_bytes(budget),
                    n_model_shards))
        # no proximal solver on this path: refuse instead of quietly
        # fitting the smoothed penalty
        if wants_exact_group:
            raise ValueError(
                "The asymmetric fit supports only the SMOOTHED group-L1 "
                "approximation, but lambda_group > 0 without "
                "group_mode='smoothed' requests the exact penalty{}. Pass "
                "group_mode='smoothed' to accept the approximation on this "
                "path, or force parametrization='symmetric' (solver "
                "'fista') if the coupling matrix fits device "
                "memory.".format(
                    " (auto-routing chose the asymmetric path for this "
                    "problem size)" if requested == "auto" else ""))

    if solver is None:
        solver = "adam" if asym else sym_default_solver
    cfg = PlmConfig(
        lambda_h=float(lambda_h),
        lambda_J=float(lambda_J),
        lambda_group=float(lambda_g),
        max_iter=int(iterations),
        **({} if conv_tol is None else {"conv_tol": float(conv_tol)}),
        solver=solver,
        block_size=asym_block if asym else sym_block,
        steps_per_call=int(steps_per_call),
        dtype=compute_dtype,
        precision=matmul_precision,
        # the asymmetric fit keeps the smoothed group penalty
        group_mode="smoothed" if asym else (group_mode or "prox"),
        fused_update=fused_update,
    )
    fit = (fit_plm_asym if asym else fit_plm)(
        fit_codes, fit_weights, q, cfg, mesh=mesh, callback=callback,
        checkpoint_file=checkpoint_file,
        checkpoint_every=checkpoint_every, device=device,
    )

    # drop the inert bucket-padding sites before scoring/persisting
    fit_J_ij = fit.J_ij[:L, :L]
    fit_h_i = fit.h_i[:L]

    # weighted frequencies (no pseudocount) for the .model file
    f_i = frequencies(codes_d, weights, q)
    f_ij = pair_frequencies(codes_d, weights, q, f_i)

    fn = _scores.fn_scores(fit_J_ij)
    cn = _scores.apc(fn)

    # weight vector in plmc layout: all sequences in original order,
    # invalid rows with weight 0
    all_weights = np.zeros(prep["num_total_seqs"])
    all_weights[prep["valid_index"]] = weights

    model = CouplingsModel.from_params(
        J_ij=fit_J_ij,
        h_i=fit_h_i,
        f_i=f_i,
        f_ij=f_ij,
        alphabet=alphabet,
        target_seq=prep["target_seq"],
        index_list=prep["index_list"],
        weights=all_weights,
        theta=float(theta),
        lambda_h=float(lambda_h),
        lambda_J=float(lambda_J),
        lambda_group=float(lambda_g),
        N_valid=prep["num_valid_seqs"],
        N_invalid=prep["num_total_seqs"] - prep["num_valid_seqs"],
        num_iter=fit.num_iter,
        N_eff=n_eff,
    )
    # one writer on a mesh (the ranks hold the same result); the others
    # return once the files are there
    if mesh is None or mesh.is_writer:
        if param_file is not None:
            model.to_file(param_file, precision="float32",
                          file_format="plmc_v2")
        write_raw_ec_file(
            couplings_file, prep["index_list"], prep["target_seq"], fn, cn)
    if mesh is not None:
        parallel.barrier(mesh)

    if fit.converged:
        status = "converged"
    elif fit.ls_failed:
        status = "line search failed at floating-point resolution"
    else:
        status = "maximum number of iterations reached"

    return PlmResult(
        couplings_file, param_file,
        pd.DataFrame(fit.iteration_table), prep["focus_index"],
        prep["num_valid_seqs"], prep["num_total_seqs"],
        prep["num_valid_sites"], prep["num_total_sites"],
        prep["region_start"], n_eff,
        status,
    )
