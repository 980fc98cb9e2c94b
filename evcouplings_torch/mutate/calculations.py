"""
Mutation-effect (EVmutation) calculations on fitted couplings models
(port of evcouplings_tpu/mutate/calculations.py): extract_mutations,
predict_mutation_table, single_mutant_matrix, split_mutants.

The per-mutant Delta-E evaluations route through
CouplingsModel.delta_hamiltonian (vectorized float64 numpy on the host,
ops/hamiltonian.py), as in the JAX package.
"""

import numpy as np
import pandas as pd

from evcouplings_torch.utils.calculations import entropy_map

# delta_hamiltonian() component tuple layout
COMPONENT_TO_INDEX = {"full": 0, "couplings": 1, "fields": 2}


def extract_mutations(mutation_string, offset=0, sep=","):
    """Parse "K50R,I100V" into [(50 + offset, "K", "R"), ...].

    "wild"/"wt"/"" parse to an empty substitution list.
    """
    if mutation_string.lower() in ("wild", "wt", ""):
        return []
    return [
        (int(m[1:-1]) + offset, m[0], m[-1])
        for m in mutation_string.split(sep)
    ]


def predict_mutation_table(model, table, output_column="prediction_epistatic",
                           mutant_column="mutant", hamiltonian="full",
                           segment=None):
    """Add a Delta-E prediction column for every mutant in a table.

    Mutations that cannot be scored (position not covered by the model,
    invalid symbol) get NaN. With a "segment" column (or an explicit
    `segment` argument), positions are looked up as (segment, pos) keys
    for multi-segment complex models.
    """
    try:
        component = COMPONENT_TO_INDEX[hamiltonian]
    except KeyError:
        raise ValueError(
            "Invalid selection for hamiltonian. "
            "Valid values are: " + ", ".join(COMPONENT_TO_INDEX)
        ) from None

    if not model.has_target_seq:
        raise ValueError(
            "CouplingsModel object does not have a target "
            "sequence (non-focus mode). "
            "Set target sequence, or rerun inference in focus mode."
        )

    pred = table.copy()
    mutations = (
        pred.index if mutant_column is None
        else pred.loc[:, mutant_column]
    )
    mutation_list = _mutation_lists(pred, mutations, segment)

    def _predict(m):
        try:
            return model.delta_hamiltonian(m)[component]
        except ValueError:
            return np.nan

    pred.loc[:, output_column] = [_predict(m) for m in mutation_list]
    return pred


def _with_segment_keys(muts, seg):
    """Substitutions re-keyed for multi-segment models:
    pos -> (segment, pos)."""
    return [((seg, pos), aa_from, aa_to) for pos, aa_from, aa_to in muts]


def _paired_segment_mutations(seg_str, mut_str):
    """One dataset row's substitutions, each keyed by its entry in the
    row's comma-separated segment list."""
    segs = seg_str.split(",")
    muts = extract_mutations(mut_str)
    # wild-type rows ("wt"/"wild"/empty) carry no mutations; their
    # segment annotation is irrelevant and they score Delta-E = 0
    # (the reference reaches the same outcome because its zip
    # silently truncates)
    if muts and len(segs) != len(muts):
        raise ValueError(
            "Number of mutations does not match number of "
            "segments of origin: {} vs {}".format(mut_str, seg_str)
        )
    return [
        ((seg, pos), aa_from, aa_to)
        for seg, (pos, aa_from, aa_to) in zip(segs, muts)
    ]


def _mutation_lists(pred, mutations, segment):
    """Per-row substitution lists, keyed by segment when the table (or
    the caller) provides one."""
    if "segment" in pred.columns and pred.loc[:, "segment"].notnull().all():
        return [
            _paired_segment_mutations(seg_str, mut_str)
            for seg_str, mut_str in zip(pred.loc[:, "segment"], mutations)
        ]
    if segment is not None:
        return [
            _with_segment_keys(extract_mutations(m), segment)
            for m in mutations
        ]
    return [extract_mutations(m) for m in mutations]


def single_mutant_matrix(model, output_column="prediction_epistatic",
                         exclude_self_subs=True):
    """Table of all single substitutions of the model's target sequence,
    annotated with frequency and column conservation.

    Column layout parity: reference calculations.py:183-248. The Delta-E
    values come from the precomputed (L, q) single-mutant matrix instead
    of per-substitution kernel calls.
    """
    conservation = entropy_map(model)
    columns = ["segment", "mutant", "pos", "wt", "subs", "frequency",
               "column_conservation", output_column]

    rows = []
    for pos in model.index_list:
        wt = model.seq(pos)
        # multi-segment models index positions by (segment_id, pos)
        seg, label = pos if isinstance(pos, tuple) else (np.nan, pos)

        rows.extend(
            (seg, "{}{}{}".format(wt, label, subs), label, wt, subs,
             model.fi(pos, subs), conservation[pos],
             model.smm(pos, subs))
            for subs in model.alphabet
            if subs not in ("-", ".")
            and not (exclude_self_subs and subs == wt)
        )

    return pd.DataFrame(rows, columns=columns)


def split_mutants(x, mutant_column="mutant"):
    """Split mutation strings into pos/wt/subs/num_mutations columns
    (comma-joined for higher-order mutants)."""
    def _split(mut_str):
        try:
            return sorted(extract_mutations(mut_str))
        except ValueError:
            return np.nan

    mutations = (
        x.index if mutant_column is None else x.loc[:, mutant_column]
    )
    spl = pd.Series(mutations).map(_split)

    def _is_bad(m):
        # the _split fallback marks unparseable mutant strings as NaN
        return not isinstance(m, list)

    x = x.copy()
    # whole-column assignment: replaces any pre-existing pos/wt/subs
    # column regardless of its dtype (``.loc[:, col] = strings`` on an
    # int column raises in pandas >= 2)
    x["num_mutations"] = [
        np.nan if _is_bad(m) else len(m) for m in spl
    ]
    for i, column in enumerate(["pos", "wt", "subs"]):
        x[column] = [
            np.nan if _is_bad(mutant)
            else ",".join(str(sub[i]) for sub in mutant)
            for mutant in spl
        ]
    return x
