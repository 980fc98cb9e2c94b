"""
EC filters for 3D structure prediction: geometric clashes with
predicted secondary structure, and multiple-disulfide clashes (port of
evcouplings_tpu/fold/filter.py, formulated over the longest
secondary-structure runs).
"""

import pandas as pd

# pairs separated by at least this many positions never count as
# clashing, regardless of secondary structure
_MAX_CLASH_SEPARATION = 15


def _longest_run(string, char):
    """Length of the longest consecutive run of `char` in `string`."""
    best = current = 0
    for c in string:
        current = current + 1 if c == char else 0
        best = max(best, current)
    return best


def _is_uniform(string, char):
    """True if the string consists only of `char` (vacuously true for
    the empty string — which makes adjacent pairs clash, as in the
    original matlab rules)."""
    return all(c == char for c in string)


def detect_secstruct_clash(i, j, secstruct):
    """True if pair (i, j) is geometrically impossible given the
    predicted secondary structure.

    secstruct maps position (int) -> state ("H", "E", "C").
    """
    lo, hi = min(i, j), max(i, j)
    sep = hi - lo
    if sep >= _MAX_CLASH_SEPARATION:
        return False

    span = "".join(secstruct[p] for p in range(lo, hi + 1))
    interior = span[1:-1]

    def exactly_one_end_is(state):
        return (span[0] == state) != (span[-1] == state)

    # --- helix geometry ---
    # an all-helical stretch between the endpoints cannot bring them
    # into contact at short separation
    if _is_uniform(interior, "H"):
        return True
    if exactly_one_end_is("H"):
        helix_run = _longest_run(span, "H")
        # a near-complete helix across the span excludes contact once
        # the separation outgrows one helical turn (resp. ~three)
        if helix_run >= sep - 1:
            if sep > 6:
                return True
        elif helix_run >= sep - 2:
            if sep > 11:
                return True

    # --- strand geometry ---
    if _is_uniform(interior, "E"):
        return True
    if _is_uniform(interior[1:-1], "E") and sep > 8:
        return True
    if exactly_one_end_is("E"):
        strand_run = _longest_run(span, "E")
        if strand_run >= sep - 2:
            return True
        if strand_run >= sep - 3 and sep > 8:
            return True

    return False


def secstruct_clashes(ec_pairs, residues, output_column="ss_clash",
                      secstruct_column="sec_struct_3state"):
    """Annotate an EC table (columns i, j) with secondary-structure
    clash flags from a residue table (columns i, secstruct_column)."""
    states = dict(zip(residues.i, residues[secstruct_column]))

    out = ec_pairs.copy()
    out[output_column] = [
        detect_secstruct_clash(i, j, states)
        for i, j in zip(out["i"], out["j"])
    ]
    return out


def disulfide_clashes(ec_pairs, output_column="cys_clash"):
    """Flag cys-cys EC pairs whose residues already occur in a
    higher-ranked cys-cys pairing (a cysteine forms one bridge)."""
    out = ec_pairs.copy()

    flags = pd.Series(False, index=out.index)
    bridged = set()
    is_cys_pair = (out["A_i"] == "C") & (out["A_j"] == "C")
    for idx in out.index[is_cys_pair]:
        i, j = out.at[idx, "i"], out.at[idx, "j"]
        flags.at[idx] = i in bridged or j in bridged
        bridged.update((i, j))

    out[output_column] = flags
    return out
