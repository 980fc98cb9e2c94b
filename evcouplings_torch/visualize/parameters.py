"""
EVzoom JSON export of pair-model parameters (port of
evcouplings_tpu/visualize/parameters.py).

Produces the {"map", "logo", "couplings"} document consumed by the
EVzoom web viewer.
"""

import json

import numpy as np

from evcouplings_torch.couplings.pairs import add_mixture_probability

_ROUND_J = 2
_ROUND_BITS = 2


def _select_ecs(model, ec_threshold, score):
    """ECs to display: probability cutoff if threshold is in (0, 1],
    top-N otherwise."""
    ecs = model.ecs
    if 0 < ec_threshold <= 1.0:
        with_prob = add_mixture_probability(ecs, score=score)
        return with_prob[with_prob.probability >= ec_threshold]
    return ecs.head(int(ec_threshold))


def _coupling_entry(model, i, j, score_value, sub_J, symbols,
                    row_keep, col_keep):
    """One direction of a coupling block: rows/columns of the q x q
    sub-matrix whose max |J| clears the display threshold."""
    return {
        "i": model.mn(i) + 1,
        "j": model.mn(j) + 1,
        "score": round(score_value, _ROUND_J),
        "iC": "".join(symbols[row_keep]),
        "jC": "".join(symbols[col_keep]),
        "matrix": [
            [round(v, _ROUND_J) for v in row]
            for row in sub_J[np.ix_(row_keep, col_keep)]
        ],
    }


def _sequence_logo(model, freq_threshold):
    """Information-content-scaled per-position frequency logo."""
    f = model.fi()
    q = model.num_symbols

    # per-position information R_i = log2(q) - H_i (0 * log 0 := 0)
    safe = np.where(f > 0, f, 1.0)
    entropy = -(f * np.log2(safe)).sum(axis=1)
    information = np.log2(q) - entropy

    logo = []
    for f_row, r in zip(f, information):
        shown = np.argsort(f_row)
        shown = shown[f_row[shown] >= freq_threshold]
        logo.append([
            {
                "code": model.alphabet[a],
                "bits": round(float(f_row[a] * r), _ROUND_BITS),
            }
            for a in shown
        ])
    return logo


def evzoom_data(model, ec_threshold=0.9, freq_threshold=0.01,
                Jij_threshold=10, score="cn", reorder=None):
    """Build the (map, logo, couplings-matrix) triple for EVzoom.

    ec_threshold in (0, 1] is a mixture-model probability cutoff,
    larger values an absolute EC count; int Jij_threshold is a
    percentage of the maximum |J|, float an absolute value; reorder
    optionally gives a custom alphabet display order.
    """
    if isinstance(Jij_threshold, int):
        Jij_threshold = (
            np.abs(model.Jij()).max() * Jij_threshold / 100.0
        )

    if reorder is None:
        order = sorted(model.alphabet_map.values())
        symbols = model.alphabet
    else:
        order = [model.alphabet_map[c] for c in reorder]
        symbols = np.array(list(reorder))

    sequence_map = {
        "letters": "".join(model.seq()),
        "indices": [int(n) for n in model.sn()],
    }

    couplings = []
    for _, ec in _select_ecs(model, ec_threshold, score).iterrows():
        i, j = ec["i"], ec["j"]
        sub_J = model.Jij(i, j)[np.ix_(order, order)]
        keep_i = np.abs(sub_J).max(axis=1) > Jij_threshold
        keep_j = np.abs(sub_J).max(axis=0) > Jij_threshold
        keep_i, keep_j = np.where(keep_i)[0], np.where(keep_j)[0]

        # emit both orientations; the (j, i) block is the transpose
        couplings.append(_coupling_entry(
            model, i, j, ec[score], sub_J, symbols, keep_i, keep_j
        ))
        couplings.append(_coupling_entry(
            model, j, i, ec[score], sub_J.T, symbols, keep_j, keep_i
        ))

    return sequence_map, _sequence_logo(model, freq_threshold), couplings


def evzoom_json(model, **kwargs):
    """EVzoom-ready JSON string for a CouplingsModel."""
    sequence_map, logo, couplings = evzoom_data(model, **kwargs)
    return json.dumps({
        "map": sequence_map,
        "logo": logo,
        "couplings": couplings,
    })
