"""
Tutorial: model parameters and mutation effects (EVmutation).

Executable counterpart of the reference's
notebooks/model_parameters_mutation_effects.ipynb — the same
walkthrough, section by section, against the bundled demo alignment
(no downloads; the model the notebook loads from disk is produced
here by the PyTorch port's fitter first, everything downstream is the
identical CouplingsModel API).

    python examples_torch/generate_data.py              # once
    python examples_torch/tutorial_model_parameters.py  [output_dir]
"""

import os
import sys

import numpy as np
import pandas as pd

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")

# where the fit runs: unset is the CUDA device (raises without one),
# EVCOUPLINGS_TORCH_DEVICE=cpu the host
DEVICE = os.environ.get("EVCOUPLINGS_TORCH_DEVICE") or None


def section(title):
    print("\n" + "=" * 8, title, "=" * 8)


def main(out=None):
    out = out or os.path.join(HERE, "output", "tutorial_model")
    os.makedirs(out, exist_ok=True)

    # ------------------------------------------------------------
    section("Part 1: load parameters to create a pairwise model")
    # The reference notebook loads a pre-computed PABP_YEAST model
    # file; we first produce an equivalent .model (plmc_v2 binary)
    # from the demo alignment with the port's pseudolikelihood fitter.
    from evcouplings_torch.couplings.fitter import run_plm

    model_file = os.path.join(out, "demo.model")
    run_plm(
        os.path.join(DATA, "demo_monomer.a2m"),
        os.path.join(out, "demo_ECs.txt"),
        param_file=model_file,
        focus_seq="DEMO_MONOMER/1-30",
        theta=0.8, iterations=int(os.environ.get("TUTORIAL_ITERS", 60)),
        lambda_h=0.01, lambda_J=16.0, device=DEVICE,
    )

    from evcouplings_torch.couplings import CouplingsModel

    c = CouplingsModel(model_file)
    print("loaded model: L = {}, q = {}, N_eff = {:.1f}".format(
        c.L, c.num_symbols, c.N_eff))

    # ------------------------------------------------------------
    section("Part 2: predict mutation effects")
    from evcouplings_torch.mutate import (
        predict_mutation_table, single_mutant_matrix,
    )

    # stand-in for an experimental deep mutational scanning dataset
    # (the notebook reads PABP_YEAST_Fields2013-singles.csv): a table
    # with a "mutant" column like A100V and a measured-effect column
    rng = np.random.default_rng(0)
    aa = [a for a in c.alphabet if a != "-"]
    mutants = []
    for pos in rng.choice(c.index_list, size=12, replace=False):
        wt = c.seq(pos)
        subs = rng.choice([a for a in aa if a != wt], size=2,
                          replace=False)
        mutants.extend("{}{}{}".format(wt, pos, s) for s in subs)
    data = pd.DataFrame({
        "mutant": mutants,
        "measured_effect": rng.normal(size=len(mutants)),
    })

    data_pred = predict_mutation_table(
        c, data, "effect_prediction_epistatic"
    )

    # predictions of the corresponding site-independent model
    c0 = c.to_independent_model()
    data_pred = predict_mutation_table(
        c0, data_pred, "effect_prediction_independent"
    )
    print(data_pred.head().to_string(index=False))
    data_pred.to_csv(os.path.join(out, "mutation_predictions.csv"),
                     index=False)

    # full single-substitution landscape, no experiment needed
    singles = single_mutant_matrix(
        c, output_column="effect_prediction_epistatic"
    )
    print("\nsingle-mutant landscape ({} rows):".format(len(singles)))
    print(singles.head().to_string(index=False))

    # arbitrary (higher-order) mutations: a double mutant
    i, j = int(c.index_list[4]), int(c.index_list[9])
    subs = [(i, c.seq(i), "M"), (j, c.seq(j), "A")]
    delta_E, dE_couplings, dE_fields = c.delta_hamiltonian(subs)
    print("\ndouble mutant {}: delta E = {:+.3f} "
          "(couplings {:+.3f}, fields {:+.3f})".format(
              subs, delta_E, dE_couplings, dE_fields))

    # shortcuts: smm (all substitutions of one position), dmm (all
    # second substitutions given a fixed first one)
    print("smm({}, 'E') = {:+.3f}".format(i, float(c.smm(i, "E"))))
    print("dmm({}, {}, 'M', 'A') = {:+.3f}".format(
        i, j, float(c.dmm(i, j, "M", "A"))))

    # statistical energy of a full sequence (not a delta to WT)
    E, E_couplings, E_fields = c.hamiltonians(["".join(c.seq())])[0]
    print("H(target) = {:+.3f}".format(E))

    # ------------------------------------------------------------
    section("Part 3: explore model parameters")
    print("target sequence:", "".join(c.seq()))
    print("symbol at position {}: {}".format(i, c.seq(i)))
    print("positions in model:", [int(x) for x in c.index_list[:10]],
          "...")
    print("alphabet:", "".join(c.alphabet))
    print("J_ij({0}, {1}, {2}, {3}) = {4:+.4f}".format(
        i, j, c.seq(i), c.seq(j),
        float(c.Jij(i, j, c.seq(i), c.seq(j)))))
    print("h_i({0}, {1}) = {2:+.4f}".format(
        i, c.seq(i), float(c.hi(i, c.seq(i)))))

    # ------------------------------------------------------------
    section("Part 4: index mapping for complexes")
    # When the model was fit on a concatenated alignment, positions
    # are renumbered to (segment, position) pairs.
    from evcouplings_torch.couplings import Segment, SegmentIndexMapper

    half = c.L // 2
    s_a = Segment("aa", "DEMO_A", 1, half, segment_id="A_1")
    s_b = Segment("aa", "DEMO_B", 1, c.L - half, segment_id="B_1")
    mapper = SegmentIndexMapper(True, int(c.index_list[0]), s_a, s_b)

    c_mapped = mapper.patch_model(c, inplace=False)
    pos_b = ("B_1", 3)
    print("seq({}) = {}".format(pos_b, c_mapped.seq(pos_b)))
    print("smm({}, 'A') = {:+.3f}".format(
        pos_b, float(c_mapped.smm(pos_b, "A"))))

    print("\ntutorial outputs in", out)
    return data_pred, singles


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
