"""
Library quickstart with the PyTorch port (evcouplings_torch): alignment
-> Potts fit -> EC table -> mutation-effect matrix -> contact-map plot,
entirely through public package APIs (no pipeline/config machinery).

    python examples_torch/generate_data.py     # once
    python examples_torch/library_quickstart.py

The numeric work runs on the CUDA device, and the script raises without
one; EVCOUPLINGS_TORCH_DEVICE=cpu runs it on the host instead.
"""

import os

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
OUT = os.path.join(HERE, "output", "monomer")

# unset: the CUDA device; EVCOUPLINGS_TORCH_DEVICE=cpu: the host
DEVICE = os.environ.get("EVCOUPLINGS_TORCH_DEVICE") or None


def main():
    os.makedirs(OUT, exist_ok=True)
    msa = os.path.join(DATA, "demo_monomer.a2m")

    # --- 1. load the alignment (native C parser when built) ---
    from evcouplings_torch.align.alignment import Alignment

    ali = Alignment.from_path(msa, device=DEVICE)
    print("alignment: {} sequences x {} sites".format(ali.N, ali.L))

    # --- 2. pseudolikelihood Potts fit (the plmc replacement) ---
    from evcouplings_torch.couplings.fitter import run_plm

    ec_file = os.path.join(OUT, "ECs.txt")
    model_file = os.path.join(OUT, "demo.model")
    result = run_plm(
        msa, ec_file, param_file=model_file,
        focus_seq="DEMO_MONOMER/1-30",
        theta=0.8, iterations=60,
        lambda_h=0.01, lambda_J=16.0,   # already scaled by (q-1)(L-1)
        device=DEVICE,
    )
    print("fit: N_eff = {:.1f}, {} iterations".format(
        result.effective_samples, len(result.iteration_table)
    ))

    # --- 3. couplings model + EC scores ---
    from evcouplings_torch.couplings.model import CouplingsModel
    from evcouplings_torch.couplings.pairs import (
        add_mixture_probability, read_raw_ec_file
    )

    model = CouplingsModel(model_file)
    ecs = read_raw_ec_file(ec_file)
    ecs = add_mixture_probability(ecs, model="skewnormal")
    ecs = ecs.sort_values("cn", ascending=False)
    print("top ECs:")
    print(ecs.head(5).to_string(index=False))

    # --- 4. mutation-effect scan (all single substitutions) ---
    from evcouplings_torch.mutate.calculations import single_mutant_matrix

    smm = single_mutant_matrix(model, output_column="prediction_epistatic")
    smm.to_csv(os.path.join(OUT, "single_mutants.csv"), index=False)
    worst = smm.nsmallest(3, "prediction_epistatic")
    print("most deleterious predicted mutations:")
    print(worst[["mutant", "prediction_epistatic"]].to_string(index=False))

    # --- 5. contact map of the top-L/2 ECs ---
    from evcouplings_torch.visualize.pairs import plot_contact_map

    fig, ax = plt.subplots(figsize=(5, 5))
    plot_contact_map(ecs=ecs.head(model.L // 2), ax=ax)
    fig.savefig(os.path.join(OUT, "contact_map.png"), dpi=150)
    print("wrote", os.path.join(OUT, "contact_map.png"))


if __name__ == "__main__":
    main()
