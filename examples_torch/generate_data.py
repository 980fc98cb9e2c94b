"""
Generate the bundled demo alignments (examples_torch/data/), the same bytes
as examples/data/ (seed 11).

The alignments are synthetic focus-mode MSAs with planted covarying
column pairs of graded strength, so every downstream stage (coupling
ranks, mixture probabilities, mutation scans, inter-chain pairing) has
real signal to find. Regenerate with:  python examples_torch/generate_data.py
"""

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")

AA = np.array(list("ACDEFGHIKLMNPQRSTVWY"))


def synthetic_msa(rng, N, L, planted):
    """Background columns from per-column Dirichlet profiles, plus
    planted two-state covarying pairs with given concordance."""
    mat = np.empty((N, L), dtype="U1")
    for col in range(L):
        probs = rng.dirichlet(np.ones(20) * 0.4)
        mat[:, col] = rng.choice(AA, size=N, p=probs)

    for (ci, cj), (si0, si1), (sj0, sj1), conc in planted:
        state = rng.integers(0, 2, size=N)
        follow = rng.random(N) < conc
        partner = np.where(follow, state, 1 - state)
        mat[:, ci] = np.where(state == 0, si0, si1)
        mat[:, cj] = np.where(partner == 0, sj0, sj1)

    return mat


def write_a2m(path, mat, target_id, first_index=1, species=None):
    N, L = mat.shape
    with open(path, "w") as f:
        f.write(">{}/{}-{}\n".format(
            target_id, first_index, first_index + L - 1
        ))
        f.write("".join(mat[0]) + "\n")
        for i in range(1, N):
            if species is not None:
                f.write(">seq{}_{}\n".format(i, species[i]))
            else:
                f.write(">seq{}\n".format(i))
            f.write("".join(mat[i]) + "\n")


def main():
    os.makedirs(DATA, exist_ok=True)
    rng = np.random.default_rng(11)

    # --- monomer demo: L=30, strong planted contacts ---
    planted = [
        ((3, 17), ("A", "W"), ("C", "Y"), 0.92),
        ((6, 24), ("D", "R"), ("E", "K"), 0.85),
        ((10, 21), ("F", "L"), ("H", "T"), 0.75),
        ((1, 28), ("N", "G"), ("Q", "S"), 0.65),
    ]
    mat = synthetic_msa(rng, N=400, L=30, planted=planted)
    # sprinkle gaps outside the target row
    gr = rng.integers(1, 400, size=40)
    gc = rng.integers(0, 30, size=40)
    mat[gr, gc] = "-"
    write_a2m(os.path.join(DATA, "demo_monomer.a2m"), mat, "DEMO_MONOMER")

    # --- complex demo: two monomer alignments sharing species labels
    # (for best_hit per-species pairing), with an inter-molecule
    # covarying pair planted ACROSS the two alignments ---
    n_species = 120
    species = ["sp{}".format(i % n_species) for i in range(240)]

    mat1 = synthetic_msa(rng, N=240, L=20, planted=[
        ((2, 11), ("A", "W"), ("C", "Y"), 0.85),
    ])
    mat2 = synthetic_msa(rng, N=240, L=16, planted=[
        ((4, 13), ("D", "R"), ("E", "K"), 0.85),
    ])
    # plant an inter-chain pair: column 7 of chain 1 covaries with
    # column 3 of chain 2 for rows of the same species index
    state = rng.integers(0, 2, size=240)
    follow = rng.random(240) < 0.9
    partner = np.where(follow, state, 1 - state)
    mat1[:, 7] = np.where(state == 0, "M", "V")
    mat2[:, 3] = np.where(partner == 0, "I", "P")

    write_a2m(os.path.join(DATA, "demo_chain_a.a2m"), mat1,
              "DEMO_A", species=species)
    write_a2m(os.path.join(DATA, "demo_chain_b.a2m"), mat2,
              "DEMO_B", species=species)

    # annotation tables for the best_hit pairing protocol (in a real
    # search pipeline the align stage extracts these from database
    # headers; the hermetic demo parses them from 'seqN_spM' ids)
    for name, mat in (("a", mat1), ("b", mat2)):
        target = "DEMO_{}".format(name.upper())
        length = mat.shape[1]
        ids = ["{}/1-{}".format(target, length)] + [
            "seq{}_{}".format(i, species[i])
            for i in range(1, mat.shape[0])
        ]
        os_col = ["Query"] + species[1:]
        with open(os.path.join(
                DATA, "demo_chain_{}_annotation.csv".format(name)),
                "w") as f:
            f.write("id,name,OS\n")
            for id_, sp in zip(ids, os_col):
                f.write("{},{},{}\n".format(id_, id_, sp))

    print("wrote demo alignments and annotations to", DATA)


if __name__ == "__main__":
    main()
