"""
Tutorial: distance calculations and contact-map plotting with the
PyTorch port (evcouplings_torch).

Executable counterpart of the reference's
notebooks/distance_calculations.ipynb — the same walkthrough against
bundled data only: the "solved structures" the notebook fetches from
the PDB are synthesized here as BinaryCIF files (through the public
bcif codec) for a toy fold in which the demo alignment's planted
covarying pairs are in spatial contact, so the EC-vs-distance
comparison at the end shows real precision. The SIFTS-by-homology
selection step needs databases + jackhmmer and is replaced by a
hand-built SIFTSResult with the same shape (hits table + index
mappings), which is exactly what the SIFTS lookups produce.

    python examples_torch/generate_data.py        # once
    python examples_torch/tutorial_distances.py   [output_dir]
"""

import os
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pandas as pd

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")

# where distances and the fit run: unset is the CUDA device (raises
# without one), EVCOUPLINGS_TORCH_DEVICE=cpu the host
DEVICE = os.environ.get("EVCOUPLINGS_TORCH_DEVICE") or None

# the covarying column pairs planted in demo_monomer.a2m
# (examples_torch/generate_data.py), 1-based positions
PLANTED = [(4, 18), (7, 25), (11, 22), (2, 29)]


def section(title):
    print("\n" + "=" * 8, title, "=" * 8)


def fold_coordinates(L, contacts, seed=0, steps=3000):
    """Toy 'fold': relax a random chain so consecutive residues sit
    ~3.8 A apart and the given (0-based) residue pairs end up ~4 A
    apart; everything else drifts to generic non-contact distances."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((L, 3)) * 8.0
    for _ in range(steps):
        g = np.zeros_like(x)
        d = x[1:] - x[:-1]
        dist = np.maximum(
            np.linalg.norm(d, axis=1, keepdims=True), 1e-6
        )
        # gradient of sum 0.5*(|d| - rest)^2 over bonds and contacts
        f = (dist - 3.8) * d / dist
        g[1:] += f
        g[:-1] -= f
        for i, j in contacts:
            dij = x[j] - x[i]
            dd = max(float(np.linalg.norm(dij)), 1e-6)
            f = (dd - 4.0) * dij / dd
            g[j] += f
            g[i] -= f
        x -= 0.05 * g
    return x


def write_structure(path, coords_by_chain):
    """Write chains of CA coordinates as a BinaryCIF structure file
    (the format the PDB serves and compare.pdb parses natively)."""
    from evcouplings_torch.compare import bcif

    rows = []
    for chain, coords in coords_by_chain.items():
        for k, xyz in enumerate(coords):
            rows.append((chain, k + 1, xyz))
    n = len(rows)
    bcif.write_bcif(path, {
        "_atom_site": {
            "pdbx_PDB_model_num": np.ones(n, dtype=int),
            "group_PDB": ["ATOM"] * n,
            "id": np.arange(1, n + 1),
            "type_symbol": ["C"] * n,
            "label_atom_id": ["CA"] * n,
            "auth_atom_id": ["CA"] * n,
            "label_alt_id": [""] * n,
            "label_comp_id": ["ALA"] * n,
            "auth_comp_id": ["ALA"] * n,
            "label_asym_id": [r[0] for r in rows],
            "auth_asym_id": [r[0] for r in rows],
            "label_entity_id": ["1"] * n,
            "label_seq_id": np.array([r[1] for r in rows]),
            "auth_seq_id": np.array([r[1] for r in rows]),
            "pdbx_PDB_ins_code": [""] * n,
            "Cartn_x": np.array([r[2][0] for r in rows]),
            "Cartn_y": np.array([r[2][1] for r in rows]),
            "Cartn_z": np.array([r[2][2] for r in rows]),
            "occupancy": np.ones(n),
            "B_iso_or_equiv": np.full(n, 20.0),
            "pdbx_formal_charge": np.zeros(n, dtype=int),
        },
    })


def main(out=None):
    out = out or os.path.join(HERE, "output", "tutorial_distances")
    os.makedirs(out, exist_ok=True)
    L = 30

    # ------------------------------------------------------------
    section("Synthesize 'solved structures' for the demo protein")
    contacts0 = [(i - 1, j - 1) for i, j in PLANTED]
    xyz = fold_coordinates(L, contacts0, seed=1)
    # structure 1: two copies of the chain (a homodimer) — the second
    # chain translated away, for the multimer-distance demo
    write_structure(os.path.join(out, "dem1.bcif"),
                    {"A": xyz, "B": xyz + np.array([30.0, 0, 0])})
    # structure 2: an independently refined conformation of the same
    # protein (perturbed coordinates), for map aggregation
    rng = np.random.default_rng(2)
    write_structure(os.path.join(out, "dem2.bcif"),
                    {"A": xyz + rng.normal(0, 0.3, xyz.shape)})

    # ------------------------------------------------------------
    section("Load structures and inspect chains")
    from evcouplings_torch.compare.pdb import PDB

    structures = {
        "dem1": PDB.from_file(os.path.join(out, "dem1.bcif")),
        "dem2": PDB.from_file(os.path.join(out, "dem2.bcif")),
    }
    coords = structures["dem1"].get_chain("A")
    print("chain A residues:")
    print(coords.residues.head().to_string(index=False))
    print("chain A atoms:")
    print(coords.coords.head().to_string(index=False))

    # ------------------------------------------------------------
    section("Distance maps straight from coordinates")
    from evcouplings_torch.compare.distances import (
        DistanceMap, intra_dists, multimer_dists,
    )

    distmap_pdb = DistanceMap.from_coords(coords, device=DEVICE)
    print("dist({0}, {1}) = {2:.2f} A (planted contact)".format(
        *PLANTED[0], distmap_pdb.dist(str(PLANTED[0][0]),
                                      str(PLANTED[0][1]))))

    # a second chain gives INTER-chain distances
    chain_b = structures["dem1"].get_chain("B")
    distmap_inter = DistanceMap.from_coords(coords, chain_b,
                                            device=DEVICE)
    print("inter-chain dist(1, 1) = {:.2f} A".format(
        distmap_inter.dist("1", "1")))

    # ------------------------------------------------------------
    section("Aggregate over structure hits (SIFTS result shape)")
    # The notebook finds hits with SIFTS.by_pdb_id / by_uniprot_id /
    # by_alignment (network + databases); their output shape is a
    # SIFTSResult: a hits table + per-hit seqres->target index maps.
    from evcouplings_torch.compare.sifts import SIFTSResult

    full_map = {(1, L): (1, L)}
    hits_intra = pd.DataFrame({
        "pdb_id": ["dem1", "dem2"],
        "pdb_chain": ["A", "A"],
        "mapping_index": [0, 1],
    })
    selected = SIFTSResult(hits_intra, {0: full_map, 1: full_map})

    distmap_intra = intra_dists(selected, structures=structures,
                                device=DEVICE)

    hits_multimer = pd.DataFrame({
        "pdb_id": ["dem1", "dem1"],
        "pdb_chain": ["A", "B"],
        "mapping_index": [0, 0],
    })
    distmap_multimer = multimer_dists(
        SIFTSResult(hits_multimer, {0: full_map}),
        structures=structures, device=DEVICE,
    )

    # distance maps persist as a residue-table csv + .npy matrix
    prefix = os.path.join(out, "demo_distance_map")
    distmap_intra.to_file(prefix)
    distmap_intra = DistanceMap.from_file(prefix)
    for i, j in PLANTED:
        print("aggregated dist({}, {}) = {:.2f} A".format(
            i, j, distmap_intra.dist(i, j)))

    # ------------------------------------------------------------
    section("Compare evolutionary couplings to the structure")
    from evcouplings_torch.couplings.fitter import run_plm
    from evcouplings_torch.couplings.pairs import read_raw_ec_file

    ec_file = os.path.join(out, "demo_ECs.txt")
    run_plm(
        os.path.join(DATA, "demo_monomer.a2m"), ec_file,
        focus_seq="DEMO_MONOMER/1-30",
        theta=0.8, iterations=int(os.environ.get("TUTORIAL_ITERS", 60)),
        lambda_h=0.01, lambda_J=16.0, device=DEVICE,
    )
    ecs = read_raw_ec_file(ec_file)

    # top long-range ECs for plotting
    show_ecs = ecs.query("abs(i - j) > 5").iloc[:10]

    from evcouplings_torch.visualize.pairs import plot_contact_map

    plt.figure(figsize=(6, 6))
    plot_contact_map(show_ecs, distmap_intra, distmap_multimer)
    png = os.path.join(out, "contact_map.png")
    plt.savefig(png, dpi=150)
    print("wrote", png)

    from evcouplings_torch.compare.ecs import coupling_scores_compared

    cc = coupling_scores_compared(
        ecs, distmap_intra, distmap_multimer,
        dist_cutoff=5,
        output_file=os.path.join(out, "CouplingScoresCompared.csv"),
    )
    print("\ntop compared couplings:")
    print(cc.head(6).to_string(index=False))
    print("\nprecision of the top-4 long-range ECs: {:.2f}".format(
        cc.iloc[3]["precision"]))

    print("\ntutorial outputs in", out)
    return cc, distmap_intra


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
