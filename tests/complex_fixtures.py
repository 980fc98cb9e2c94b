"""
Fixtures of the complex pipeline, made with numpy alone: two monomer
alignments with planted inter-protein covariation (the generator of
tests/test_complex.py's TestComplexCouplingsEndToEnd), their species
annotation and identity tables, seeded UniProt-to-EMBL and ENA genome
location tables, and seeded two-chain structures in which the planted
inter pairs are in contact. chip_smoke.py imports this file too, so it
imports neither package.
"""

import os

import numpy as np

import compare_fixtures as ss

AA20 = np.array(list("ACDEFGHIKLMNPQRSTVWY"))

# tests/test_complex.py TestComplexCouplingsEndToEnd: (col in monomer 1,
# col in monomer 2, concordance), 0-based; and one planted pair within
# each monomer
N, L = 140, 10
INTER_PLANTED = [(3, 6, 0.90), (7, 2, 0.78), (0, 9, 0.68)]
INTRA_PLANTED_1 = (1, 8, 0.85)
INTRA_PLANTED_2 = (1, 5, 0.80)


def write_monomers(directory):
    """The two monomer alignments of TestComplexCouplingsEndToEnd
    (m1.fasta: T1/1-10 and a0..a139, m2.fasta: T2/1-10 and b0..b139)
    with their annotation (anno1.csv, anno2.csv: one species per paired
    row, "Query" for the targets) and identity tables (id1.csv,
    id2.csv), byte for byte as that generator writes them. Returns the
    two alignment paths."""
    import pandas as pd

    rng = np.random.default_rng(11)

    def random_matrix(seed):
        r = np.random.default_rng(seed)
        mat = np.empty((N + 1, L), dtype="U1")
        for col in range(L):
            probs = r.dirichlet(np.ones(20) * 0.4)
            mat[:, col] = r.choice(AA20, size=N + 1, p=probs)
        return mat

    mat1, mat2 = random_matrix(100), random_matrix(200)

    def plant(mat_i, ci, mat_j, cj, conc, syms):
        state = rng.integers(0, 2, size=N + 1)
        follow = rng.random(N + 1) < conc
        partner = np.where(follow, state, 1 - state)
        (si0, si1), (sj0, sj1) = syms
        mat_i[:, ci] = np.where(state == 0, si0, si1)
        mat_j[:, cj] = np.where(partner == 0, sj0, sj1)

    inter_syms = [(("A", "W"), ("C", "Y")), (("D", "R"), ("E", "K")),
                  (("F", "L"), ("H", "T"))]
    for (ci, cj, conc), syms in zip(INTER_PLANTED, inter_syms):
        plant(mat1, ci, mat2, cj, conc, syms)
    plant(mat1, INTRA_PLANTED_1[0], mat1, INTRA_PLANTED_1[1],
          INTRA_PLANTED_1[2], (("G", "S"), ("N", "Q")))
    plant(mat2, INTRA_PLANTED_2[0], mat2, INTRA_PLANTED_2[1],
          INTRA_PLANTED_2[2], (("I", "V"), ("M", "P")))

    ids_1 = ["a{}/1-{}".format(k, L) for k in range(N)]
    ids_2 = ["b{}/1-{}".format(k, L) for k in range(N)]
    a1 = os.path.join(directory, "m1.fasta")
    a2 = os.path.join(directory, "m2.fasta")
    for path, target, ids, mat in ((a1, "T1/1-{}".format(L), ids_1, mat1),
                                   (a2, "T2/1-{}".format(L), ids_2, mat2)):
        with open(path, "w") as f:
            for name, row in zip([target] + ids, mat):
                f.write(">{}\n{}\n".format(name, "".join(row)))

    species = ["Sp{}".format(k) for k in range(N)]
    for tag, target, ids in (("1", "T1", ids_1), ("2", "T2", ids_2)):
        pd.DataFrame({
            "id": [target + "/1-{}".format(L)] + ids,
            "name": [target] + ids,
            "OS": ["Query"] + species,
        }).to_csv(os.path.join(directory, "anno" + tag + ".csv"),
                  index=False)
        pd.DataFrame({
            "id": [target + "/1-{}".format(L)] + ids,
            "identity_to_query": np.linspace(1.0, 0.3, N + 1),
        }).to_csv(os.path.join(directory, "id" + tag + ".csv"),
                  index=False)
    return a1, a2


def write_genome_tables(path_embl, path_ena, accessions_1, accessions_2,
                        seed=3, threshold=10000):
    """A UniProt-to-EMBL table (`ac <x> genome:cds,...` lines) and an
    ENA genome location table (`cds genome ac start end`, tab-separated)
    for two lists of accessions of equal length: pair k's coding
    sequences share genome g<k>. Most pairs lie 200-2000 bases apart
    (genome_distance pairs them); some lie beyond `threshold`, some
    accessions map to two genomes for one CDS (ambiguous, dropped), some
    have no EMBL entry, and some genomes carry a second, farther copy of
    the second protein (best reciprocal matching picks the closer).
    Returns {"paired", "far", "ambiguous", "missing"}: index sets."""
    rng = np.random.default_rng(seed)
    n = len(accessions_1)
    kind = rng.choice(["paired", "far", "ambiguous", "missing", "copy"],
                      size=n, p=[0.7, 0.08, 0.06, 0.06, 0.1])
    embl, ena = [], []
    for k, (ac1, ac2) in enumerate(zip(accessions_1, accessions_2)):
        if kind[k] == "missing":
            continue
        genome = "g{}".format(k)
        start = int(rng.integers(1000, 900000))
        length1, length2 = (int(x) for x in rng.integers(300, 1500, 2))
        gap = (int(rng.integers(200, 2000)) if kind[k] != "far"
               else threshold + int(rng.integers(1, 50000)))
        cds1, cds2 = "c{}x".format(k), "c{}y".format(k)
        s2 = start + length1 + gap
        mapping1 = "{}:{}".format(genome, cds1)
        if kind[k] == "ambiguous":
            mapping1 += ",{}b:{}".format(genome, cds1)
        embl.append("{} x {}".format(ac1, mapping1))
        embl.append("{} x {}:{}".format(ac2, genome, cds2))
        ena.append((cds1, genome, ac1, start, start + length1))
        # the second protein's gene on the reverse strand in one of three
        ena.append((cds2, genome, ac2, *((s2 + length2, s2) if k % 3 == 0
                                         else (s2, s2 + length2))))
        if kind[k] == "copy":
            # a farther copy of the second protein on the same genome,
            # under another accession of the same protein family
            other = accessions_2[(k + 1) % n]
            cds3 = "c{}z".format(k)
            s3 = s2 + length2 + 5000
            embl.append("{} x {}:{}".format(other, genome, cds3))
            ena.append((cds3, genome, other, s3, s3 + 600))
    with open(path_embl, "w") as f:
        f.write("".join(line + "\n" for line in embl))
    with open(path_ena, "w") as f:
        f.write("".join("\t".join(str(x) for x in row) + "\n"
                        for row in ena))
    return {name: {int(k) for k in np.nonzero(kind == name)[0]}
            for name in ("paired", "far", "ambiguous", "missing")}


def _moved_together(chains, rng, shift=50.0):
    """The chains under one random rotation and translation."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    rot = q * np.sign(np.diag(r))
    if np.linalg.det(rot) < 0:
        rot[:, 0] = -rot[:, 0]
    move = rng.normal(scale=shift / 1.7, size=3)
    return [dict(c, xyz=np.round(c["xyz"] @ rot.T + move, 3))
            for c in chains]


def complex_structure_set(L1, L2, inter, intra_1=(), intra_2=(),
                          uniprot_1="T1", uniprot_2="T2", seed=4):
    """Seeded structures of a heterodimer of two targets of L1 and L2
    residues (numbered from 1): one chain of L1 + L2 residues with the
    planted contacts (0-based (i, j) pairs: inter pairs i in the first,
    j in the second target; intra pairs within each) is cut into chain A
    (the first target) and chain B (the second). 8cpx holds both chains;
    8abb a homodimer of the first target (chains A, C) and one chain of
    the second (B); 8mon the first target alone. Returns ({pdb_id:
    categories}, SIFTS rows)."""
    rng = np.random.default_rng(seed)
    contacts = ([(i, j) for i, j in intra_1]
                + [(L1 + i, L1 + j) for i, j in intra_2]
                + [(i, L1 + j) for i, j in inter])
    whole = ss.make_chain(rng, L1 + L2, contacts=contacts)
    first = ss.sub_chain(whole, 0, L1)
    second = ss.sub_chain(whole, L1, L1 + L2)
    # one rigid motion for both halves keeps the inter contacts
    complex_a, complex_b = _moved_together((first, second), rng)
    a2, b2 = _moved_together((first, second), rng)
    structures = {
        "8cpx": ss.categories([("A", 1, complex_a, 1, 0),
                               ("B", 2, complex_b, 1, 0)]),
        "8abb": ss.categories([("A", 1, a2, 1, 0), ("B", 2, b2, 1, 0),
                               ("C", 1, ss.moved(first, rng, 15.0), 1, 0)]),
        "8mon": ss.categories([("A", 1, ss.moved(first, rng), 1, 10)]),
    }
    rows = [ss.sifts_row("8cpx", "A", uniprot_1, (1, L1), (1, L1)),
            ss.sifts_row("8cpx", "B", uniprot_2, (1, L2), (1, L2)),
            ss.sifts_row("8abb", "A", uniprot_1, (1, L1), (1, L1)),
            ss.sifts_row("8abb", "B", uniprot_2, (1, L2), (1, L2)),
            ss.sifts_row("8abb", "C", uniprot_1, (1, L1), (1, L1)),
            ss.sifts_row("8mon", "A", uniprot_1, (1, L1), (1, L1), 10)]
    return structures, rows


COMPLEX_STAGES = ["align_1", "align_2", "concatenate", "couplings",
                  "compare", "mutate", "fold"]
NO_FIGURES = {"plot_probability_cutoffs": [], "plot_lowest_count": 2,
              "plot_highest_count": 1, "plot_increase": 1}


def write_job_inputs(directory, write_bcif, inter=((3, 6), (7, 2), (0, 9)),
                     intra_1=((1, 8),), intra_2=((1, 5),)):
    """Everything a small complex job reads, under directory: the
    monomers of write_monomers, their annotation tables, the EMBL and
    ENA tables of write_genome_tables for a0..a139 / b0..b139, and the
    structures of complex_structure_set (the planted pairs in contact;
    written with write_bcif, a package's BinaryCIF writer) with their
    SIFTS table. Returns a dict of paths, and the genome tables' kinds."""
    import pandas as pd

    os.makedirs(directory, exist_ok=True)
    a1, a2 = write_monomers(directory)
    embl = os.path.join(directory, "uniprot_to_embl.txt")
    ena = os.path.join(directory, "ena_locations.tsv")
    kinds = write_genome_tables(embl, ena, ["a{}".format(k) for k in range(N)],
                                ["b{}".format(k) for k in range(N)])
    structures, rows = complex_structure_set(L, L, inter, intra_1, intra_2)
    structure_dir = os.path.join(directory, "structures")
    os.makedirs(structure_dir, exist_ok=True)
    for pdb_id, cats in structures.items():
        write_bcif(os.path.join(structure_dir, pdb_id + ".bcif"), cats)
    sifts = os.path.join(directory, "sifts.csv")
    pd.DataFrame(rows).to_csv(sifts, index=False)
    return {"alignments": (a1, a2),
            "annotations": tuple(
                os.path.join(directory, "anno{}.csv".format(k))
                for k in (1, 2)),
            "uniprot_to_embl_table": embl, "ena_genome_location_table": ena,
            "sifts_mapping_table": sifts, "structure_dir": structure_dir,
            "genome_kinds": kinds}


SAMPLE_CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "config", "sample_config_complex.txt")


def sample_job_config(prefix, inputs, iterations=None, device=None,
                      figures=True):
    """config/sample_config_complex.txt with local inputs, and nothing
    else changed but: the alignments (align `complex` over `existing`,
    each monomer's annotation table as override_annotation_file), the
    local tables and structures, compare by a SIFTS lookup (by_alignment
    off: no HMMER), N_eff computed in the concatenate stage, the
    couplings depth (iterations, when given), and, where figures=False
    (a machine without matplotlib), plot settings that select no
    figure. device None: the card."""
    import yaml

    with open(SAMPLE_CONFIG) as f:
        config = yaml.safe_load(f)
    config["global"]["prefix"] = prefix
    if device is not None:
        config["global"]["device"] = device
    for k, stage in enumerate(("align_1", "align_2")):
        config[stage].update(
            alignment_protocol="existing",
            input_alignment=inputs["alignments"][k],
            sequence_id="T{}".format(k + 1),
            override_annotation_file=inputs["annotations"][k])
    config["databases"].update(
        {key: inputs[key] for key in (
            "uniprot_to_embl_table", "ena_genome_location_table",
            "sifts_mapping_table")},
        sifts_sequence_db=None, pdb_mmtf_dir=inputs["structure_dir"])
    config["concatenate"]["compute_num_effective_seqs"] = True
    config["compare"]["by_alignment"] = False
    if not figures:
        config["compare"].update(NO_FIGURES)
    if iterations is not None:
        config["couplings"]["iterations"] = iterations
    return config


def job_config(prefix, inputs, concatenate="best_hit", iterations=12,
               stages=COMPLEX_STAGES, device=None, figures=True):
    """sample_job_config with the concatenation protocol and stages
    given, and what the JAX package's pipeline needs to run the same job:
    focus_mode in the couplings section (its couplings `complex` requires
    the key, which the port defaults to True), integer plot counts (it
    slices the inter ECs by plot_highest_count as a position) and no
    archive. figures=True: three contact maps."""
    config = sample_job_config(prefix, inputs, iterations, device, figures)
    config["stages"] = list(stages)
    config["concatenate"]["protocol"] = concatenate
    config["couplings"]["focus_mode"] = True
    config["management"] = {}
    if figures:
        config["compare"].update(plot_probability_cutoffs=[0.90],
                                 plot_lowest_count=2, plot_highest_count=4,
                                 plot_increase=2)
    return config


def _relative(value, root):
    """An outcfg value with a run's root replaced by a placeholder."""
    if isinstance(value, str):
        return value.replace(root, "<root>")
    if isinstance(value, list):
        return [_relative(v, root) for v in value]
    if isinstance(value, dict):
        return {_relative(k, root): _relative(v, root)
                for k, v in value.items()}
    return value


def assert_same_outputs(got, want, got_root, want_root):
    """Two outcfgs equal apart from their runs' roots, and every file
    they name equal as text with each root replaced (figures, .pdf, only
    have to exist). Returns the number of files compared."""
    assert _relative(got, got_root) == _relative(want, want_root)
    compared = 0
    for key, value in got.items():
        if not (isinstance(value, str) and os.path.isfile(value)):
            continue
        if value.endswith(".pdf"):
            assert os.path.isfile(want[key]), key
            continue
        with open(value) as a, open(want[key]) as b:
            assert (a.read().replace(got_root, "<root>")
                    == b.read().replace(want_root, "<root>")), key
        compared += 1
    return compared
