"""
Fixtures of the compare stage, made with numpy alone: seeded protein
structures and SIFTS tables, and the comparison of two runs' compare
artifacts. chip_smoke.py imports this file too, so it imports neither
package.

A chain is a self-avoiding walk of residue centres 6.5 A apart (no two
centres within 6 A), each residue N, CA, C, O and 0-10 side-chain atoms
within 1.5 A of its centre: residues in general position, with ragged
atom counts. Planted contacts move a residue next to another (3.5 A
between their first atoms). Coordinates are rounded to the 3 decimals
that BinaryCIF's fixed-point columns and PDB text keep.
"""

import os

import numpy as np

AA3 = ("ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS",
       "ILE", "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP",
       "TYR", "VAL")
BACKBONE = ("N", "CA", "C", "O")
SIDE_CHAIN = ("CB", "CG", "CD", "CE", "CZ", "NE", "NH1", "NH2", "OD1",
              "OE1")


def make_chain(rng, n_res, contacts=(), single_atom=None):
    """One chain of n_res residues: {"counts", "names", "xyz", "comp"}.

    contacts: 0-based (a, b) residue pairs; b is moved so that its first
    atom lies 3.5 A from a's first atom. single_atom: a residue that
    keeps only its CA.
    """
    centres = np.zeros((n_res, 3))
    for k in range(1, n_res):
        for _ in range(1000):
            step = rng.normal(size=3)
            c = centres[k - 1] + 6.5 * step / np.linalg.norm(step)
            if np.linalg.norm(centres[:k] - c, axis=1).min() > 6.0:
                break
        centres[k] = c

    counts = 4 + rng.integers(0, len(SIDE_CHAIN) + 1, size=n_res)
    names = [list(BACKBONE + SIDE_CHAIN[:c - 4]) for c in counts]
    if single_atom is not None:
        counts[single_atom] = 1
        names[single_atom] = ["CA"]
    offsets = rng.normal(scale=0.8, size=(int(counts.sum()), 3))
    norms = np.linalg.norm(offsets, axis=1, keepdims=True)
    offsets *= np.minimum(1.0, 1.5 / np.maximum(norms, 1e-12))
    xyz = np.repeat(centres, counts, axis=0) + offsets

    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for a, b in contacts:
        u = rng.normal(size=3)
        target = xyz[first[a]] + 3.5 * u / np.linalg.norm(u)
        xyz[first[b]:first[b] + counts[b]] += target - xyz[first[b]]

    return {"counts": counts, "names": names, "xyz": np.round(xyz, 3),
            "comp": [AA3[k] for k in rng.integers(0, 20, size=n_res)]}


def sub_chain(chain, start, stop):
    """Residues start..stop-1 (0-based) of a chain."""
    first = np.concatenate([[0], np.cumsum(chain["counts"])])
    return {"counts": chain["counts"][start:stop],
            "names": chain["names"][start:stop],
            "xyz": chain["xyz"][first[start]:first[stop]],
            "comp": chain["comp"][start:stop]}


def moved(chain, rng, shift=50.0, jitter=0.0):
    """The chain under a random rotation and a translation of about
    `shift` A, with optional Gaussian jitter of every atom."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    rot = q * np.sign(np.diag(r))
    if np.linalg.det(rot) < 0:
        rot[:, 0] = -rot[:, 0]
    xyz = chain["xyz"] @ rot.T + rng.normal(scale=shift / 1.7, size=3)
    if jitter:
        xyz = xyz + rng.normal(scale=jitter, size=xyz.shape)
    return dict(chain, xyz=np.round(xyz, 3))


def atom_ranges(chain):
    """(n_res, 2) inclusive atom index ranges of a chain."""
    last = np.cumsum(chain["counts"]) - 1
    return np.stack([last - chain["counts"] + 1, last], axis=1)


def categories(chains):
    """BinaryCIF categories of one model: chains is a list of
    (chain_id, entity_id, chain, first_seq_id, auth_offset); residue k
    has label_seq_id first_seq_id + k and auth_seq_id that plus
    auth_offset. Each chain gets a helix on its residues 2-5 and a strand
    on 8-10 (label numbering) in _struct_conf."""
    cols = {k: [] for k in (
        "pdbx_PDB_model_num", "group_PDB", "id", "type_symbol",
        "label_atom_id", "auth_atom_id", "label_alt_id", "label_comp_id",
        "auth_comp_id", "label_asym_id", "auth_asym_id", "label_entity_id",
        "label_seq_id", "auth_seq_id", "pdbx_PDB_ins_code")}
    xyz = []
    conf = {k: [] for k in ("conf_type_id", "id", "beg_label_asym_id",
                            "beg_label_seq_id", "end_label_asym_id",
                            "end_label_seq_id")}
    for chain_id, entity, chain, first_seq, auth_offset in chains:
        for k, (names, comp) in enumerate(zip(chain["names"],
                                              chain["comp"])):
            seq = first_seq + k
            for name in names:
                for key, value in (
                        ("pdbx_PDB_model_num", 1), ("group_PDB", "ATOM"),
                        ("type_symbol", name[0]), ("label_atom_id", name),
                        ("auth_atom_id", name), ("label_alt_id", ""),
                        ("label_comp_id", comp), ("auth_comp_id", comp),
                        ("label_asym_id", chain_id),
                        ("auth_asym_id", chain_id),
                        ("label_entity_id", str(entity)),
                        ("label_seq_id", seq),
                        ("auth_seq_id", seq + auth_offset),
                        ("pdbx_PDB_ins_code", "")):
                    cols[key].append(value)
        xyz.append(chain["xyz"])
        for kind, sse_id, beg, end in (("HELX_P", "H", 2, 5),
                                       ("STRN", "S", 8, 10)):
            for key, value in (("conf_type_id", kind),
                               ("id", sse_id + chain_id),
                               ("beg_label_asym_id", chain_id),
                               ("beg_label_seq_id", first_seq + beg - 1),
                               ("end_label_asym_id", chain_id),
                               ("end_label_seq_id", first_seq + end - 1)):
                conf[key].append(value)
    xyz = np.concatenate(xyz)
    n = len(xyz)
    cols["id"] = np.arange(1, n + 1)
    for key in ("pdbx_PDB_model_num", "label_seq_id", "auth_seq_id"):
        cols[key] = np.asarray(cols[key])
    cols.update({"Cartn_x": xyz[:, 0], "Cartn_y": xyz[:, 1],
                 "Cartn_z": xyz[:, 2], "occupancy": np.ones(n),
                 "B_iso_or_equiv": np.full(n, 20.0),
                 "pdbx_formal_charge": np.zeros(n, dtype=int)})
    for key in ("beg_label_seq_id", "end_label_seq_id"):
        conf[key] = np.asarray(conf[key])
    return {"_atom_site": cols, "_struct_conf": conf}


def sifts_row(pdb_id, chain, uniprot_ac, resseq, uniprot, auth_offset=0):
    """One SIFTS segment: seqres resseq=(start, end) <-> uniprot=(start,
    end)."""
    return {"pdb_id": pdb_id, "pdb_chain": chain, "uniprot_ac": uniprot_ac,
            "resseq_start": resseq[0], "resseq_end": resseq[1],
            "coord_start": str(resseq[0] + auth_offset),
            "coord_end": str(resseq[1] + auth_offset),
            "uniprot_start": uniprot[0], "uniprot_end": uniprot[1]}


def small_structure_set(seed=5, first_uniprot=11, n_res=18,
                        contacts=((2, 9), (4, 15), (6, 12))):
    """Three structures of an n_res target numbered from first_uniprot
    (the pipeline tests' synthetic: TARGET_SEQ/11-28, whose planted
    column pairs are `contacts`, 0-based): 1aaa one full chain; 2bbb a
    homodimer (chains A, B) of target residues 2-17, mapped in two
    segments with one residue unmapped; 3ccc one chain of residues 4-18.
    Returns ({pdb_id: categories}, SIFTS rows)."""
    rng = np.random.default_rng(seed)
    base = make_chain(rng, n_res, contacts=contacts, single_atom=n_res - 1)
    u0 = first_uniprot
    dimer = sub_chain(base, 1, n_res - 1)
    partner = moved(dimer, rng, shift=10.0)
    structures = {
        "1aaa": categories([("A", 1, moved(base, rng), 1, 100)]),
        "2bbb": categories([("A", 1, moved(dimer, rng, jitter=0.05), 1, 0),
                            ("B", 1, partner, 1, 0)]),
        "3ccc": categories([("A", 1, moved(sub_chain(base, 3, n_res), rng),
                             3, 0)]),
    }
    m = n_res - 2
    rows = [sifts_row("1aaa", "A", "TARGET_SEQ", (1, n_res),
                      (u0, u0 + n_res - 1), 100)]
    for chain in ("A", "B"):
        rows += [sifts_row("2bbb", chain, "TARGET_SEQ", (1, 7),
                           (u0 + 1, u0 + 7)),
                 sifts_row("2bbb", chain, "TARGET_SEQ", (9, m),
                           (u0 + 9, u0 + m))]
    rows.append(sifts_row("3ccc", "A", "TARGET_SEQ", (3, n_res - 1),
                          (u0 + 3, u0 + n_res - 1)))
    return structures, rows


def target_chain(n_res, contacts, rng):
    """The chain every structure of full_structure_set is cut from: all
    heavy atoms, the planted contacts, residue n_res // 2 a single atom."""
    return make_chain(rng, n_res, contacts=contacts, single_atom=n_res // 2)


def full_structure_set(n_res, contacts, uniprot_ac="TARGET", seed=8):
    """Ten structures of an n_res target numbered from 1, built from one
    seeded chain with the planted contacts (0-based pairs): single
    chains, homodimers (chains A and B), sub-ranges, a chain mapped in
    two segments, a chain literally named "NA", and 1t10, whose file is
    to be written truncated (it fails to load and is skipped).
    Returns ({pdb_id: categories}, SIFTS rows)."""
    rng = np.random.default_rng(seed)
    base = target_chain(n_res, contacts, rng)
    n = n_res
    a, b, c = n // 8, n // 5, 3 * n // 4       # sub-range bounds
    gap = n // 2 - 2                            # two-segment split

    def dimer(start, stop):
        one = moved(sub_chain(base, start, stop), rng)
        return [("A", 1, one, 1, 0), ("B", 1, moved(one, rng, 12.0), 1, 0)]

    layout = {
        # pdb_id: (chains as categories() takes them, [(chain,
        # resseq, uniprot)] SIFTS segments)
        "1t01": ([("A", 1, moved(base, rng), 1, 0)],
                 [("A", (1, n), (1, n))]),
        "1t02": (dimer(0, n),
                 [("A", (1, n), (1, n)), ("B", (1, n), (1, n))]),
        "1t03": ([("A", 1, moved(sub_chain(base, 0, c), rng), 1, 0)],
                 [("A", (1, c), (1, c))]),
        "1t04": ([("A", 1, moved(sub_chain(base, b, n), rng), 1, 200)],
                 [("A", (1, n - b), (b + 1, n))]),
        "1t05": (dimer(a, n - a),
                 [(ch, (1, n - 2 * a), (a + 1, n - a)) for ch in "AB"]),
        "1t06": ([("A", 1, moved(base, rng, jitter=0.05), 1, 0)],
                 [("A", (1, gap), (1, gap)),
                  ("A", (gap + 3, n), (gap + 3, n))]),
        "1t07": ([("NA", 1, moved(base, rng), 1, 0)],
                 [("NA", (1, n), (1, n))]),
        "1t08": (dimer(b, c),
                 [(ch, (1, c - b), (b + 1, c)) for ch in "AB"]),
        "1t09": ([("A", 1, moved(base, rng, jitter=0.1), 1, 0)],
                 [("A", (1, n), (1, n))]),
        "1t10": ([("A", 1, moved(base, rng), 1, 0)],
                 [("A", (1, n), (1, n))]),
    }
    structures, rows = {}, []
    for pdb_id, (chains, segments) in layout.items():
        structures[pdb_id] = categories(chains)
        offsets = {ch[0]: ch[4] for ch in chains}
        rows += [sifts_row(pdb_id, chain, uniprot_ac, resseq, uniprot,
                           offsets[chain])
                 for chain, resseq, uniprot in segments]
    return structures, rows


# distance columns of the compared EC tables; distances are float64 on
# both sides of every comparison and are held to DIST_ATOL A
DIST_ATOL = 1e-9
DIST_COLUMNS = ("dist", "dist_intra", "dist_multimer")


def outcfg_files(value):
    """The file paths one outcfg value names (a path, or a list or a
    {path: info} dict of paths)."""
    if value is None:
        return []
    return [value] if isinstance(value, str) else list(value)


def assert_same_compare_file(got, want, zero_atol=0.0):
    """One compare artifact against another: PDB files and Pymol scripts
    byte for byte; CSVs equal except the distance columns, and distance
    matrices, within DIST_ATOL, except that where a matrix of `got` holds
    0 (a residue against itself) `want` may be up to zero_atol from it
    (the JAX package's GEMM form leaves ~1e-6 A there). Returns the
    largest distance difference held to DIST_ATOL."""
    import pandas as pd

    if got.endswith((".pdb", ".pml")):
        with open(got, "rb") as a, open(want, "rb") as b:
            assert a.read() == b.read(), got
        return 0.0
    worst = 0.0
    if got.endswith(".npy"):
        a, b = np.load(got), np.load(want)
        assert a.shape == b.shape, got
        assert np.array_equal(np.isnan(a), np.isnan(b)), got
        err = np.abs(np.nan_to_num(a) - np.nan_to_num(b))
        zero = a == 0.0
        assert np.all(err[zero] <= zero_atol), got
        worst = float(err[~zero].max(initial=0.0))
    else:
        a, b = pd.read_csv(got), pd.read_csv(want)
        assert list(a.columns) == list(b.columns), got
        for col in DIST_COLUMNS:
            if col in a:
                x = a.pop(col).to_numpy(float)
                y = b.pop(col).to_numpy(float)
                assert np.array_equal(np.isnan(x), np.isnan(y)), (got, col)
                worst = max(worst, float(
                    np.nan_to_num(np.abs(x - y)).max(initial=0.0)))
        pd.testing.assert_frame_equal(a, b, check_exact=True)
    assert worst <= DIST_ATOL, (got, worst)
    return worst


def assert_same_compare_artifacts(got, want, got_root, want_root,
                                  zero_atol=0.0):
    """Two compare outcfgs: equal keys, the same files relative to each
    root, each file held as assert_same_compare_file holds it; figures
    (.pdf) only have to exist. The distance-map prefixes
    (distmap_monomer, distmap_multimer) are compared as their .csv and
    .npy. Returns (files compared, largest distance difference)."""
    assert set(got) == set(want), set(got) ^ set(want)
    compared, worst = 0, 0.0
    for key in sorted(got):
        rel = sorted(os.path.relpath(f, got_root)
                     for f in outcfg_files(got[key]))
        assert rel == sorted(os.path.relpath(f, want_root)
                             for f in outcfg_files(want[key])), key
        if isinstance(got[key], dict):
            assert {os.path.relpath(k, got_root): v
                    for k, v in got[key].items()} == \
                {os.path.relpath(k, want_root): v
                 for k, v in want[key].items()}, key
        if not key.endswith(("_file", "_files")):
            rel = [r + ext for r in rel for ext in (".csv", ".npy")]
        for r in rel:
            g, w = os.path.join(got_root, r), os.path.join(want_root, r)
            if r.endswith(".pdf"):
                assert os.path.isfile(g) and os.path.isfile(w), r
                continue
            worst = max(worst, assert_same_compare_file(g, w, zero_atol))
            compared += 1
    return compared, worst
