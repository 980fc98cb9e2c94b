"""
Distance / dihedral restraint generation from evolutionary couplings
and secondary-structure predictions (port of
evcouplings_tpu/fold/restraints.py): secstruct_dist_restraints,
secstruct_angle_restraints, ec_dist_restraints, docking_restraints; the
parametrization is the port's copy of cns_templates/restraints.yml and
haddock_restraints.yml.
"""

from pathlib import Path

from evcouplings_torch.utils.config import read_config_file
from evcouplings_torch.utils.constants import AA1_to_AA3
from evcouplings_torch.utils.system import verify_resources

_TEMPLATE_DIR = Path(__file__).parent / "cns_templates"

# packaged default parametrization per restraint family
_DEFAULT_CONFIG = {
    "folding": "restraints.yml",
    "docking": "haddock_restraints.yml",
}


def _restraint_config(kind, config_file):
    """The restraint parametrization for `kind` ("folding"/"docking"):
    the caller's file if given, else the packaged default."""
    if config_file is None:
        config_file = str(_TEMPLATE_DIR / _DEFAULT_CONFIG[kind])

    verify_resources(
        "Folding config file does not exist or is empty", config_file
    )
    return read_config_file(config_file)


def _pair_label(aa_i, aa_j):
    """Three-letter comment tag for a residue pair ("ALA VAL")."""
    return AA1_to_AA3[aa_i] + " " + AA1_to_AA3[aa_j]


def _missing_cb(aa, atom):
    """Glycine has no CB, so a CB restraint on it must be dropped."""
    return atom == "CB" and aa == "G"


def secstruct_dist_restraints(residues, output_file, restraint_formatter,
                              config_file=None,
                              secstruct_column="sec_struct_3state"):
    """Write .tbl distance restraints implied by contiguous secondary-
    structure elements (helix/strand), per sequence separation.

    residues must contain columns i, A_i, and the secondary-structure
    column (H/E/C).
    """
    params = _restraint_config("folding", config_file)[
        "secstruct_distance_restraints"
    ]
    weight = params["weight"]

    state = dict(zip(residues.i, residues[secstruct_column]))
    amino = dict(zip(residues.i, residues.A_i))
    first, last = residues.i.min(), residues.i.max()

    def stretch_is(char, lo, hi):
        # the whole (inclusive) position range carries the same state
        return all(state[p] == char for p in range(lo, hi + 1))

    lines = []
    # strand restraints first, then helix, each ordered by separation —
    # the reference's file layout
    for char, name in [("E", "strand"), ("H", "helix")]:
        for separation, atom_pairs in sorted(params[name].items()):
            for i in range(first, last - separation + 1):
                j = i + separation
                if not stretch_is(char, i, j):
                    continue
                for (atom_i, atom_j), (dist, spread) in \
                        atom_pairs.items():
                    if _missing_cb(amino[i], atom_i) or \
                            _missing_cb(amino[j], atom_j):
                        continue
                    lines.append(restraint_formatter(
                        i, atom_i, j, atom_j,
                        dist=dist, lower=spread, upper=spread,
                        weight=weight,
                        comment=_pair_label(amino[i], amino[j]),
                    ))

    with open(output_file, "w") as handle:
        handle.write("".join(line + "\n" for line in lines))


# backbone atom sequences defining the phi/psi dihedrals at position i
# (offset relative to i, atom name)
_DIHEDRAL_ATOMS = {
    "phi": ((0, "C"), (1, "N"), (1, "CA"), (1, "C")),
    "psi": ((0, "N"), (0, "CA"), (0, "C"), (1, "N")),
}


def secstruct_angle_restraints(residues, output_file,
                               restraint_formatter, config_file=None,
                               secstruct_column="sec_struct_3state"):
    """Write .tbl phi/psi dihedral restraints for consecutive
    identical helix/strand states."""
    params = _restraint_config("folding", config_file)[
        "secstruct_angle_restraints"
    ]
    state = dict(zip(residues.i, residues[secstruct_column]))
    first, last = residues.i.min(), residues.i.max()

    def dihedral(pos, angle, element):
        spec = [
            part
            for offset, atom in _DIHEDRAL_ATOMS[angle]
            for part in (pos + offset, atom)
        ]
        return restraint_formatter(*spec, **params[element][angle])

    lines = []
    # upper bound last - 1 (exclusive) skips the final adjacent pair
    # (last-1, last); kept deliberately — exact restraint-file parity
    # with the reference, whose loop has the same bound (reference
    # fold/restraints.py:222)
    for i in range(first, last - 1):
        element = {"H": "helix", "E": "strand"}.get(state[i])
        if element is not None and state[i + 1] == state[i]:
            lines.append(dihedral(i, "phi", element))
            lines.append(dihedral(i, "psi", element))

    with open(output_file, "w") as handle:
        handle.write("".join(line + "\n" for line in lines))


# EC pair restraint families, in emission order
_EC_RESTRAINT_TYPES = ("c_alpha", "c_beta", "tertiary_atom")


def ec_dist_restraints(ec_pairs, output_file, restraint_formatter,
                       config_file=None):
    """Write .tbl distance restraints for EC pairs (columns i, j, A_i,
    A_j), one per enabled restraint type (CA / CB / side-chain atom)."""
    params = _restraint_config("folding", config_file)[
        "pair_distance_restraints"
    ]

    lines = []
    for ec in ec_pairs.itertuples(index=False):
        for family in _EC_RESTRAINT_TYPES:
            fam = params[family]
            if not fam["use"]:
                continue

            if isinstance(fam["weight"], str):
                raise NotImplementedError(
                    "Restraint weighting functions not yet "
                    "implemented: " + fam["weight"]
                )

            # atom selection: a per-residue-type map, or one fixed
            # atom name for both partners
            atoms = fam["atoms"]
            if isinstance(atoms, dict):
                atom_i, atom_j = atoms[ec.A_i], atoms[ec.A_j]
            else:
                atom_i = atom_j = atoms

            if _missing_cb(ec.A_i, atom_i) or \
                    _missing_cb(ec.A_j, atom_j):
                continue

            lines.append(restraint_formatter(
                ec.i, atom_i, ec.j, atom_j,
                dist=fam["dist"], lower=fam["lower"],
                upper=fam["upper"], weight=fam["weight"],
                comment=_pair_label(ec.A_i, ec.A_j),
            ))

    with open(output_file, "w") as handle:
        handle.write("".join(line + "\n" for line in lines))


def docking_restraints(ec_pairs, output_file, restraint_formatter,
                       config_file=None):
    """Write docking restraints for inter-segment EC pairs (columns i,
    j, A_i, A_j, segment_i, segment_j); segment A_1 -> chain A etc."""
    params = _restraint_config("docking", config_file)[
        "docking_restraints"
    ]

    lines = [
        restraint_formatter(
            ec.i, ec.segment_i[0], ec.j, ec.segment_j[0],
            dist=params["dist"], lower=params["lower"],
            upper=params["upper"],
        )
        for ec in ec_pairs.itertuples(index=False)
    ]
    with open(output_file, "w") as handle:
        handle.write("".join(line + "\n" for line in lines))
