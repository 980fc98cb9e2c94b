"""
Structure prediction with CNSsolve 1.21 (distance geometry +
simulated annealing); port of evcouplings_tpu/fold/cns.py, host code as
there: the .seq file writer, the input-script renderers, the restraint
formatters and cns_dgsa_fold.

CNS input-script templates: the jinja2-templated .inp protocol scripts
(generate_seq / generate_extended / dg_sa / generate_easy /
model_minimize) are the port's own copies of the JAX package's, in
cns_templates/ (see cns_templates/README.md); user overrides are loaded
from `cns_template_dir` (parameter) or the EVCOUPLINGS_CNS_TEMPLATE_DIR
environment variable, which take precedence over the packaged directory.
"""

import os
from os import path

import pandas as pd

from evcouplings_torch.fold.restraints import (
    ec_dist_restraints,
    secstruct_angle_restraints,
    secstruct_dist_restraints,
)
from evcouplings_torch.fold.tools import run_cns
from evcouplings_torch.utils.config import InvalidParameterError
from evcouplings_torch.utils.constants import AA1_to_AA3
from evcouplings_torch.utils.helpers import render_template
from evcouplings_torch.utils.system import (
    ResourceError,
    create_prefix_folders,
    temp,
    valid_file,
    verify_resources,
)

_PACKAGED_TEMPLATE_DIR = path.join(
    path.dirname(path.abspath(__file__)), "cns_templates"
)


def cns_seq_file(sequence, output_file=None, residues_per_line=16):
    """Write a CNS .seq file (three-letter codes, fixed residues per
    line); returns the file path."""
    if output_file is None:
        output_file = temp()

    try:
        three_letter = [AA1_to_AA3[aa] for aa in sequence]
    except KeyError as e:
        raise InvalidParameterError(
            "Invalid amino acid could not be mapped"
        ) from e

    with open(output_file, "w") as f:
        for start in range(0, len(three_letter), residues_per_line):
            chunk = three_letter[start: start + residues_per_line]
            f.write(" ".join(chunk) + "\n")

    return output_file


def _cns_template_file(template_name, template_dir=None):
    """Resolve the path of a CNS .inp template (see module docstring
    for the search order)."""
    search_dirs = [
        template_dir,
        os.environ.get("EVCOUPLINGS_CNS_TEMPLATE_DIR"),
        _PACKAGED_TEMPLATE_DIR,
    ]

    for rank, d in enumerate(search_dirs):
        if d is None:
            continue
        candidate = path.join(d, "{}.inp".format(template_name))
        if valid_file(candidate):
            return candidate
        if rank == 0:
            # an EXPLICIT template_dir without this template silently
            # running the packaged default would mislead the user
            # into believing their override is active
            import warnings

            warnings.warn(
                "template_dir {} has no usable {}.inp — falling back "
                "to the packaged template".format(d, template_name),
                RuntimeWarning,
            )

    raise ResourceError(
        "CNS template '{}.inp' not found. The CNS protocol input "
        "scripts are part of the CNSsolve distribution; place jinja2-"
        "templated copies in {} or set EVCOUPLINGS_CNS_TEMPLATE_DIR "
        "(see cns_templates/README.md).".format(
            template_name, _PACKAGED_TEMPLATE_DIR
        )
    )


def _cns_render_template(template_name, template_dir=None, **variables):
    """Render a CNS .inp template with the given variable mapping."""
    return render_template(
        _cns_template_file(template_name, template_dir), variables
    )


def cns_mtf_inp(seq_infile, mtf_outfile, first_index=1,
                disulfide_bridges=None, template_dir=None):
    """Input script generating a molecular topology file (.mtf) from a
    .seq file. disulfide_bridges may be (i, j) tuples or a DataFrame
    with i/j/A_i/A_j columns (cys-cys rows are selected)."""
    if disulfide_bridges is None:
        disulfides = []
    else:
        if isinstance(disulfide_bridges, pd.DataFrame):
            cys_rows = disulfide_bridges[
                (disulfide_bridges.A_i == "C")
                & (disulfide_bridges.A_j == "C")
            ]
            pair_list = zip(cys_rows.i, cys_rows.j)
        else:
            pair_list = disulfide_bridges

        # template needs a running index per disulfide entry
        disulfides = [
            (number, i, j)
            for number, (i, j) in enumerate(pair_list, start=1)
        ]

    return _cns_render_template(
        "generate_seq", template_dir,
        renumber_index=first_index,
        sequence_infile=seq_infile,
        mtf_outfile=mtf_outfile,
        disulfide_list=disulfides,
    )


def cns_extended_inp(mtf_infile, pdb_outfile, template_dir=None):
    """Input script generating an extended-conformation PDB from a
    topology file."""
    return _cns_render_template(
        "generate_extended", template_dir,
        mtf_infile=mtf_infile,
        pdb_outfile=pdb_outfile,
    )


def cns_dgsa_inp(pdb_infile, mtf_infile, outfile_prefix,
                 ec_pair_tbl_infile, ss_dist_tbl_infile,
                 ss_angle_tbl_infile, num_structures=20,
                 log_level="quiet", template_dir=None):
    """Input script folding an extended structure by distance geometry
    + simulated annealing under EC and secondary-structure
    restraints."""
    return _cns_render_template(
        "dg_sa", template_dir,
        pdb_infile=pdb_infile,
        mtf_infile=mtf_infile,
        num_structures=num_structures,
        ec_pair_tbl_infile=ec_pair_tbl_infile,
        ss_dist_tbl_infile=ss_dist_tbl_infile,
        ss_angle_tbl_infile=ss_angle_tbl_infile,
        pdb_outfile_basename=outfile_prefix,
        hbond_tbl_infile="",
        log_level=log_level,
        md_cool_noe_scale_factor=5,
        ss_dist_noe_avg_mode="cent",
        ec_pair_noe_avg_mode="cent",
    )


def cns_generate_easy_inp(pdb_infile, pdb_outfile, mtf_outfile,
                          template_dir=None):
    """Input script adding hydrogens to a model (generate_easy
    protocol)."""
    return _cns_render_template(
        "generate_easy", template_dir,
        pdb_infile=pdb_infile,
        mtf_outfile=mtf_outfile,
        pdb_outfile=pdb_outfile,
        hydrogen_flag="true",
        pdb_o_format="false",
        ile_cd_becomes="",   # default: CD1
        ot1_becomes="",      # default: O
        ot2_becomes="",      # default: OXT
    )


def cns_minimize_inp(pdb_infile, mtf_infile, pdb_outfile, num_cycles=5,
                     template_dir=None):
    """Input script energy-minimizing a model."""
    return _cns_render_template(
        "model_minimize", template_dir,
        pdb_infile=pdb_infile,
        mtf_infile=mtf_infile,
        pdb_outfile=pdb_outfile,
        num_cycles=num_cycles,
        use_cryst="false",
        space_group="",
    )


def _cns_atom_selection(resid, atom):
    """One CNS atom selection term: (resid N and name X)."""
    return f"(resid {resid} and name {atom})"


def cns_dist_restraint(resid_i, atom_i, resid_j, atom_j, dist, lower,
                       upper, weight=None, comment=None):
    """CNS distance restraint line (assign ... dist lower upper)."""
    selections = " ".join([
        _cns_atom_selection(resid_i, atom_i),
        _cns_atom_selection(resid_j, atom_j),
    ])
    tail = "" if weight is None else f"weight {weight} "
    tail += "" if comment is None else f"! {comment}"
    return f"assign {selections}  {dist} {lower} {upper} {tail}"


def cns_dihedral_restraint(resid_i, atom_i, resid_j, atom_j,
                           resid_k, atom_k, resid_l, atom_l,
                           energy_constant, degrees, range, exponent,
                           comment=None):
    """CNS dihedral restraint line over four atoms."""
    selections = " ".join([
        _cns_atom_selection(resid_i, atom_i),
        _cns_atom_selection(resid_j, atom_j),
        _cns_atom_selection(resid_k, atom_k),
        _cns_atom_selection(resid_l, atom_l),
    ])
    values = f"{energy_constant} {degrees} {range} {exponent}"
    tail = "" if comment is None else f" ! {comment}"
    return f"assign {selections}  {values}{tail}"


def cns_dgsa_fold(residues, ec_pairs, prefix, config_file=None,
                  secstruct_column="sec_struct_3state",
                  num_structures=20, min_cycles=5, log_level=None,
                  binary="cns", template_dir=None):
    """Full dg/sa folding run: restraints -> topology -> extended
    structure -> dg_sa -> hydrogens + minimization per model.

    Returns {model name: path} of the final minimized models.
    """
    def _run_inp(inp_str, output_prefix):
        with open(output_prefix + ".inp", "w") as f:
            f.write(inp_str)

        # the per-step .log is always written (the only diagnosable
        # artifact when CNS aborts a protocol script yet exits 0);
        # log_level only controls CNS verbosity
        run_cns(
            inp_str, log_file=output_prefix + ".log", binary=binary
        )

    create_prefix_folders(prefix)

    # caller-supplied paths must be pinned BEFORE the chdir below, or
    # relative config/binary/template paths resolve against the fold
    # directory instead of the launch directory
    if config_file is not None:
        config_file = path.abspath(config_file)
    if template_dir is not None:
        template_dir = path.abspath(template_dir)
    if binary is not None and os.sep in binary:
        binary = path.abspath(binary)

    # CNS cannot handle long paths: run inside the working directory
    # with short relative file names
    dir_, rootname = path.split(prefix)
    cwd = os.getcwd()

    if dir_ != "":
        os.chdir(dir_)

    try:
        ec_tbl = rootname + "_couplings.tbl"
        ss_dist_tbl = rootname + "_ss_distance.tbl"
        ss_angle_tbl = rootname + "_ss_angle.tbl"

        ec_dist_restraints(
            ec_pairs, ec_tbl, cns_dist_restraint, config_file
        )
        secstruct_dist_restraints(
            residues, ss_dist_tbl, cns_dist_restraint,
            config_file, secstruct_column,
        )
        secstruct_angle_restraints(
            residues, ss_angle_tbl, cns_dihedral_restraint,
            config_file, secstruct_column,
        )

        seq = "".join(residues.A_i)
        seq_file = rootname + ".seq"
        cns_seq_file(seq, seq_file)

        mtf_file = rootname + ".mtf"
        _run_inp(
            cns_mtf_inp(
                seq_file, mtf_file, first_index=residues.i.min(),
                disulfide_bridges=None, template_dir=template_dir,
            ),
            mtf_file,
        )
        # CNS exits 0 even when a protocol script aborts: verify each
        # intermediate product so a broken setup fails HERE with the
        # step's .log at hand, not as a silent zero-model fold
        verify_resources(
            "CNS topology generation produced no output "
            "(see {}.log)".format(mtf_file), mtf_file,
        )

        extended_file = rootname + "_extended.pdb"
        _run_inp(
            cns_extended_inp(
                mtf_file, extended_file, template_dir=template_dir
            ),
            extended_file,
        )
        verify_resources(
            "CNS extended-structure generation produced no output "
            "(see {}.log)".format(extended_file), extended_file,
        )

        dgsa_log_level = log_level if log_level is not None else "quiet"
        _run_inp(
            cns_dgsa_inp(
                extended_file, mtf_file, rootname,
                ec_tbl, ss_dist_tbl, ss_angle_tbl,
                num_structures=num_structures,
                log_level=dgsa_log_level,
                template_dir=template_dir,
            ),
            rootname + "_dgsa",
        )

        # add hydrogens + minimize every generated candidate
        final_models = {}
        for i in range(1, num_structures + 1):
            input_root = "{}_{}".format(rootname, i)
            input_model = input_root + ".pdb"

            if not valid_file(input_model):
                continue

            easy_pdb = input_root + "_h.pdb"
            easy_mtf = input_root + "_h.mtf"
            _run_inp(
                cns_generate_easy_inp(
                    input_model, easy_pdb, easy_mtf,
                    template_dir=template_dir,
                ),
                input_root + "_h",
            )

            min_pdb = input_root + "_hMIN.pdb"
            _run_inp(
                cns_minimize_inp(
                    easy_pdb, easy_mtf, min_pdb,
                    num_cycles=min_cycles,
                    template_dir=template_dir,
                ),
                input_root + "_hMIN",
            )

            if valid_file(min_pdb):
                final_models[min_pdb] = path.join(dir_, min_pdb)
    finally:
        os.chdir(cwd)

    return final_models
