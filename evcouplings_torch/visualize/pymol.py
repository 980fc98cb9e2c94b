"""
Pymol .pml script generation for mapping properties onto 3D structures
(the part of evcouplings_tpu/visualize/pymol.py the couplings and mutate
stages use): pymol_pair_lines, pymol_mapping. Pure text generation, no
Pymol dependency. The secondary-structure script waits for the fold
stage.
"""

import pandas as pd


def _write_pymol_commands(commands, output_file):
    """Write command lines to a path or writeable handle."""
    cmd_str = "\n".join(commands) + "\n"
    if hasattr(output_file, "write"):
        output_file.write(cmd_str)
    else:
        with open(output_file, "w") as f:
            f.write(cmd_str)


def _chain_clause(chain):
    """The " and chain '<c>'" selector suffix, or "" without a chain."""
    return "" if chain is None else " and chain '{}'".format(chain)


def _styled(row, key):
    """True when the optional style column exists and holds a value."""
    return key in row and pd.notnull(row[key])


def _pymol_color(hex_color):
    """Pymol spells hex colors 0xrrggbb."""
    return hex_color.replace("#", "0x")


def pymol_pair_lines(pairs, output_file, chain=None, atom="CA",
                     pair_prefix="ec"):
    """Draw distance lines between residue pairs (columns i, j).

    Optional columns color / dash_radius / dash_gap / dash_length style
    each line; chain may be a single chain name or a {segment: chain}
    dict used with segment_i / segment_j columns; chain_i / chain_j
    columns override both.
    """
    def endpoint(row, column):
        # chain resolution precedence: explicit chain_<col> column,
        # then per-segment dict / fixed name, else none
        if "chain_" + column in row:
            on = row["chain_" + column]
        elif isinstance(chain, dict):
            on = chain[row["segment_" + column]]
        else:
            on = chain

        prefix = "" if on is None else "chain '{}' and ".format(on)
        return "{}resid {} and name {}".format(
            prefix, row[column], atom
        )

    cmds = []
    for number, (_, row) in enumerate(pairs.iterrows(), start=1):
        line_id = pair_prefix + str(number)
        cmds.append("dist {}, {}, {}, label=0".format(
            line_id, endpoint(row, "i"), endpoint(row, "j")
        ))

        if _styled(row, "color"):
            cmds.append("color {}, {}".format(
                _pymol_color(row["color"]), line_id
            ))
        cmds.extend(
            "set {}, {}, {}".format(param, row[param], line_id)
            for param in ("dash_radius", "dash_gap", "dash_length")
            if _styled(row, param)
        )

    _write_pymol_commands(cmds, output_file)
    return cmds


def pymol_mapping(mapping, output_file, chain=None, atom=None):
    """Map per-residue properties (color / show / b_factor columns) onto
    a structure, selecting residues by column i."""
    suffix = _chain_clause(chain) + (
        "" if atom is None else " and name {}".format(atom)
    )

    cmds = []
    for _, row in mapping.iterrows():
        selection = "resid {}{}".format(row["i"], suffix)

        if _styled(row, "color"):
            cmds.append("color {}, {}".format(
                _pymol_color(row["color"]), selection
            ))
        if _styled(row, "show"):
            cmds.append("show {}, {}".format(row["show"], selection))
        if _styled(row, "b_factor"):
            cmds.append(
                "alter {}, b={}".format(selection, row["b_factor"])
            )

    _write_pymol_commands(cmds, output_file)
    return cmds
