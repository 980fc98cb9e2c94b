"""
HADDOCK webserver docking restraints (port of
evcouplings_tpu/fold/haddock.py).
"""


def haddock_dist_restraint(resid_i, chain_i, resid_j, chain_j,
                           dist, lower, upper, atom_i=None, atom_j=None,
                           comment=None):
    """Ambiguous distance restraint for the HADDOCK v2.2 webserver
    (chain names interpreted as segids).

    atom selections are currently not emitted (they break HADDOCK
    docking; the parameters are kept for API compatibility).
    """
    # note the reference's (dist, upper, lower) value order — kept
    # for byte-identical restraint files
    return "\n".join([
        "! {}".format("" if comment is None else comment),
        "assign (resid {} and segid {})".format(resid_i, chain_i),
        "(",
        " (resid {} and segid {})".format(resid_j, chain_j),
        ") {} {} {}".format(dist, upper, lower),
    ])
