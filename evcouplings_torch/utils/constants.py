"""
Shared constants (the part of evcouplings_tpu/utils/constants.py the
port uses): the amino-acid code tables (standard IUPAC codes including the
B/Z/X ambiguity symbols) and the suffix of the pipeline's final
output-state file.
"""

_AA_CODES = (
    "A ALA,R ARG,N ASN,D ASP,C CYS,Q GLN,E GLU,G GLY,H HIS,I ILE,"
    "L LEU,K LYS,M MET,F PHE,P PRO,S SER,T THR,W TRP,Y TYR,V VAL,"
    "B ASX,Z GLX,X XAA"
)

# amino acid one-letter code to three-letter code
AA1_to_AA3 = dict(
    entry.split() for entry in _AA_CODES.split(",")
)

# amino acid three-letter code to one-letter code
AA3_to_AA1 = {three: one for one, three in AA1_to_AA3.items()}

# suffix of the run-level final output-state file written by the
# pipeline runtime
FINAL_CONFIG_SUFFIX = "_final.outcfg"
