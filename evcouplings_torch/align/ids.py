"""
Sequence-identifier extraction from alignment headers (port of
evcouplings_tpu/align/ids.py): retrieve_sequence_ids and the default
UniProt/UniRef regex list.
"""

import re
from collections import defaultdict

from evcouplings_torch.align.alignment import read_fasta

ID_EXTRACTION_REGEX = [
    # example: >UniRef100_H6SNJ6/11-331
    r"^Uni\w+\_(\w+).*/",
    # example: >tr|Q1NYN0|Q1NYN0_9FLAO/...
    r"^\w+\|(\w+)\|\w+\/",
    # example: >NQO8_THET8/1-365
    r"^(\w+).*/.*$",
    # example: >Q60019|NQO8_THET8/1-365
    r"^\w+\|\w+\|(\w+)",
]


def retrieve_sequence_ids(fileobj, regex=None):
    """Extract database identifiers from all FASTA headers.

    The FIRST matching regular expression wins per header. Returns
    (list of ids, {id: [full headers]}).
    """
    patterns = ID_EXTRACTION_REGEX if regex is None else regex

    def first_match(header):
        for pattern in patterns:
            hit = re.match(pattern, header)
            if hit and hit.groups():
                return hit.group(1)
        return None

    sequence_ids = []
    id_to_full_header = defaultdict(list)
    for header, _ in read_fasta(fileobj):
        extracted = first_match(header)
        if extracted is not None:
            sequence_ids.append(extracted)
            id_to_full_header[extracted].append(header)

    return sequence_ids, id_to_full_header
