"""
The plmc wrapper's API (port of evcouplings_tpu/couplings/tools.py).

The Potts fit is in process (couplings/fitter.run_plm), so `run_plmc`
does not start the plmc binary: it takes the wrapper's arguments and
returns its result fields, and fits on the port's `device`. `binary` and
`cpu` are accepted and ignored. `parse_plmc_log` parses the stderr text of
a plmc run, so that logs of earlier plmc jobs can still be read.
"""

import re

import pandas as pd

from evcouplings_torch.couplings.fitter import PlmResult, run_plm

# the wrapper's result fields (PlmResult mirrors them)
PlmcResult = PlmResult


def parse_plmc_log(log):
    """Parse plmc stderr text into run data.

    Returns (iteration_df, (focus_index, valid_seqs, total_seqs,
    valid_sites, total_sites, region_start, eff_samples, opt_status)).
    focus_index, the site counts and region_start are None, None and 1
    for a log of a run without focus mode. Raises KeyError if the text is
    not a complete plmc log.
    """
    stat_patterns = {
        "focus": re.compile(r"Found focus (.+) as sequence (\d+)"),
        "seqs": re.compile(r"(\d+) valid sequences out of (\d+)"),
        "sites": re.compile(r"(\d+) sites out of (\d+)"),
        "region": re.compile(r"Region starts at (\d+)"),
        "samples": re.compile(r"Effective number of samples: (\d+\.\d+)"),
        "optimization": re.compile(r"Gradient optimization: (.+)"),
    }
    # iteration rows: an integer iteration number and six float columns
    iter_pattern = re.compile(r"(\d+)" + r"\s+(\d+\.\d+)" * 6)

    found = {}
    header = None
    rows = []
    for line in log.split("\n"):
        for name, pattern in stat_patterns.items():
            m = pattern.search(line)
            if m:
                found[name] = m.groups()
        if line.startswith("iter"):
            header = line.split()
        m = iter_pattern.search(line)
        if m:
            rows.append(m.groups())

    iter_df = pd.DataFrame(rows, columns=header) if header else None

    focus_index = None
    valid_sites = total_sites = None
    region_start = 1
    if "focus" in found:
        focus_index = int(found["focus"][1])
    if "sites" in found:
        valid_sites, total_sites = map(int, found["sites"])
    if "region" in found:
        region_start = int(found["region"][0])

    valid_seqs, total_seqs = map(int, found["seqs"])
    eff_samples = float(found["samples"][0])
    opt_status = found["optimization"][0]

    return iter_df, (
        focus_index, valid_seqs, total_seqs, valid_sites, total_sites,
        region_start, eff_samples, opt_status,
    )


def run_plmc(alignment, couplings_file, param_file=None, focus_seq=None,
             alphabet=None, theta=None, scale=None, ignore_gaps=False,
             iterations=None, lambda_h=None, lambda_J=None, lambda_g=None,
             cpu=None, binary="plmc", **kwargs):
    """The plmc wrapper's run_plmc, fitting with the port's run_plm
    (further keyword arguments, e.g. `device`, pass through to it).
    `theta` is the clustering identity threshold itself (the wrapper
    inverts it only for the plmc binary's -t flag).

    Returns PlmcResult.
    """
    return run_plm(
        alignment, couplings_file, param_file=param_file,
        focus_seq=focus_seq, alphabet=alphabet, theta=theta, scale=scale,
        ignore_gaps=ignore_gaps, iterations=iterations, lambda_h=lambda_h,
        lambda_J=lambda_J, lambda_g=lambda_g, cpu=cpu, binary=binary,
        **kwargs)
