"""
Shared constants (the part of evcouplings_tpu/utils/constants.py the
port uses): the suffix of the pipeline's final output-state file.
"""

# suffix of the run-level final output-state file written by the
# pipeline runtime
FINAL_CONFIG_SUFFIX = "_final.outcfg"
