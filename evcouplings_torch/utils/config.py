"""
YAML configuration handling.

Copy of evcouplings_tpu/utils/config.py (the port imports nothing of that
package): parse_config / read_config_file / write_config_file /
check_required / iterate_files and the two error classes, on PyYAML
with a numpy-aware dumper.
"""

from pathlib import Path

import numpy as np
import yaml


class MissingParameterError(Exception):
    """Exception for missing parameters"""


class InvalidParameterError(Exception):
    """Exception for invalid parameter settings"""


class _ConfigDumper(yaml.SafeDumper):
    """YAML dumper that knows how to serialize numpy scalars/arrays."""


def _represent_np_float(dumper, data):
    return dumper.represent_float(float(data))


def _represent_np_int(dumper, data):
    return dumper.represent_int(int(data))


def _represent_np_array(dumper, data):
    return dumper.represent_list(data.tolist())


def _represent_np_str(dumper, data):
    return dumper.represent_str(str(data))


_ConfigDumper.add_multi_representer(np.floating, _represent_np_float)
_ConfigDumper.add_multi_representer(np.integer, _represent_np_int)
_ConfigDumper.add_representer(np.ndarray, _represent_np_array)
_ConfigDumper.add_multi_representer(np.str_, _represent_np_str)
# tuples render as YAML lists (safe dumper rejects python/tuple otherwise)
_ConfigDumper.add_representer(
    tuple, lambda dumper, data: dumper.represent_list(list(data))
)


class _ConfigLoader(yaml.SafeLoader):
    """SafeLoader that accepts YAML sequences as mapping keys by
    converting them to tuples (e.g. the `[O, O]:` atom-pair keys in
    restraint configs; ruamel — used by the reference — does the same,
    plain PyYAML rejects them as unhashable)."""

    def construct_mapping(self, node, deep=False):
        # resolve merge keys (<<: *anchor) like the stock
        # SafeConstructor does — overriding construct_mapping loses
        # that step otherwise and anchored configs fail to parse
        self.flatten_mapping(node)
        mapping = {}
        for key_node, value_node in node.value:
            key = self.construct_object(key_node, deep=True)
            if isinstance(key, list):
                key = tuple(key)
            mapping[key] = self.construct_object(value_node, deep=deep)
        return mapping


def parse_config(config_str, preserve_order=False):
    """Parse a configuration string (or file object) into a dict.

    ``preserve_order`` is accepted for API compatibility; PyYAML dicts
    preserve insertion order natively on Python >= 3.7.
    """
    try:
        return yaml.load(config_str, Loader=_ConfigLoader)
    except yaml.YAMLError as parse_error:
        raise InvalidParameterError(
            "Configuration is not valid YAML (formatting mistake in "
            "the config file?): "
            + " / ".join(str(parse_error).splitlines())
        ) from parse_error


def read_config_file(filename, preserve_order=False):
    """Read and parse a YAML configuration file."""
    return parse_config(
        Path(filename).read_text(), preserve_order
    )


def write_config_file(out_filename, config):
    """Save configuration data structure to a YAML file."""
    with open(out_filename, "w") as out:
        yaml.dump(
            config, out, Dumper=_ConfigDumper,
            default_flow_style=False, sort_keys=False,
        )


def check_required(params, keys):
    """Verify the required set of parameters is present in the configuration.

    Raises
    ------
    MissingParameterError
    """
    absent = [key for key in keys if key not in params]
    if absent:
        raise MissingParameterError(
            "Missing required parameters: {} \nGiven: {}".format(
                ", ".join(absent), params
            )
        )


def iterate_files(outcfg, subset=None):
    """Iterate file items (keys ending in _file/_files) in an outconfig.

    Yields tuples (file path, entry key, index); index is None for single
    ``*_file`` entries.
    """
    wanted = (
        outcfg.items() if subset is None
        else ((k, outcfg[k]) for k in outcfg if k in subset)
    )
    for key, value in wanted:
        if value is None:
            continue
        if key.endswith("_files"):
            yield from (
                (path, key, idx) for idx, path in enumerate(value)
            )
        elif key.endswith("_file"):
            yield value, key, None
