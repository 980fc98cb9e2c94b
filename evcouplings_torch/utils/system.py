"""File helpers the fitter uses (copy of the JAX package's
utils/system.py subset; the port imports nothing of that package)."""

import os


class ResourceError(Exception):
    """Exception for missing resources (files, URLs, ...)"""


def valid_file(file_path):
    """True if the file exists and is non-empty."""
    try:
        return os.path.getsize(file_path) > 0 and \
            os.path.isfile(file_path)
    except (OSError, TypeError):
        return False


def verify_resources(message, *args):
    """Verify that a set of files exists and is non-empty.

    Raises
    ------
    ResourceError
        with `message` and a list of all invalid files
    """
    invalid = [str(item) for item in args if not valid_file(item)]
    if invalid:
        raise ResourceError(
            "{}:\n{}".format(message, ", ".join(invalid))
        )


def create_prefix_folders(prefix):
    """Create the directory tree for a file-path prefix."""
    dirname = os.path.dirname(prefix)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
