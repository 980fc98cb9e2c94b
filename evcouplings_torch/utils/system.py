"""File and directory helpers and the HTTP/FTP fetchers the stages use
(the subset of evcouplings_tpu/utils/system.py that runs no external
program; the port imports nothing of that package). The fetchers are
called only where a local file is missing: the compare stage's SIFTS
table, UniProt sequences and PDB structures."""

import os
import shutil
import tempfile
import urllib.error
import urllib.request


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


def insert_dir(prefix, *dirs, rootname_subdir=True):
    """Create a path with subdirectories inserted before the prefix rootname.

    With rootname_subdir=True (the default), the result is
    ``<dir-of-prefix>/<rootname>/<dirs...>/<rootname>``; otherwise
    ``<dir-of-prefix>/<dirs...>/<rootname>``.
    """
    base_dir, rootname = os.path.split(prefix)

    if rootname_subdir:
        return os.path.join(base_dir, rootname, *dirs, rootname)
    return os.path.join(base_dir, *dirs, rootname)


def temp():
    """Create a temporary file and return its path."""
    handle, name = tempfile.mkstemp()
    os.close(handle)
    return name


def tempdir():
    """Create a temporary directory and return its path."""
    return tempfile.mkdtemp()


def get_urllib(url, output_path):
    """Download a file from a (FTP or HTTP) URL via urllib."""
    with urllib.request.urlopen(url) as r, open(output_path, "wb") as f:
        shutil.copyfileobj(r, f)


def get(url, output_path=None, allow_redirects=False):
    """Download a file from an HTTP(S) URL.

    If output_path is given, streams the body to that file and returns None;
    otherwise returns the response object (with .status_code / .content /
    .text attributes as in the requests API subset used by this package).
    """
    try:
        import requests
    except ImportError:
        return _get_urllib_response(url, output_path, allow_redirects)

    try:
        r = requests.get(url, allow_redirects=allow_redirects, stream=True)
    except requests.exceptions.RequestException as e:
        # transport failures (bad URL, DNS, refused connection) surface
        # as the ResourceError contract callers retry on
        raise ResourceError("Could not fetch URL: {}".format(url)) from e
    if r.status_code != requests.codes.ok:
        raise ResourceError(
            "Invalid status code ({}) for URL: {}".format(r.status_code, url)
        )
    if output_path is None:
        return r
    try:
        with open(output_path, "wb") as f:
            for chunk in r.iter_content(chunk_size=4096):
                if chunk:
                    f.write(chunk)
    except OSError as e:
        raise ResourceError(
            "Could not save to file: {}".format(output_path)
        ) from e
    return None


class _Response:
    """The requests.Response subset get() callers read."""

    def __init__(self, status_code, content):
        self.status_code = status_code
        self.content = content
        try:
            self.text = content.decode()
        except UnicodeDecodeError:
            self.text = None


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *args, **kwargs):
        return None


def _get_urllib_response(url, output_path, allow_redirects):
    """get() without requests: transport errors become ResourceError, and
    allow_redirects=False refuses redirects (urllib follows them by
    default)."""
    opener = urllib.request.build_opener(
        *(() if allow_redirects else (_NoRedirect,)))
    try:
        with opener.open(urllib.request.Request(url)) as r:
            body, status = r.read(), r.status
    except urllib.error.HTTPError as e:
        raise ResourceError(
            "Invalid status code ({}) for URL: {}".format(e.code, url)
        ) from e
    except urllib.error.URLError as e:
        raise ResourceError(
            "Could not fetch URL: {} ({})".format(url, e.reason)
        ) from e

    if output_path is None:
        return _Response(status, body)
    with open(output_path, "wb") as f:
        f.write(body)
    return None
