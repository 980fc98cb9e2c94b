"""
`evcouplings_torch_dbupdate` command-line app: download/refresh the
sequence databases (UniProt, UniRef90/100) and SIFTS mapping files.

Port of evcouplings_tpu/utils/update_database.py; its parity target:
reference evcouplings/utils/update_database.py —
symlink_force (:43), download_ftp_file (:59), run (:102), CLI (:176).
"""

import datetime
import errno
import ftplib
import os
import zlib
from pathlib import Path

import click

from evcouplings_torch.utils.helpers import Progressbar

UNIPROT_URL = "ftp.uniprot.org"
UNIPROT_CWD = (
    "/pub/databases/uniprot/current_release/knowledgebase/complete/"
)
UNIPROT_FILE = "uniprot_{type}.fasta.gz"

DB_URL = "ftp.uniprot.org"
DB_CWD = "/pub/databases/uniprot/uniref/{type}/"
DB_FILE = "{type}.fasta.gz"

DB_SUFFIX = "{type}_{year}_{month}.fasta"
DB_CURRENT = "{type}_current.fasta"

SIFTS_SUFFIX = (
    "pdb_chain_uniprot_plus_{year}_{month}_{day}.{extension}"
)
SIFTS_CURRENT = "pdb_chain_uniprot_plus_current.{extension}"


def symlink_force(target, link_name):
    """Create a symlink, replacing an existing one."""
    try:
        os.symlink(target, link_name)
    except OSError as e:
        if e.errno != errno.EEXIST:
            raise
        os.remove(link_name)
        os.symlink(target, link_name)


def download_ftp_file(ftp_url, ftp_cwd, file_url, output_path,
                      file_handling="wb", gziped=False, verbose=False):
    """Download a file from an FTP server, decompressing gzip content
    on the fly into output_path."""
    ftp = ftplib.FTP(ftp_url)
    ftp.login()
    ftp.cwd(ftp_cwd)

    with open(output_path, file_handling) as out:
        progress = Progressbar(ftp.size(file_url)) if verbose else None
        # zlib with MAX_WBITS|32: automatic gzip header detection
        inflate = zlib.decompressobj(zlib.MAX_WBITS | 32)

        def receive(chunk):
            nonlocal progress
            out.write(inflate.decompress(chunk) if gziped else chunk)
            if verbose:
                progress += len(chunk)

        ftp.retrbinary("RETR %s" % file_url, receive, blocksize=8192)

    ftp.quit()


def _ensure_dir(base, *parts):
    """Absolute path base/parts..., created if missing."""
    target = os.path.join(os.path.abspath(base), *parts)
    Path(target).mkdir(parents=True, exist_ok=True)
    return target


def _refresh_sifts(sifts_dir, stamp, symlink):
    """Regenerate the SIFTS mapping table + sequence FASTA, optionally
    repointing the *_current symlinks."""
    from evcouplings_torch.compare.sifts import SIFTS

    dated = os.path.join(sifts_dir, SIFTS_SUFFIX)
    sifts_table = dated.format(extension="csv", **stamp)
    sifts_fasta = dated.format(extension="fasta", **stamp)

    # constructing SIFTS with a non-existent table path triggers the
    # download + conversion
    fresh = SIFTS(sifts_table)
    fresh.create_sequence_file(sifts_fasta)

    if symlink:
        current = os.path.join(sifts_dir, SIFTS_CURRENT)
        symlink_force(sifts_table, current.format(extension="csv"))
        symlink_force(sifts_fasta, current.format(extension="fasta"))


def _refresh_sequence_db(db_dir, db_type, stamp, symlink, verbose):
    """Download one sequence database release (uniprot = SwissProt +
    TrEMBL concatenated; uniref90/100 as-is), optionally repointing the
    *_current symlink."""
    out_path = os.path.join(
        db_dir, DB_SUFFIX.format(type=db_type, **stamp)
    )

    if db_type == "uniprot":
        # SwissProt + TrEMBL concatenated into one file
        for part, mode in (("sprot", "wb"), ("trembl", "ab")):
            download_ftp_file(
                UNIPROT_URL, UNIPROT_CWD,
                UNIPROT_FILE.format(type=part), out_path,
                gziped=True, file_handling=mode, verbose=verbose,
            )
    else:
        download_ftp_file(
            DB_URL, DB_CWD.format(type=db_type),
            DB_FILE.format(type=db_type), out_path,
            gziped=True, verbose=verbose,
        )

    if symlink:
        symlink_force(
            out_path,
            os.path.join(db_dir, DB_CURRENT.format(type=db_type)),
        )


def run(**kwargs):
    """Refresh SIFTS mapping files and UniProt/UniRef databases."""
    today = datetime.datetime.now()
    stamp = {
        "year": today.year, "month": today.month, "day": today.day,
    }
    verbose = kwargs.get("verbose", False)
    symlink = kwargs.get("symlink", False)

    if verbose:
        print("Updating SIFTS")
    sifts_dir = _ensure_dir(
        kwargs.get("sifts", os.path.realpath(__file__))
    )
    _refresh_sifts(sifts_dir, stamp, symlink)

    db_base = os.path.abspath(
        kwargs.get("db", os.path.realpath(__file__))
    )
    for db_type in ("uniprot", "uniref100", "uniref90"):
        if verbose:
            print("Updating", db_type)
        _refresh_sequence_db(
            _ensure_dir(db_base, db_type), db_type, stamp, symlink,
            verbose,
        )


CONTEXT_SETTINGS = dict(help_option_names=["-h", "--help"])


@click.command(context_settings=CONTEXT_SETTINGS)
@click.option(
    "-s", "--sifts", default="databases/SIFTS/",
    help="SIFTS output directory",
)
@click.option(
    "-d", "--db", default="databases/jackhmmer/",
    help="Uniprot output directory",
)
@click.option(
    "-l", "--symlink", default=False, is_flag=True,
    help="Creates symlink with ending '_current.' pointing to the "
         "newly created db files",
)
@click.option(
    "-v", "--verbose", default=False, is_flag=True,
    help="Enables verbose output",
)
def app(**kwargs):
    """Update database command line interface."""
    run(**kwargs)


if __name__ == "__main__":
    app()
