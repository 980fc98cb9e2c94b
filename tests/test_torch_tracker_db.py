"""
The port's trackers and database updater (evcouplings_torch.utils.tracker
and .update_database), through the cases of tests/test_tracker_db.py:
the MongoDB tracker against an in-memory fake pymongo/gridfs, the
database-update app against a fake FTP server, and the sqlite tracker
under concurrent writers in real processes. Then both packages'
SQLTracker fed the same updates leave equal rows.
"""

import gzip
import os
import sys
import types

import pytest

from evcouplings_torch.utils.update_database import (
    download_ftp_file,
    symlink_force,
)


# ---------------------------------------------------------------------
# fake pymongo / gridfs
# ---------------------------------------------------------------------

class _FakeCollection:
    """Minimal mongo collection: match-by-equality filters, upserts,
    and dot-path "$set" nesting (so partial updates of the "results"
    subdocument behave like real MongoDB)."""

    def __init__(self):
        self.docs = []
        self._next_id = 0

    def _match(self, filt):
        return [
            d for d in self.docs
            if all(d.get(k) == v for k, v in filt.items())
        ]

    @staticmethod
    def _set_path(doc, dotted, value):
        parts = dotted.split(".")
        node = doc
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    @staticmethod
    def _unset_path(doc, dotted):
        parts = dotted.split(".")
        node = doc
        for p in parts[:-1]:
            node = node.get(p)
            if not isinstance(node, dict):
                return
        node.pop(parts[-1], None)

    def _apply(self, doc, update):
        for k, v in update.get("$set", {}).items():
            self._set_path(doc, k, v)
        for k in update.get("$unset", {}):
            self._unset_path(doc, k)

    def _insert_from(self, update):
        self._next_id += 1
        doc = {"_id": self._next_id}
        for k, v in update.get("$setOnInsert", {}).items():
            self._set_path(doc, k, v)
        self.docs.append(doc)
        return doc

    def find_one_and_update(self, filt, update, upsert=False,
                            return_document=False, **_):
        import copy

        matched = self._match(filt)
        if matched:
            doc = matched[0]
        elif upsert:
            doc = self._insert_from(update)
        else:
            return None
        # pymongo semantics: ReturnDocument.BEFORE (False, default)
        # returns the pre-image, AFTER (True) the post-image — the
        # tracker relies on AFTER
        before = copy.deepcopy(doc)
        self._apply(doc, update)
        return doc if return_document else before

    def update_one(self, filt, update, upsert=False):
        matched = self._match(filt)
        if not matched:
            if upsert:
                matched = [self._insert_from(update)]
            else:
                return
        self._apply(matched[0], update)

    def find_one(self, filt):
        matched = self._match(filt)
        return matched[0] if matched else None

    def find(self, filt):
        return list(self._match(filt))


class _FakeDB:
    def __init__(self):
        self.collections = {}

    def __getitem__(self, name):
        return self.collections.setdefault(name, _FakeCollection())


class _FakeClient:
    def __init__(self, connection_string):
        self.connection_string = connection_string
        self._db = _FakeDB()

    def get_default_database(self):
        return self._db


class _FakeGridFile:
    def __init__(self, _id, filename, data, **meta):
        self._id = _id
        self.filename = filename
        self.data = data
        self.meta = meta


class _FakeGridFS:
    def __init__(self, db, collection=None):
        self.files = {}
        self._next = 0

    def put(self, fobj, filename=None, **meta):
        self._next += 1
        self.files[self._next] = _FakeGridFile(
            self._next, filename, fobj.read(), **meta
        )
        return self._next

    def find(self, query):
        return [
            f for f in list(self.files.values())
            if f.filename == query.get("filename")
        ]

    def delete(self, file_id):
        self.files.pop(file_id, None)


@pytest.fixture
def fake_mongo(monkeypatch):
    pymongo = types.ModuleType("pymongo")
    pymongo.MongoClient = _FakeClient
    gridfs = types.ModuleType("gridfs")
    gridfs.GridFS = _FakeGridFS
    monkeypatch.setitem(sys.modules, "pymongo", pymongo)
    monkeypatch.setitem(sys.modules, "gridfs", gridfs)
    return pymongo


def _make_tracker(tmp_path, **overrides):
    from evcouplings_torch.utils.tracker.mongodb import MongoDBTracker

    kwargs = dict(
        connection_string="mongodb://localhost/evc",
        job_id="job1",
        prefix=str(tmp_path / "out"),
        pipeline="protein_monomer",
        file_list=None,
        delete_list=[],
        config={"stages": ["align"]},
        retry_max_number=1,
        retry_wait=0,
    )
    kwargs.update(overrides)
    return MongoDBTracker(**kwargs)


class TestMongoDBTracker:
    def test_requires_pymongo(self, monkeypatch, tmp_path):
        monkeypatch.setitem(sys.modules, "pymongo", None)
        with pytest.raises(ImportError, match="pymongo"):
            _make_tracker(tmp_path)

    def test_upsert_and_status_transitions(self, fake_mongo, tmp_path):
        t = _make_tracker(tmp_path)
        t.update(status="pending")
        doc = t.jobs.find_one({"job_id": "job1"})
        assert doc["status"] == "pending"
        assert doc["pipeline"] == "protein_monomer"
        assert doc["config"] == {"stages": ["align"]}

        t.update(status="running", stage="align", message="go")
        doc = t.jobs.find_one({"job_id": "job1"})
        assert doc["status"] == "running"
        assert doc["stage"] == "align"
        assert doc["message"] == "go"
        assert "time_started" in doc
        # entering RUN fills in the job location from the runner's cwd
        # (reference mongodb.py:373-379)
        assert doc["location"] == os.getcwd()

    def test_new_document_without_status_is_init(self, fake_mongo,
                                                 tmp_path):
        t = _make_tracker(tmp_path)
        t.update(results={"num_sequences": 3})
        doc = t.jobs.find_one({"job_id": "job1"})
        assert doc["status"] == "initialized"
        # a later status-less update must NOT reset it
        t.update(stage="couplings")
        doc = t.jobs.find_one({"job_id": "job1"})
        assert doc["status"] == "initialized"
        assert doc["stage"] == "couplings"

    def test_get_returns_current_document(self, fake_mongo, tmp_path):
        t = _make_tracker(tmp_path)
        assert t.get() is None
        t.update(status="running", stage="align")
        doc = t.get()
        assert doc["status"] == "running"
        assert doc["stage"] == "align"

    def test_path_mode_stores_no_files(self, fake_mongo, tmp_path):
        """file_list=None: results recorded as paths, nothing in
        GridFS, delete-listed keys dropped (reference :273-282)."""
        f1 = tmp_path / "a.csv"
        f1.write_text("x,y\n1,2\n")
        t = _make_tracker(tmp_path, delete_list=["scratch_file"])
        t.update(results={
            "alignment_file": str(f1),
            "num_sequences": 10,
            "scratch_file": str(tmp_path / "scratch.txt"),
        })
        doc = t.jobs.find_one({"job_id": "job1"})
        assert doc["results"]["num_sequences"] == 10
        assert doc["results"]["alignment_file"] == str(f1)
        assert "scratch_file" not in doc["results"]
        assert t.fs.files == {}

    def test_gridfs_mode_mirrors_and_replaces(self, fake_mongo,
                                              tmp_path):
        """file_list given: listed files go to GridFS, their result
        entries become {filename, fs_id}, and a re-update deletes the
        outdated GridFS version by its recorded fs_id
        (reference :284-334)."""
        f1 = tmp_path / "a.csv"
        f1.write_text("x,y\n1,2\n")
        t = _make_tracker(tmp_path, file_list=["alignment_file"])
        t.update(results={
            "alignment_file": str(f1), "num_sequences": 10,
        })
        doc = t.jobs.find_one({"job_id": "job1"})
        entry = doc["results"]["alignment_file"]
        assert entry["filename"] == str(f1)
        stored = t.fs.files[entry["fs_id"]]
        assert stored.data == b"x,y\n1,2\n"
        assert stored.meta["parent_id"] == doc["_id"]
        assert doc["results"]["num_sequences"] == 10

        # partial re-update: the stale GridFS copy is deleted by fs_id
        f1.write_text("x,y\n3,4\n")
        t.update(results={"alignment_file": str(f1)})
        doc = t.jobs.find_one({"job_id": "job1"})
        assert len(t.fs.files) == 1
        assert t.fs.files[
            doc["results"]["alignment_file"]["fs_id"]
        ].data == b"x,y\n3,4\n"
        # untouched keys of the results subdocument survive
        assert doc["results"]["num_sequences"] == 10

    def test_gridfs_mode_file_lists_and_mappings(self, fake_mongo,
                                                 tmp_path):
        """"*_files" entries: a list of paths maps to a list of
        {filename, fs_id}; a mapping path->annotation carries the
        annotation in a "value" field (reference :236-250)."""
        fa = tmp_path / "m1.pdb"
        fa.write_text("m1")
        fb = tmp_path / "m2.pdb"
        fb.write_text("m2")
        t = _make_tracker(tmp_path, file_list=["model_files"])

        t.update(results={"model_files": [str(fa), str(fb)]})
        doc = t.jobs.find_one({"job_id": "job1"})
        entries = doc["results"]["model_files"]
        assert [e["filename"] for e in entries] == [str(fa), str(fb)]
        assert len(t.fs.files) == 2

        # mapping form replaces the list (stale copies dropped)
        t.update(results={"model_files": {str(fa): 0.25}})
        doc = t.jobs.find_one({"job_id": "job1"})
        entries = doc["results"]["model_files"]
        assert entries == [{
            "filename": str(fa),
            "fs_id": entries[0]["fs_id"],
            "value": 0.25,
        }]
        assert len(t.fs.files) == 1

    def test_gridfs_mode_key_filtering(self, fake_mongo, tmp_path):
        """file_list mode: unlisted file keys are not recorded at all;
        delete-listed files MAY be mirrored into GridFS — that is the
        only place they survive (reference :60-68,284-305)."""
        f1 = tmp_path / "keep.csv"
        f1.write_text("k")
        f2 = tmp_path / "skip.csv"
        f2.write_text("s")
        f3 = tmp_path / "del.csv"
        f3.write_text("d")
        t = _make_tracker(
            tmp_path,
            file_list=["keep_file", "del_file"],
            delete_list=["del_file"],
        )
        t.update(results={
            "keep_file": str(f1),
            "skip_file": str(f2),
            "del_file": str(f3),
        })
        doc = t.jobs.find_one({"job_id": "job1"})
        assert doc["results"]["keep_file"]["filename"] == str(f1)
        assert doc["results"]["del_file"]["filename"] == str(f3)
        assert "skip_file" not in doc["results"]
        data = {f.data for f in t.fs.files.values()}
        assert data == {b"k", b"d"}

    def test_unreadable_listed_file_raises(self, fake_mongo, tmp_path):
        from evcouplings_torch.utils.system import ResourceError

        t = _make_tracker(tmp_path, file_list=["model_file"])
        with pytest.raises(ResourceError, match="storing in MongoDB"):
            t.update(results={
                "model_file": str(tmp_path / "missing.model"),
            })

    def test_path_to_gridfs_migration_tolerated(self, fake_mongo,
                                                tmp_path):
        """A database written in path mode then re-run with a
        file_list: the stale results entry is a plain string with no
        fs_id — deletion must skip it, not crash (reference
        :190-198)."""
        f1 = tmp_path / "a.csv"
        f1.write_text("v1")
        t = _make_tracker(tmp_path)                     # path mode
        t.update(results={"alignment_file": str(f1)})

        t2 = _make_tracker(tmp_path, file_list=["alignment_file"])
        t2.client = t.client                            # same "server"
        t2.jobs = t.jobs
        t2.fs = t.fs
        t2.update(results={"alignment_file": str(f1)})
        doc = t2.jobs.find_one({"job_id": "job1"})
        assert doc["results"]["alignment_file"]["filename"] == str(f1)
        assert len(t2.fs.files) == 1

    def test_legacy_file_ids_migration_drops_blob_and_entry(
            self, fake_mongo, tmp_path):
        """Legacy schema written by the pre-GridFS-contract tracker:
        file_ids.<key> holds an fs_id while results.<key> is a plain
        path. Re-storing that key must delete the legacy blob AND
        $unset file_ids.<key> — otherwise every rerun of an upgraded
        job database leaks one GridFS copy per file
        (mongodb.py legacy branch; ADVICE r2 item 1)."""
        import io

        f1 = tmp_path / "a.csv"
        f1.write_text("v2")

        t = _make_tracker(tmp_path, file_list=["alignment_file"])
        # seed the legacy layout directly: a GridFS blob whose id is
        # recorded under file_ids, with results.<key> a plain path
        legacy_id = t.fs.put(io.BytesIO(b"v1"), filename=str(f1))
        t.update(status="running")
        t.jobs.update_one(
            {"job_id": "job1"},
            {"$set": {
                "results.alignment_file": str(f1),
                "file_ids.alignment_file": legacy_id,
            }},
        )
        assert legacy_id in t.fs.files

        t.update(results={"alignment_file": str(f1)})

        doc = t.jobs.find_one({"job_id": "job1"})
        # new-schema entry stored, legacy blob gone, mapping retired
        assert doc["results"]["alignment_file"]["filename"] == str(f1)
        assert legacy_id not in t.fs.files
        assert "alignment_file" not in doc.get("file_ids", {})
        # exactly the one fresh copy remains
        assert len(t.fs.files) == 1
        assert list(t.fs.files.values())[0].data == b"v2"

    def test_path_to_gridfs_migration_of_files_mapping(self, fake_mongo,
                                                       tmp_path):
        """Same migration with a "*_files" MAPPING entry recorded in
        path mode: the drop phase sees {path: annotation} and has no
        fs_ids — it must skip cleanly, not crash on the merge."""
        fa = tmp_path / "m1.pdb"
        fa.write_text("m1")
        t = _make_tracker(tmp_path)                     # path mode
        t.update(results={"model_files": {str(fa): 0.25}})

        t2 = _make_tracker(tmp_path, file_list=["model_files"])
        t2.client = t.client
        t2.jobs = t.jobs
        t2.fs = t.fs
        t2.update(results={"model_files": {str(fa): 0.5}})
        doc = t2.jobs.find_one({"job_id": "job1"})
        entry = doc["results"]["model_files"][0]
        assert entry["filename"] == str(fa)
        assert entry["value"] == 0.5
        assert len(t2.fs.files) == 1


# ---------------------------------------------------------------------
# update_database
# ---------------------------------------------------------------------

class _FakeFTP:
    """Serves an in-memory file map through the ftplib surface used by
    download_ftp_file."""

    store = {}

    def __init__(self, url):
        self.url = url

    def login(self):
        pass

    def cwd(self, path):
        self.path = path

    def size(self, name):
        return len(self.store[(self.path, name)])

    def retrbinary(self, cmd, callback, blocksize=8192):
        assert cmd.startswith("RETR ")
        data = self.store[(self.path, cmd[5:])]
        for i in range(0, len(data), blocksize):
            callback(data[i:i + blocksize])

    def quit(self):
        pass


class TestUpdateDatabase:
    def test_symlink_force(self, tmp_path):
        a = tmp_path / "a"
        b = tmp_path / "b"
        a.write_text("A")
        b.write_text("B")
        link = tmp_path / "current"
        symlink_force(str(a), str(link))
        assert link.read_text() == "A"
        symlink_force(str(b), str(link))
        assert link.read_text() == "B"

    def test_download_ftp_file_gzip(self, tmp_path, monkeypatch):
        payload = b">sp|P1|X\nACDEF\n" * 100
        _FakeFTP.store = {
            ("/db/", "uniref.fasta.gz"): gzip.compress(payload)
        }
        monkeypatch.setattr("ftplib.FTP", _FakeFTP)
        out = tmp_path / "uniref.fasta"
        download_ftp_file(
            "ftp.example.org", "/db/", "uniref.fasta.gz", str(out),
            gziped=True,
        )
        assert out.read_bytes() == payload

    def test_download_ftp_file_verbose_progress(self, tmp_path,
                                                monkeypatch, capsys):
        # verbose=True drives the Progressbar from inside the receive()
        # closure — regression for the missing `nonlocal progress`
        # (UnboundLocalError on the first chunk)
        payload = b"x" * 30000
        _FakeFTP.store = {
            ("/db/", "big.gz"): gzip.compress(payload)
        }
        monkeypatch.setattr("ftplib.FTP", _FakeFTP)
        out = tmp_path / "big.dat"
        download_ftp_file(
            "u", "/db/", "big.gz", str(out), gziped=True, verbose=True,
        )
        assert out.read_bytes() == payload
        # the bar writes carriage-return frames to stderr
        assert "[" in capsys.readouterr().err

    def test_download_ftp_file_append(self, tmp_path, monkeypatch):
        _FakeFTP.store = {
            ("/db/", "one.gz"): gzip.compress(b"first\n"),
            ("/db/", "two.gz"): gzip.compress(b"second\n"),
        }
        monkeypatch.setattr("ftplib.FTP", _FakeFTP)
        out = tmp_path / "cat.fasta"
        download_ftp_file("u", "/db/", "one.gz", str(out), gziped=True)
        download_ftp_file("u", "/db/", "two.gz", str(out),
                          gziped=True, file_handling="ab")
        assert out.read_bytes() == b"first\nsecond\n"

    def test_run_layout_and_symlinks(self, tmp_path, monkeypatch):
        import evcouplings_torch.utils.update_database as ud

        downloaded = []

        def fake_download(ftp_url, ftp_cwd, file_url, output_path,
                          file_handling="wb", gziped=False,
                          verbose=False):
            downloaded.append(file_url)
            with open(output_path, file_handling) as f:
                f.write((file_url + "\n").encode())

        class FakeSIFTS:
            def __init__(self, table):
                # simulates download-on-construction of the mapping
                with open(table, "w") as f:
                    f.write("mapping")
                self.table = table

            def create_sequence_file(self, path):
                with open(path, "w") as f:
                    f.write("seqs")

        monkeypatch.setattr(ud, "download_ftp_file", fake_download)
        monkeypatch.setattr(
            "evcouplings_torch.compare.sifts.SIFTS", FakeSIFTS
        )

        sifts_dir = tmp_path / "SIFTS"
        db_dir = tmp_path / "jackhmmer"
        ud.run(sifts=str(sifts_dir), db=str(db_dir), symlink=True)

        # SIFTS csv + fasta with dated names, plus _current symlinks
        csvs = list(sifts_dir.glob("pdb_chain_uniprot_plus_*.csv"))
        assert len(csvs) == 2  # dated + current symlink
        cur = sifts_dir / "pdb_chain_uniprot_plus_current.csv"
        assert cur.is_symlink() and cur.read_text() == "mapping"
        cur_fa = sifts_dir / "pdb_chain_uniprot_plus_current.fasta"
        assert cur_fa.read_text() == "seqs"

        # uniprot = sprot + trembl concatenated; uniref single files
        up = list((db_dir / "uniprot").glob("uniprot_*_*.fasta"))
        assert len(up) == 1
        assert up[0].read_text() == (
            "uniprot_sprot.fasta.gz\nuniprot_trembl.fasta.gz\n"
        )
        for db_type in ("uniref100", "uniref90"):
            link = db_dir / db_type / f"{db_type}_current.fasta"
            assert link.is_symlink()
            assert link.read_text() == f"{db_type}.fasta.gz\n"

        assert downloaded == [
            "uniprot_sprot.fasta.gz", "uniprot_trembl.fasta.gz",
            "uniref100.fasta.gz", "uniref90.fasta.gz",
        ]


# --------------------------------------------------------------------------
# SQLTracker concurrency (VERDICT r2 item 8): simultaneous jobs
# updating ONE tracker database — the reference's real deployment
# pattern (batch sub-jobs share a tracker DB; reference
# utils/tracker/sql.py:45-283). Real OS processes, not threads: sqlite
# locking behaves differently across processes.
# --------------------------------------------------------------------------

_SQL_WORKER = r"""
import sys
db, job_id, tag, n = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])

from evcouplings_torch.utils.tracker import EStatus
from evcouplings_torch.utils.tracker.sql import SQLTracker

t = SQLTracker(
    connection_string="sqlite:///" + db, job_id=job_id,
    prefix="/tmp/" + job_id, pipeline="protein_monomer",
    file_list=None, delete_list=[], config={},
    retry_max_number=10, retry_wait=1,
)
t.update(status=EStatus.RUN)
for k in range(n):
    t.update(stage="stage{}".format(k),
             results={"{}_key{}".format(tag, k): k})
t.update(status=EStatus.DONE)
"""


class TestSQLTrackerConcurrency:
    N_UPDATES = 25

    def _run_workers(self, tmp_path, jobs):
        """jobs: list of (job_id, tag). Returns the shared db path."""
        import subprocess
        import sys as _sys

        worker = tmp_path / "sql_worker.py"
        worker.write_text(_SQL_WORKER)
        db = str(tmp_path / "shared.db")

        # the workers import the port from this checkout
        env = dict(os.environ)
        env["PYTHONPATH"] = (
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            + os.pathsep + env.get("PYTHONPATH", "")
        )
        procs = [
            subprocess.Popen(
                [_sys.executable, str(worker), db, job_id, tag,
                 str(self.N_UPDATES)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            )
            for job_id, tag in jobs
        ]
        for p in procs:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0, out.decode()
        return db

    def test_concurrent_distinct_jobs_no_lost_updates(self, tmp_path):
        """Four simultaneous jobs, four rows, one database file: every
        row must end DONE with all 25 of its result keys."""
        import json
        import sqlite3

        jobs = [("job{}".format(i), "w{}".format(i)) for i in range(4)]
        db = self._run_workers(tmp_path, jobs)

        conn = sqlite3.connect(db)
        conn.row_factory = sqlite3.Row
        rows = {
            r["job_id"]: r
            for r in conn.execute("SELECT * FROM evcouplings_jobs")
        }
        assert set(rows) == {j for j, _ in jobs}
        for job_id, tag in jobs:
            row = rows[job_id]
            assert row["status"] == "done"
            results = json.loads(row["results"])
            expected = {
                "{}_key{}".format(tag, k) for k in range(self.N_UPDATES)
            }
            assert expected <= set(results), (
                "lost updates for {}: missing {}".format(
                    job_id, expected - set(results))
            )

    def test_concurrent_same_job_results_merge(self, tmp_path):
        """Three processes merging results into ONE row (batch
        sub-jobs inherit a shared job_id). The read-merge-write in
        SQLTracker.update runs under BEGIN IMMEDIATE, so no process
        may overwrite another's keys — all 75 must survive."""
        import json
        import sqlite3

        jobs = [("shared_job", "w{}".format(i)) for i in range(3)]
        db = self._run_workers(tmp_path, jobs)

        conn = sqlite3.connect(db)
        conn.row_factory = sqlite3.Row
        rows = list(conn.execute("SELECT * FROM evcouplings_jobs"))
        assert len(rows) == 1
        results = json.loads(rows[0]["results"])
        expected = {
            "w{}_key{}".format(i, k)
            for i in range(3) for k in range(self.N_UPDATES)
        }
        assert expected <= set(results), (
            "lost updates: missing {}".format(expected - set(results))
        )


# --------------------------------------------------------------------------
# the port's SQLTracker against the JAX package's
# --------------------------------------------------------------------------

# one job's tracker traffic as the pipeline sends it: created pending,
# running, a stage with results, a deleted file key, a message, done
_UPDATES = [
    dict(status="pending"),
    dict(status="running"),
    dict(stage="align", results={"alignment_file": "out/job.a2m",
                                 "num_sequences": 60,
                                 "effective_sequences": 41.25}),
    dict(stage="couplings", results={"model_file": "out/job.model",
                                     "raw_ec_file": "out/job_ECs.txt",
                                     "region_start": 11}),
    dict(message="all stages ran", results={"num_sequences": 59}),
    dict(status="done"),
]


def _sql_rows(module, db_file):
    import json
    import sqlite3

    tracker = module.SQLTracker(
        connection_string="sqlite:///" + str(db_file), job_id="job1",
        prefix="out/job", pipeline="protein_monomer", file_list=None,
        delete_list=["raw_ec_file"],
        config={"stages": ["align", "couplings"], "global": {"theta": 0.8}},
        retry_max_number=1, retry_wait=0,
    )
    for update in _UPDATES:
        tracker.update(**update)
    conn = sqlite3.connect(str(db_file))
    conn.row_factory = sqlite3.Row
    try:
        rows = [dict(r) for r in conn.execute(
            "SELECT * FROM evcouplings_jobs")]
    finally:
        conn.close()
    for row in rows:
        assert row["time_started"] is not None
        for key in ("time_created", "time_started", "time_updated",
                    "runner_id"):
            del row[key]
        row["results"] = json.loads(row["results"])
    return rows, tracker.get()


def test_sql_tracker_rows_match_jax(tmp_path):
    from evcouplings_tpu.utils.tracker import sql as jax_sql
    from evcouplings_torch.utils.tracker import sql

    got, got_row = _sql_rows(sql, tmp_path / "torch.db")
    want, _ = _sql_rows(jax_sql, tmp_path / "jax.db")
    assert got == want
    assert got[0]["status"] == "done" and got[0]["stage"] == "couplings"
    assert got[0]["results"] == {
        "alignment_file": "out/job.a2m", "num_sequences": 59,
        "effective_sequences": 41.25, "model_file": "out/job.model",
        "region_start": 11}
    assert sql.ComputeJob.from_row(got_row).job_id == "job1"


@pytest.mark.parametrize("management,error", [
    ({"tracker_type": "sql", "job_id": "j"}, "connection_string"),
    ({"tracker_type": "sql", "connection_string": "sqlite://:memory:"},
     "job_id"),
    ({"tracker_type": "sql", "job_id": "j",
      "connection_string": "postgresql://host/db"}, "sqlite"),
    ({"tracker_type": "redis", "job_id": "j", "connection_string": "x"},
     "Not a valid job result tracker"),
])
def test_get_result_tracker_refusals_match_jax(management, error):
    from evcouplings_tpu.utils import tracker as jax_tracker
    from evcouplings_torch.utils import tracker
    from evcouplings_torch.utils.config import InvalidParameterError as E1
    from evcouplings_tpu.utils.config import InvalidParameterError as E2

    config = {"management": management, "global": {"prefix": "p"}}
    with pytest.raises(E1, match=error):
        tracker.get_result_tracker(config)
    with pytest.raises(E2, match=error):
        jax_tracker.get_result_tracker(config)


def test_get_result_tracker_selects_working_backends(tmp_path, fake_mongo,
                                                     monkeypatch):
    """get_result_tracker returns a working sql tracker (credentials from
    the environment formatted into the connection string) and a working
    mongodb tracker."""
    from evcouplings_torch.utils import tracker
    from evcouplings_torch.utils.tracker.mongodb import MongoDBTracker
    from evcouplings_torch.utils.tracker.sql import SQLTracker

    monkeypatch.setenv(tracker.TRACKER_USERNAME_KEY, "db")
    config = {"pipeline": "protein_monomer", "global": {"prefix": "out/j"},
              "management": {"tracker_type": "sql", "job_id": "j",
                             "connection_string": "sqlite:///" + str(
                                 tmp_path) + "/{username}.db"}}
    sql_tracker = tracker.get_result_tracker(config)
    assert isinstance(sql_tracker, SQLTracker)
    assert sql_tracker.db_path == str(tmp_path / "db.db")
    sql_tracker.update(status=tracker.EStatus.RUN)
    assert sql_tracker.get()["status"] == "running"

    config["management"].update(tracker_type="mongodb",
                                connection_string="mongodb://localhost/evc")
    mongo = tracker.get_result_tracker(config)
    assert isinstance(mongo, MongoDBTracker)
    mongo.update(status=tracker.EStatus.DONE)
    assert mongo.get()["status"] == "done"
