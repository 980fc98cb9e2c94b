"""
MongoDB-backed job tracker with GridFS file mirroring.

Port of evcouplings_tpu/utils/tracker/mongodb.py; its parity target:
reference evcouplings/utils/tracker/mongodb.py
(MongoDBTracker :41-414; gridfs file handling :133-252; two-phase
update :336-414). Semantics honored:

- file_list is None (default): result files are recorded as PATHS and
  nothing is mirrored into GridFS; delete-listed keys are dropped
  (they will not survive the run, so a path would dangle).
- file_list given: "*_file" / "*_files" result keys named in
  file_list are stored in GridFS and their result entries become
  {"filename": <original path>, "fs_id": <GridFS id>} (lists of those
  for "*_files"; a mapping value contributes an extra "value" field
  per file). Previously stored versions of the SAME keys are deleted
  from GridFS by their recorded fs_id (rerun/partial-update
  mirroring). File keys NOT in file_list are not recorded at all in
  this mode; delete-listed keys MAY be mirrored (GridFS is exactly
  where a to-be-deleted file can survive).
- update() is two-phase: an upsert that creates the job document
  (job_id/prefix/pipeline/config/time_created) and returns the
  current state, then one "$set" with dot-path partial updates —
  entering RUN records time_started and fills in "location" from the
  runner's cwd if unset; a brand-new document with no status becomes
  INIT.
- queries retry only on MongoDB connectivity/operation errors
  (reference :29-35), never on programming errors.

Requires pymongo; the import is deferred so the rest of the framework
has no hard dependency on it.
"""

import os
from collections.abc import Mapping
from datetime import datetime, timezone

from evcouplings_torch.utils.helpers import retry
from evcouplings_torch.utils.system import ResourceError
from evcouplings_torch.utils.tracker import EStatus
from evcouplings_torch.utils.tracker.base import (
    DEFAULT_FILE_COLLECTION,
    DEFAULT_RESULT_COLLECTION,
    ResultTracker,
)

# reference-compatible names (reference utils/tracker/mongodb.py:30-38)
JOB_COLLECTION_NAME = DEFAULT_RESULT_COLLECTION
FILE_COLLECTION_NAME = DEFAULT_FILE_COLLECTION

try:
    from pymongo import errors as _mongo_errors

    CATCH_MONGODB_EXCEPTIONS = (
        _mongo_errors.ConnectionFailure,
        _mongo_errors.ServerSelectionTimeoutError,
        _mongo_errors.ExecutionTimeout,
        # NOT OperationFailure: that is what the server raises for
        # malformed queries — a bug in query construction must raise,
        # not loop through the retry budget
    )
except ImportError:       # pymongo optional; tracker errors at init
    CATCH_MONGODB_EXCEPTIONS = ()
except AttributeError:    # a fake/partial pymongo without errors
    CATCH_MONGODB_EXCEPTIONS = ()


def _now():
    return datetime.now(timezone.utc)


def _is_file_key(key):
    return key.endswith("_file") or key.endswith("_files")


class MongoDBTracker(ResultTracker):
    """Job tracker storing job documents in MongoDB and result files in
    GridFS (so results survive deletion of the compute filesystem)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

        try:
            from pymongo import MongoClient
            import gridfs
        except ImportError as e:
            raise ImportError(
                "MongoDBTracker requires the pymongo package; install it "
                "or select a different tracker_type."
            ) from e

        self.client = MongoClient(self.connection_string)
        self.db = self.client.get_default_database()
        self.jobs = self.db[DEFAULT_RESULT_COLLECTION]
        self.fs = gridfs.GridFS(
            self.db, collection=DEFAULT_FILE_COLLECTION
        )

    def _retry(self, func):
        # retry is limited to connectivity/operation errors: a bug in
        # query construction must raise, not loop (reference :126-131);
        # an empty tuple (no real pymongo) disables retry entirely
        return retry(
            func, self.retry_max_number, self.retry_wait,
            exceptions=CATCH_MONGODB_EXCEPTIONS,
        )

    def get(self):
        """Return the current job document (or None); raises if the
        job_id matches more than one document (reference
        utils/tracker/mongodb.py:89-107). No retry on connection
        failure, matching the reference."""
        docs = list(self.jobs.find({"job_id": self.job_id}))
        if len(docs) == 0:
            return None
        if len(docs) > 1:
            raise ValueError(
                "Job ID not unique, found more than one job."
            )
        return docs[0]

    # -- GridFS mirroring ------------------------------------------

    def _store_file(self, filename, parent_id):
        """Insert one file into GridFS, linked to the job document;
        returns the {"filename", "fs_id"} entry recorded in its place
        (reference :133-173). An unreadable file is a hard error: the
        caller asked for it to be preserved."""
        def put():
            with open(filename, "rb") as f:
                return self.fs.put(
                    f,
                    parent_id=parent_id,
                    job_id=self.job_id,
                    filename=filename,
                    time_saved=_now(),
                )

        try:
            fs_id = self._retry(put)
        except OSError as e:
            raise ResourceError(
                "Could not read {} for storing in MongoDB "
                "backend".format(filename)
            ) from e
        return {"filename": filename, "fs_id": fs_id}

    def _drop_file(self, file_entry, parent_id):
        """Delete a previously stored GridFS file by the fs_id recorded
        in its result entry. Entries written in path mode (plain
        strings, no fs_id) are left alone — switching a database from
        path-based to GridFS-based handling must not crash
        (reference :175-202)."""
        def drop():
            try:
                self.fs.delete(file_entry["fs_id"])
            except TypeError:
                pass

        self._retry(drop)

    def _map_file_entries(self, file_mapping, parent_id, func):
        """Apply func (store/drop) to every file of every "*_file" /
        "*_files" entry (reference :204-252). "*_files" values are a
        list of paths or a mapping path -> annotation; the annotation
        is carried along as a "value" field. The drop function returns
        None (a legacy path-mode entry has no fs_id to delete) — guard
        the merge so migration never crashes the update."""
        out = {}
        for key, value in file_mapping.items():
            if value is None:
                continue
            if key.endswith("_file"):
                out[key] = func(value, parent_id)
            elif key.endswith("_files"):
                if isinstance(value, Mapping):
                    out[key] = [
                        {**(func(path, parent_id) or {}),
                         "value": annotation}
                        for path, annotation in value.items()
                    ]
                else:
                    out[key] = [func(path, parent_id) for path in value]
        return out

    def _results_update(self, results, current_state):
        """Build the partial update of the "results" subdocument,
        mirroring files per the file_list/delete_list contract
        (reference :254-334)."""
        delete_list = self.delete_list or []

        if self.file_list is None:
            # path mode: record everything that will still exist
            # after the run; nothing goes to GridFS
            return {
                k: v for k, v in results.items() if k not in delete_list
            }, []

        file_entries = {
            k: v for k, v in results.items() if _is_file_key(k)
        }
        plain_entries = {
            k: v for k, v in results.items() if k not in file_entries
        }
        to_store = {
            k: v for k, v in file_entries.items() if k in self.file_list
        }
        # stale GridFS copies of the keys being rewritten
        previous = {
            k: v
            for k, v in current_state.get("results", {}).items()
            if k in to_store
        }

        stored = self._map_file_entries(
            to_store, current_state["_id"], self._store_file
        )
        self._map_file_entries(
            previous, current_state["_id"], self._drop_file
        )

        # legacy schema written by this tracker's pre-GridFS-contract
        # version: fs_id under file_ids.<key> with results.<key> a
        # plain path. Replacing such a key must delete the legacy blob
        # too (results.<key> carries no fs_id, so the drop above missed
        # it) and retire its file_ids entry — otherwise every rerun of
        # an upgraded job database leaks one GridFS copy per file.
        legacy = {
            k: v
            for k, v in (current_state.get("file_ids") or {}).items()
            if k in to_store and v is not None
        }
        # ordering note: the legacy blob is dropped BEFORE the $unset
        # of file_ids.<key> lands in the document update. If that
        # final update fails after retries, the document briefly
        # points at a deleted blob — benign on rerun (gridfs delete is
        # idempotent and this branch re-fires), and the alternative
        # (drop after update) would leak the blob permanently when the
        # process dies between the two steps.
        for fs_id in legacy.values():
            self._drop_file(
                {"filename": None, "fs_id": fs_id}, current_state["_id"]
            )

        # file keys explicitly updated to None: their old blob was
        # dropped above, so the document entry must be cleared too —
        # otherwise it dangles on a deleted fs_id
        cleared = {k: None for k, v in to_store.items() if v is None}

        return ({**plain_entries, **stored, **cleared},
                ["file_ids." + k for k in legacy])

    # -- the update entry point ------------------------------------

    def update(self, status=None, message=None, stage=None, results=None):
        # phase 1: upsert the job document and fetch its current
        # state — needed for the conditional fields below and for the
        # fs_ids of files being replaced (reference :336-359)
        def upsert():
            return self.jobs.find_one_and_update(
                {"job_id": self.job_id},
                {
                    "$setOnInsert": {
                        "job_id": self.job_id,
                        "prefix": self.prefix,
                        "config": self.config,
                        "pipeline": self.pipeline,
                        "time_created": _now(),
                    },
                    "$set": {"time_updated": _now()},
                },
                upsert=True,
                # pymongo's ReturnDocument.AFTER is literally True;
                # the legacy raw-command kwarg new=True only worked by
                # accident of kwarg passthrough
                return_document=True,
            )

        current_state = self._retry(upsert)

        sets = {}
        if status is not None:
            sets["status"] = status
            if status == EStatus.RUN:
                # first RUN only (like `location` below, and like the
                # SQL backend): a rerun must not erase the original
                # start time
                if current_state.get("time_started") is None:
                    sets["time_started"] = _now()
                # the pipeline runner is the only process whose cwd IS
                # the job location; fill it in on first entering RUN
                # (reference :373-379)
                if current_state.get("location") is None:
                    sets["location"] = os.getcwd()
        elif current_state.get("status") is None:
            # document just created without a status: mark INIT
            sets["status"] = EStatus.INIT

        if stage is not None:
            sets["stage"] = stage
        if message is not None:
            sets["message"] = str(message)

        unsets = []
        if results is not None:
            updates, unsets = self._results_update(
                results, current_state)
            for k, v in updates.items():
                sets["results." + k] = v

        if sets or unsets:
            op = {}
            if sets:
                op["$set"] = sets
            if unsets:
                op["$unset"] = {k: "" for k in unsets}

            def apply():
                return self.jobs.update_one(
                    {"_id": current_state["_id"]}, op
                )

            self._retry(apply)
