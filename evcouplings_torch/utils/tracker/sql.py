"""
SQL-backed job tracker.

Port of evcouplings_tpu/utils/tracker/sql.py; its parity target:
reference evcouplings/utils/tracker/sql.py
(SQLTracker :45-283, ComputeJob row schema :285-343). The reference
requires SQLAlchemy; this implementation speaks DB-API directly and
ships a dependency-free sqlite3 backend (connection strings
`sqlite:///path/to.db` or `sqlite://:memory:`). Other SQL backends are
used through SQLAlchemy when it is installed.

Table schema matches the reference ComputeJob ORM row: job_id, prefix,
pipeline, location, status, message, runner_id, stage, time_created,
time_started, time_updated, config, fingerprint, results.
"""

import json
import os
import socket
import sqlite3
from contextlib import contextmanager
from datetime import datetime, timezone

from evcouplings_torch.utils.config import InvalidParameterError
from evcouplings_torch.utils.helpers import retry
from evcouplings_torch.utils.tracker.base import ResultTracker

JOB_TABLE_NAME = "evcouplings_jobs"

_CREATE_TABLE = """
CREATE TABLE IF NOT EXISTS {table} (
    key INTEGER PRIMARY KEY,
    job_id TEXT UNIQUE,
    prefix TEXT,
    pipeline TEXT,
    location TEXT,
    status TEXT,
    message TEXT,
    runner_id TEXT,
    stage TEXT,
    time_created TEXT,
    time_started TEXT,
    time_updated TEXT,
    config TEXT,
    fingerprint TEXT,
    results TEXT
)
""".format(table=JOB_TABLE_NAME)


def _now():
    return datetime.now(timezone.utc).isoformat()


class SQLTracker(ResultTracker):
    """Job tracker persisting to a SQL database.

    Every update runs in its own connection/transaction so concurrent
    pipeline processes can share one database; failures are retried
    with the configured backoff.
    """

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

        cs = self.connection_string
        if cs is None or not cs.startswith("sqlite://"):
            # startswith("sqlite") alone let typos like
            # "sqlite:memory" through to a bare IndexError below
            raise InvalidParameterError(
                "SQLTracker currently supports sqlite connection strings "
                "(sqlite:///path/to.db or sqlite://:memory:); "
                "got: {}".format(cs)
            )

        # sqlite:///relative.db | sqlite:////abs/path.db | sqlite://:memory:
        path = cs.split("sqlite://", 1)[1]
        if path.startswith("/") and not path.startswith("//"):
            path = path[1:]
        elif path.startswith("//"):
            path = path[1:]
        self.db_path = path if path else ":memory:"

        self._memory_conn = None
        if self.db_path == ":memory:":
            # every new sqlite connection to :memory: is a fresh empty
            # database — the job table must live on ONE shared
            # connection or the first update() would see no table
            self._memory_conn = self._new_conn()
        else:
            # pin the ABSOLUTE path: stages chdir (fold's CNS runs),
            # and a relative path re-resolved at connect time would
            # hit a different (table-less) file mid-run
            self.db_path = os.path.abspath(self.db_path)
            os.makedirs(os.path.dirname(self.db_path), exist_ok=True)

        self._execute(lambda conn: conn.execute(_CREATE_TABLE))

    def _new_conn(self):
        conn = sqlite3.connect(self.db_path, timeout=60)
        conn.row_factory = sqlite3.Row
        # autocommit mode: transactions are controlled explicitly.
        # With Python's implicit transaction handling the SELECT of a
        # read-merge-write (update() below) runs OUTSIDE the write
        # transaction (the implicit BEGIN fires at the first DML), so
        # two concurrent processes merging `results` into one row can
        # both read the same snapshot and the second commit silently
        # drops the first one's keys — a lost update. BEGIN IMMEDIATE
        # before the read serializes the whole read-merge-write
        # (exercised by tests/test_tracker_db.py concurrency tests).
        conn.isolation_level = None
        return conn

    def _connect(self):
        if self._memory_conn is not None:
            return self._memory_conn
        return self._new_conn()

    def _execute(self, func):
        def attempt():
            conn = self._connect()
            try:
                result = func(conn)
                conn.commit()
                return result
            finally:
                if conn is not self._memory_conn:
                    conn.close()

        return retry(
            attempt,
            self.retry_max_number,
            self.retry_wait,
            exceptions=(
                sqlite3.OperationalError, sqlite3.IntegrityError,
            ),
        )

    @contextmanager
    def session_scope(self):
        """Transactional scope around a series of operations
        (reference utils/tracker/sql.py:98-110, which wraps a
        SQLAlchemy session; here a sqlite3 connection with the same
        commit/rollback contract)."""
        # same connection settings as the tracker's own operations
        # (60 s busy timeout — an external reader must wait out a
        # concurrent writer's lock, not crash at sqlite's 5 s default)
        conn = self._connect()
        try:
            # the connections run in autocommit mode (_new_conn), so a
            # transaction must be opened explicitly — without it every
            # statement inside the scope commits immediately and the
            # rollback below is a silent no-op. IMMEDIATE for the same
            # writer serialization as update()'s read-merge-write.
            conn.execute("BEGIN IMMEDIATE")
            yield conn
            conn.commit()
        except Exception:
            conn.rollback()
            raise
        finally:
            if conn is not self._memory_conn:
                conn.close()

    def get(self):
        """Return the current job row as a dict (or None)."""
        def _get(conn):
            cur = conn.execute(
                "SELECT * FROM {} WHERE job_id = ?".format(JOB_TABLE_NAME),
                (self.job_id,),
            )
            row = cur.fetchone()
            return dict(row) if row is not None else None

        return self._execute(_get)

    def update(self, status=None, message=None, stage=None, results=None):
        def _update(conn):
            # take the write lock BEFORE reading: the merge below must
            # see the latest committed `results` (see _connect)
            conn.execute("BEGIN IMMEDIATE")
            cur = conn.execute(
                "SELECT key, results, time_started FROM {} "
                "WHERE job_id = ?".format(JOB_TABLE_NAME),
                (self.job_id,),
            )
            row = cur.fetchone()
            now = _now()

            if row is None:
                # INSERT OR IGNORE: two processes sharing a job_id
                # (batch sub-jobs inherit it from one config) can race
                # this SELECT-then-INSERT; the loser must not crash on
                # the UNIQUE(job_id) constraint
                conn.execute(
                    "INSERT OR IGNORE INTO {} (job_id, prefix, "
                    "pipeline, location, "
                    "runner_id, config, time_created, results) "
                    "VALUES (?, ?, ?, ?, ?, ?, ?, ?)".format(
                        JOB_TABLE_NAME
                    ),
                    (
                        self.job_id, self.prefix, self.pipeline,
                        os.path.dirname(self.prefix or "") or None,
                        socket.gethostname(),
                        json.dumps(self.config, default=str),
                        now, json.dumps({}),
                    ),
                )
                # re-read: if the insert was ignored, another process
                # created the row (possibly with results already)
                cur = conn.execute(
                    "SELECT key, results, time_started FROM {} "
                    "WHERE job_id = ?".format(JOB_TABLE_NAME),
                    (self.job_id,),
                )
                row = cur.fetchone()
                merged = json.loads(row["results"] or "{}")
                time_started = row["time_started"]
            else:
                merged = json.loads(row["results"] or "{}")
                time_started = row["time_started"]

            sets, args = ["time_updated = ?"], [now]

            if status is not None:
                from evcouplings_torch.utils.tracker import EStatus

                sets.append("status = ?")
                args.append(status)
                if status == EStatus.RUN and time_started is None:
                    sets.append("time_started = ?")
                    args.append(now)
            if message is not None:
                sets.append("message = ?")
                args.append(str(message))
            if stage is not None:
                sets.append("stage = ?")
                args.append(stage)
            if results is not None:
                # shallow merge, excluding files slated for deletion
                merged.update({
                    k: v for k, v in results.items()
                    if k not in (self.delete_list or [])
                })
                sets.append("results = ?")
                args.append(json.dumps(merged, default=str))

            args.append(self.job_id)
            conn.execute(
                "UPDATE {} SET {} WHERE job_id = ?".format(
                    JOB_TABLE_NAME, ", ".join(sets)
                ),
                args,
            )

        self._execute(_update)


class ComputeJob:
    """Row-object view of one tracked job (reference
    utils/tracker/sql.py:285, a SQLAlchemy declarative model; here a
    plain record over the same column set, constructible from the
    dict rows SQLTracker returns)."""

    COLUMNS = (
        "key", "job_id", "prefix", "pipeline", "location", "status",
        "message", "runner_id", "stage", "time_created",
        "time_started", "time_updated", "config", "fingerprint",
        "results",
    )

    def __init__(self, **fields):
        for col in self.COLUMNS:
            setattr(self, col, fields.get(col))
        for k, v in fields.items():
            if k not in self.COLUMNS:
                setattr(self, k, v)

    @classmethod
    def from_row(cls, row):
        return None if row is None else cls(**dict(row))

    def __repr__(self):
        return "ComputeJob(job_id={!r}, status={!r}, stage={!r})".format(
            self.job_id, self.status, self.stage
        )
