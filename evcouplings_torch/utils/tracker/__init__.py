"""
Job tracking backends (port of evcouplings_tpu/utils/tracker/__init__.py),
selected via the management.tracker_type config: EStatus, the final and
failure state sets, the credential environment variables and retry
defaults, and get_result_tracker (no tracker type gives the NullTracker,
"sql" the sqlite-backed SQLTracker, "mongodb" the MongoDBTracker; each
backend is imported when it is selected).
"""

from copy import deepcopy
from os import environ

from evcouplings_torch.utils.config import InvalidParameterError
from evcouplings_torch.utils.tracker.base import (  # noqa: F401
    NullTracker,
    ResultTracker,
)

TRACKER_USERNAME_KEY = "EVCOUPLINGS_TRACKER_USERNAME"
TRACKER_PASSWORD_KEY = "EVCOUPLINGS_TRACKER_PASSWORD"

# default retry policy: 5 retries 60 s apart — bounded, unlike the
# reference's retry-FOREVER None default (an unreachable tracker DB
# must eventually fail a job loudly), yet resilient to transient
# lock/network errors, which a single-attempt default was not
TRACKER_MAX_NUM_RETRIES = 5
TRACKER_RETRY_WAIT = 60


class EStatus:
    """Job status values."""
    INIT = "initialized"
    PEND = "pending"
    RUN = "running"
    DONE = "done"
    FAIL = "failed"        # job failed due to bug
    TERM = "terminated"    # job was terminated externally
    BAILOUT = "bailout"    # pipeline stopped itself (hopeless results)


FINAL_STATES = {EStatus.DONE, EStatus.TERM, EStatus.FAIL, EStatus.BAILOUT}
FAILURE_STATES = {EStatus.TERM, EStatus.FAIL, EStatus.BAILOUT}


def get_result_tracker(config):
    """Create the tracker selected by the job configuration.

    tracker_type None -> NullTracker; "sql" -> SQLTracker;
    "mongodb" -> MongoDBTracker. Credentials may be substituted into
    the connection string from environment variables.
    """
    # copy so the tracker cannot accidentally mutate the job config;
    # empty "management:" / "global:" YAML sections parse as None
    config = deepcopy(config)
    management = config.get("management") or {}

    tracker_type = management.get("tracker_type")
    if tracker_type is None:
        return NullTracker()

    # the two settings a tracker cannot run without
    for required in ("connection_string", "job_id"):
        if management.get(required) is None:
            raise InvalidParameterError(
                "Using a tracker requires '{}' in the management "
                "section of the config.".format(required)
            )

    backend = _load_backend(tracker_type)
    return backend(
        # optional credentials via environment variables
        connection_string=management["connection_string"].format(
            username=environ.get(TRACKER_USERNAME_KEY),
            password=environ.get(TRACKER_PASSWORD_KEY),
        ),
        job_id=management["job_id"],
        prefix=(config.get("global") or {}).get("prefix"),
        pipeline=config.get("pipeline"),
        file_list=management.get("tracker_file_list"),
        delete_list=management.get("delete", []),
        config=config,
        retry_max_number=management.get(
            "tracker_max_retries", TRACKER_MAX_NUM_RETRIES
        ),
        retry_wait=management.get(
            "tracker_retry_wait", TRACKER_RETRY_WAIT
        ),
    )


def _load_backend(tracker_type):
    """Import and return the tracker class for tracker_type (imports
    stay lazy so optional backend dependencies load on demand)."""
    if tracker_type == "mongodb":
        from evcouplings_torch.utils.tracker.mongodb import MongoDBTracker
        return MongoDBTracker
    if tracker_type == "sql":
        from evcouplings_torch.utils.tracker.sql import SQLTracker
        return SQLTracker
    raise InvalidParameterError(
        "Not a valid job result tracker: '{}'. "
        "Valid options are: None, 'sql', 'mongodb'".format(tracker_type)
    )
