"""
Job tracking (port of evcouplings_tpu/utils/tracker/__init__.py),
selected via the management.tracker_type config: EStatus, the final and
failure state sets, and get_result_tracker. No tracker type gives the
NullTracker; the "sql" and "mongodb" backends are not ported yet
(ROADMAP A19) and raise NotImplementedError.
"""

from evcouplings_torch.utils.config import InvalidParameterError
from evcouplings_torch.utils.tracker.base import NullTracker


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

    tracker_type None -> NullTracker; "sql" and "mongodb" are not
    ported yet and raise NotImplementedError; anything else raises
    InvalidParameterError.
    """
    # empty "management:" YAML sections parse as None
    management = config.get("management") or {}

    tracker_type = management.get("tracker_type")
    if tracker_type is None:
        return NullTracker()
    if tracker_type in ("sql", "mongodb"):
        raise NotImplementedError(
            "the {!r} job tracker is not ported yet (ROADMAP A19)".format(
                tracker_type))
    raise InvalidParameterError(
        "Not a valid job result tracker: '{}'. "
        "Valid options are: None, 'sql', 'mongodb'".format(tracker_type)
    )
