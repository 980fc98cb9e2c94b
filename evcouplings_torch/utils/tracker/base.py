"""
Result-tracker interface (port of evcouplings_tpu/utils/tracker/base.py):
the ResultTracker base of the storage-backed trackers and the no-op
tracker.
"""

from abc import ABC, abstractmethod

DEFAULT_RESULT_COLLECTION = "evcouplings_jobs"
DEFAULT_FILE_COLLECTION = "evcouplings_files"


class ResultTracker(ABC):
    """Tracks job status and results in some storage backend."""

    def __init__(self, connection_string, job_id, prefix, pipeline,
                 file_list, delete_list, config,
                 retry_max_number=None, retry_wait=None):
        # every constructor argument becomes an attribute of the
        # same name (the backend subclasses read them directly)
        settings = dict(locals())
        del settings["self"]
        vars(self).update(settings)

    @abstractmethod
    def update(self, status=None, message=None, stage=None, results=None):
        """Update job status/stage/results; creates the entry if new.
        results are shallow-merged into the stored result dict."""
        raise NotImplementedError


class NullTracker:
    """No-op tracker (used when no tracker is configured)."""

    def update(self, status=None, message=None, stage=None, results=None):
        pass
