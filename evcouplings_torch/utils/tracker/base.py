"""
Result-tracker interface (port of evcouplings_tpu/utils/tracker/base.py):
the no-op tracker. The storage-backed trackers (the JAX package's
ResultTracker subclasses) are not ported yet (ROADMAP A19).
"""


class NullTracker:
    """No-op tracker (used when no tracker is configured)."""

    def update(self, status=None, message=None, stage=None, results=None):
        pass
