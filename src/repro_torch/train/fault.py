"""Fault tolerance: preemption handling.

Port of the ``PreemptionHandler`` of ``repro/train/fault.py``: a SIGTERM
flips a flag, and the transform service (``serve.TransformService``'s
``preemption=``) drains what is pending and stops at its next loop
turn.  The rest of that module (straggler detection, elastic re-meshing)
belongs to the training slice (``ROADMAP.md`` queue 1 item 8).
"""

from __future__ import annotations

import signal


class PreemptionHandler:
    """SIGTERM/SIGINT -> graceful drain-and-exit flag."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._requested = False
        self._installed = False
        self._signals = signals

    def install(self):
        if self._installed:
            return
        for sig in self._signals:
            try:
                signal.signal(sig, self._handle)
            except ValueError:
                pass  # non-main thread (tests)
        self._installed = True

    def _handle(self, signum, frame):
        self._requested = True

    @property
    def preemption_requested(self) -> bool:
        return self._requested
