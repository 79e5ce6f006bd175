"""Preemption-safe training: catch SIGTERM/SIGINT, flush, resume.

Port of ``deepinteract_tpu/robustness/preemption.py``. Schedulers preempt
with SIGTERM and a short grace period. With :class:`PreemptionGuard`
installed around ``Trainer.fit``:

* the first SIGTERM/SIGINT sets a flag; nothing is raised from the signal
  context;
* the training loop polls the flag before each train step and at each
  epoch boundary and raises :class:`TrainingPreempted` there;
* ``fit`` drains the checkpoint save in flight before it re-raises, so the
  newest ``last/`` (or ``mid/``) step is on disk when the process exits;
* a rerun with ``resume=True`` restores the state and the loop's
  bookkeeping and reproduces the uninterrupted run.

A second signal bypasses the guard (the previous handler is restored and
the signal re-delivered), so a hung flush can still be killed.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

logger = logging.getLogger(__name__)

_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class TrainingPreempted(RuntimeError):
    """Raised at a safe point after a preemption request; the newest
    checkpoint has been flushed."""


class PreemptionGuard:
    """Context manager installing cooperative SIGTERM/SIGINT handlers.

    Handlers can only be installed from the main thread; elsewhere the
    guard is a flag that fault injection or the host application can
    still :meth:`request`."""

    def __init__(self, log=logger.warning):
        self._event = threading.Event()
        self._reason: Optional[str] = None
        self._previous = {}
        self._log = log
        self._logged = True  # nothing pending to announce yet

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    @property
    def reason(self) -> Optional[str]:
        return self._reason

    def request(self, reason: str = "preemption requested") -> None:
        """Ask the training loop to stop at the next safe point (safe from
        other threads and from fault injection; logs at once)."""
        if not self._event.is_set():
            self._reason = reason
            self._event.set()
            self._logged = True
            self._log(f"preemption: {reason}; will checkpoint and exit at the next safe point")

    def check(self) -> None:
        """Raise :class:`TrainingPreempted` if a stop was requested."""
        if self._event.is_set():
            if not self._logged:
                self._logged = True
                self._log(f"preemption: {self._reason}; will checkpoint and exit at the "
                          "next safe point")
            raise TrainingPreempted(self._reason or "preempted")

    def _handler(self, signum, frame):
        if self._event.is_set():
            # Second signal: re-deliver through the previous handler (a
            # handler installed from C reads as None: use the default).
            signal.signal(signum, self._previous.get(signum) or signal.SIG_DFL)
            signal.raise_signal(signum)
            return
        # Flag only: printing here could re-enter a stream the interrupted
        # thread is writing. check() logs.
        self._reason = f"received {signal.Signals(signum).name}"
        self._event.set()
        self._logged = False

    def __enter__(self) -> "PreemptionGuard":
        try:
            for sig in _SIGNALS:
                self._previous[sig] = signal.signal(sig, self._handler)
        except ValueError:  # not the main thread: flag-only
            self._previous = {}
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
        self._previous = {}
