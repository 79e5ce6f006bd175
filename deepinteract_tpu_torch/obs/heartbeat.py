"""Run heartbeats: a periodic liveness file per process.

Port of ``deepinteract_tpu/obs/heartbeat.py`` (stdlib only). The question
it answers is "is the process stuck, and where?", without asking the
stuck process. A :class:`Heartbeat` writes a small JSON file every ``interval_s``
seconds from a daemon thread::

    {"host": "node-3:12711", "process_index": 0, "process_count": 1,
     "span_path": "epoch/step/device_step", "step": 4210, "epoch": 7,
     "written_ts": 1754200000.1, "last_progress_ts": 1754199876.4,
     "interval_s": 30.0}

``span_path`` is wherever the process currently is
(:func:`deepinteract_tpu_torch.obs.spans.latest_path`); ``last_progress_ts``
only advances when the worker calls :meth:`progress` — so a live file
with a stale progress stamp means "the process breathes but the step
loop does not", and a stale file means the process (or its host) is
gone. Writes are atomic (tmp + rename): a reader never sees a torn file.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import threading
import time
from typing import Any, Callable, Dict, Optional

from deepinteract_tpu_torch.obs import spans


class Heartbeat:
    def __init__(self, path: str, interval_s: float = 30.0,
                 process_index: int = 0, process_count: int = 1,
                 span_path_fn: Optional[Callable[[], str]] = None):
        self.path = path
        self.interval_s = max(0.01, float(interval_s))
        self._span_path_fn = span_path_fn or spans.latest_path
        self._host = f"{socket.gethostname()}:{os.getpid()}"
        self._process_index = int(process_index)
        self._process_count = int(process_count)
        self._lock = threading.Lock()
        self._fields: Dict[str, Any] = {}
        self._last_progress = time.time()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def progress(self, **fields) -> None:
        """Record forward progress (e.g. ``step=1234, epoch=7``) — cheap
        enough for every host-side step callback."""
        now = time.time()
        with self._lock:
            self._fields.update(fields)
            self._last_progress = now

    def payload(self) -> Dict[str, Any]:
        with self._lock:
            fields = dict(self._fields)
            last = self._last_progress
        out: Dict[str, Any] = {
            "host": self._host,
            "process_index": self._process_index,
            "process_count": self._process_count,
            "span_path": self._span_path_fn(),
            "written_ts": time.time(),
            "last_progress_ts": last,
            "interval_s": self.interval_s,
        }
        out.update(fields)
        return out

    def write_now(self) -> None:
        """One atomic write via robustness/artifacts (also called on
        stop, so the final state survives the process): a reader never
        sees torn JSON. ``fsync=False``: a heartbeat's value is its
        freshness, not its durability."""
        from deepinteract_tpu_torch.robustness import artifacts

        artifacts.atomic_write(self.path, json.dumps(self.payload()),
                               fsync=False)

    def start(self) -> "Heartbeat":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="heartbeat",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.write_now()
            except OSError:
                # A full/remounted disk must not kill the beat thread;
                # the stale file IS the signal in that case.
                pass
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        try:
            self.write_now()
        except OSError:
            pass

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()


def read(path: str) -> Dict[str, Any]:
    """Parse a heartbeat file (operator tooling + tests)."""
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class HeartbeatStatus:
    """One liveness verdict, shared by every heartbeat consumer.

    ``status`` is ``"fresh"`` (written within ``max_age_s``), ``"stale"``
    (file exists but the writer stopped beating — the process or its host
    is gone, or the beat thread is wedged), or ``"missing"`` (no file:
    the process never started, or it was configured without a
    heartbeat). ``age_s`` is seconds since the last write (None when
    missing); ``payload`` is the parsed beat (None when missing or
    unreadable)."""

    status: str
    age_s: Optional[float]
    payload: Optional[Dict[str, Any]]

    @property
    def fresh(self) -> bool:
        return self.status == "fresh"


def read_heartbeat(path: str, max_age_s: float,
                   now: Optional[float] = None) -> HeartbeatStatus:
    """Classify a heartbeat file as fresh / stale / missing.

    The one liveness check of the training supervisor. Age is judged from the payload's own ``written_ts`` when
    present (the writer's clock — mtime can lie on copied/restored
    trees), falling back to the file mtime for torn-or-foreign files. A
    file that exists but does not parse is STALE, not missing: writes
    are atomic, so unreadable bytes mean a writer that stopped being a
    heartbeat, which is exactly the dead-process signal."""
    now = time.time() if now is None else now
    try:
        st_mtime = os.stat(path).st_mtime
    except OSError:
        return HeartbeatStatus("missing", None, None)
    payload: Optional[Dict[str, Any]] = None
    written = st_mtime
    unreadable = False
    try:
        loaded = read(path)
        if isinstance(loaded, dict):
            payload = loaded
            ts = loaded.get("written_ts")
            if isinstance(ts, (int, float)) and not isinstance(ts, bool):
                written = float(ts)
        else:
            unreadable = True  # JSON, but not a beat object
    except (OSError, ValueError):
        unreadable = True
    age = max(0.0, now - written)
    if unreadable:
        # Our own writes are atomic, so unreadable bytes mean whatever
        # writes this path stopped being a heartbeat — the dead-process
        # signal, regardless of how recently the foreign writer touched
        # the file.
        return HeartbeatStatus("stale", age, None)
    status = "fresh" if age <= max(0.0, float(max_age_s)) else "stale"
    return HeartbeatStatus(status, age, payload)
