"""Nested phase spans -> JSONL event log.

Port of ``deepinteract_tpu/obs/spans.py`` (stdlib only), without its
``jax.profiler`` annotations.

A span marks one timed phase of work on one thread: ``with span("epoch",
epoch=3): ...``. Spans nest per thread, so the training loop produces
``epoch -> step -> {data_wait, h2d, device_step}`` plus ``checkpoint`` /
``eval`` siblings, and each completed span appends one JSON line to the
configured sink (``obs/events.jsonl`` under the run directory)::

    {"name": "device_step", "path": "epoch/step/device_step",
     "ts": <wall clock s>, "dur_s": <float>, "epoch": 3, ...}

Design constraints, in order:

* **Free when unconfigured.** Without a sink, a span is two
  ``perf_counter`` calls and a list push/pop — safe to leave in hot host
  loops permanently. Nothing here ever touches the device.
* **Heartbeat-readable.** The most recently entered span path is kept in
  a process global (:func:`latest_path`) so the heartbeat thread can
  report *where* a run currently is without cross-thread locals.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

_lock = threading.Lock()
_sink_path: Optional[str] = None
_sink_file = None
_sink_bytes = 0
_sink_max_bytes = 0
_sink_truncated = False
_last_flush = 0.0
_stacks: Dict[int, List[str]] = {}  # thread id -> active span names
_latest_path = ""

# Keys every event carries; span attrs may not shadow them.
_RESERVED = ("name", "path", "ts", "dur_s")

# Default sink size cap. Per-step spans are a few hundred bytes each; the
# cap bounds a months-long run's event log (typically on shared storage
# next to the checkpoints) instead of letting it grow without limit. A
# single truncation-marker event records that the cap was hit.
DEFAULT_MAX_MB = 256

# Flush cadence: at most one flush per this many seconds (plus always on
# close). The log's consumer is a human tailing a live run — sub-second
# staleness is invisible to them, and a flush syscall per span event is
# not free on a hot host loop.
_FLUSH_INTERVAL_S = 1.0


def configure(path: str, max_mb: float = DEFAULT_MAX_MB) -> None:
    """Open (append) the JSONL sink; replaces any previous sink.

    ``max_mb`` caps how much THIS process appends to the sink (<=0 for
    unlimited); past the cap a single marker event is written and further
    events are dropped until the next configure()."""
    global _sink_path, _sink_file, _sink_bytes, _sink_max_bytes
    global _sink_truncated, _last_flush
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with _lock:
        if _sink_file is not None:
            _sink_file.close()
        _sink_file = open(path, "a", encoding="utf-8")
        _sink_path = path
        _sink_bytes = 0
        _sink_max_bytes = int(max_mb * 1e6) if max_mb > 0 else 0
        _sink_truncated = False
        _last_flush = time.monotonic()


def close() -> None:
    """Close the sink; spans keep nesting but stop being recorded."""
    global _sink_path, _sink_file
    with _lock:
        if _sink_file is not None:
            _sink_file.close()
        _sink_file = None
        _sink_path = None


def configured() -> bool:
    return _sink_file is not None


def sink_path() -> Optional[str]:
    return _sink_path


def current_path() -> str:
    """This thread's active span path (``epoch/step/device_step``)."""
    stack = _stacks.get(threading.get_ident())
    return "/".join(stack) if stack else ""


def latest_path() -> str:
    """The most recently entered span path across ALL threads — what the
    heartbeat reports as "where the process is right now"."""
    return _latest_path


def _write(event: Dict[str, Any]) -> None:
    global _sink_bytes, _sink_truncated, _last_flush
    with _lock:
        if _sink_file is None or _sink_truncated:
            return
        line = json.dumps(event, separators=(",", ":"), default=str) + "\n"
        if _sink_max_bytes and _sink_bytes + len(line) > _sink_max_bytes:
            _sink_truncated = True
            _sink_file.write(json.dumps({
                "name": "span_log_truncated", "path": "span_log_truncated",
                "ts": time.time(), "dur_s": 0.0,
                "max_mb": _sink_max_bytes / 1e6,
            }) + "\n")
            _sink_file.flush()
            return
        _sink_file.write(line)
        _sink_bytes += len(line)
        now = time.monotonic()
        if now - _last_flush >= _FLUSH_INTERVAL_S:
            # Time-based flush keeps a tailed log near-live without a
            # flush syscall per event; close() flushes the remainder.
            _sink_file.flush()
            _last_flush = now


def _make_event(name: str, path: str, ts: float, dur_s: float,
                attrs: Dict[str, Any]) -> Dict[str, Any]:
    event: Dict[str, Any] = {"name": name, "path": path, "ts": ts,
                             "dur_s": dur_s}
    for k, v in attrs.items():
        if k not in _RESERVED:
            event[k] = v
    return event


class Span:
    """Context manager for one timed phase; ``dur_s`` is readable after
    exit so callers can accumulate per-phase totals without re-timing."""

    __slots__ = ("name", "attrs", "path", "dur_s", "_t0", "_ts", "_closed")

    def __init__(self, name: str, **attrs):
        self.name = str(name)
        self.attrs = attrs
        self.path = ""
        self.dur_s = 0.0
        self._closed = False

    def __enter__(self) -> "Span":
        global _latest_path
        stack = _stacks.setdefault(threading.get_ident(), [])
        stack.append(self.name)
        self.path = "/".join(stack)
        _latest_path = self.path
        self._ts = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        global _latest_path
        # Idempotent: callers that manage spans manually (the Trainer's
        # epoch loop exits on break AND in its finally) may double-close.
        if self._closed:
            return
        self._closed = True
        self.dur_s = time.perf_counter() - self._t0
        tid = threading.get_ident()
        stack = _stacks.get(tid)
        if stack and stack[-1] == self.name:
            stack.pop()
        if not stack:
            _stacks.pop(tid, None)
            _latest_path = ""
        else:
            _latest_path = "/".join(stack) if stack else ""
        _write(_make_event(self.name, self.path, self._ts, self.dur_s,
                           self.attrs))


def span(name: str, **attrs) -> Span:
    """``with span("device_step", step_num=i): ...`` — see module doc."""
    return Span(name, **attrs)


def emit(name: str, dur_s: float, **attrs) -> None:
    """Record a phase measured externally (e.g. time blocked inside a
    generator's ``next()``, where a ``with`` block cannot wrap the wait)
    as a leaf span under the calling thread's current path."""
    base = current_path()
    path = f"{base}/{name}" if base else name
    _write(_make_event(str(name), path, time.time() - dur_s, float(dur_s),
                       attrs))


def read_events(path: str) -> List[Dict[str, Any]]:
    """Parse a span JSONL file back into event dicts (the round-trip the
    telemetry tests pin). Raises ``ValueError`` on a malformed line or an
    event missing the reserved keys."""
    events = []
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
            except json.JSONDecodeError as exc:
                raise ValueError(f"{path}:{lineno}: not valid JSON: {exc}")
            missing = [k for k in _RESERVED if k not in event]
            if missing:
                raise ValueError(
                    f"{path}:{lineno}: span event missing keys {missing}")
            events.append(event)
    return events
