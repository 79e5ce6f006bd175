"""Overload-safe serving: admission control, deadlines, load shedding.

Port of ``deepinteract_tpu/serving/admission.py`` (stdlib only; it records
into the port's ``obs/metrics.py``). Without it the scheduler's per-bucket
FIFOs would accept unboundedly: a traffic spike queues arbitrarily deep,
every accepted request eventually burns a device dispatch (even after its
client hung up), and the only client-visible bound is the server's blanket
``request_timeout_s``.

* :class:`AdmissionController` — bounded per-bucket queues plus a global
  in-flight cap, enforced at submit time. Excess load is rejected
  *immediately* with a typed :class:`Overloaded` carrying a computed
  ``retry_after_s`` (queue backlog over the observed service rate), so
  clients back off instead of piling on.
* :class:`Deadline` — a monotonic-clock request deadline (client
  ``X-Request-Deadline-Ms`` header / ``deadline_s`` JSON field, default
  from ``--default_deadline_ms``). Checked at admission, again at batch
  assembly (an expired request is failed with :class:`DeadlineExceeded`
  *before* it occupies a padded batch slot), and bounded in
  ``predict()``'s wait — a request never hangs past its deadline.
* :class:`LoadShedder` — an adaptive degraded-mode switch driven by the
  same ``obs`` signals ``/metrics`` serves (admission utilization, queue
  depth, ``di_request_*`` p99, capture in flight). While degraded the
  server answers ``POST /predict`` with 429 + ``Retry-After`` and
  ``/healthz`` reports ``overloaded`` — but ``/stats``/``/metrics`` stay
  live, because observability during an incident is the point.
  Hysteresis (separate enter/exit thresholds plus a minimum dwell) keeps
  it from flapping.

Client retry contract: 429 (``Overloaded`` / shedding) means *retry
after* ``Retry-After`` seconds — the work was never accepted; 504
(``DeadlineExceeded``) means the deadline passed — retrying with the
same deadline will likely fail again; 503 (draining /
:class:`ShuttingDown`) means *retry against another replica*.

Everything here is host-side stdlib guarded by per-object locks; no
device work.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Hashable, Optional

from deepinteract_tpu_torch.obs import metrics as obs_metrics

_ACCEPTED = obs_metrics.counter(
    "di_admission_accepted_total",
    "Requests admitted into the bounded serving queues")
_REJECTED = obs_metrics.counter(
    "di_admission_rejected_total",
    "Requests rejected at admission", labelnames=("reason",))
_DEADLINE_EXPIRED = obs_metrics.counter(
    "di_admission_deadline_expired_total",
    "Requests failed because their deadline passed", labelnames=("where",))
_SHED_DEGRADED = obs_metrics.gauge(
    "di_shed_degraded", "1 while the load shedder holds the server degraded")
_SHED_TRANSITIONS = obs_metrics.counter(
    "di_shed_transitions_total",
    "Load-shedder state changes", labelnames=("to",))
_SHED_REJECTED = obs_metrics.counter(
    "di_shed_rejected_total",
    "Requests answered 429 while the shedder held the server degraded")


# ---------------------------------------------------------------------------
# Typed errors (the serving plane's failure vocabulary — servers map these
# onto HTTP statuses; engine callers catch them by type)
# ---------------------------------------------------------------------------


class Overloaded(RuntimeError):
    """Rejected at admission: queues are full (or shedding is active).

    ``retry_after_s`` is the server's backlog-drain estimate — the
    ``Retry-After`` header value, so a well-behaved client retries when
    capacity plausibly exists instead of immediately."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = max(0.0, float(retry_after_s))


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before it could be (fully) served.

    ``trace`` optionally carries the request's latency decomposition (the
    phases it DID complete — always with ``device_ms == 0`` when the
    request was dropped before dispatch)."""

    def __init__(self, message: str, trace: Optional[Dict] = None):
        super().__init__(message)
        self.trace = trace


class ShuttingDown(RuntimeError):
    """Accepted work failed because the server is going away (drain
    timeout): the client gets an answer instead of hanging on a future
    whose worker is gone. Retry against another replica."""


class BatchExecutionError(RuntimeError):
    """A coalesced batch failed at assembly or device dispatch. Fails
    every future in its group; the scheduler worker survives and the
    engine keeps serving subsequent batches."""

    def __init__(self, message: str, stage: str = "dispatch"):
        super().__init__(message)
        self.stage = stage


# ---------------------------------------------------------------------------
# Deadlines
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Deadline:
    """A monotonic-clock expiry. Constructed ONCE at the server edge from
    the client's budget; everything downstream (admission, the scheduler
    sweep, ``predict``'s wait bound) compares against the same instant,
    so clock skew between layers cannot exist."""

    expires_at: float  # time.monotonic() instant
    budget_s: float    # original budget (trace/reporting only)

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        seconds = float(seconds)
        return cls(expires_at=time.monotonic() + seconds, budget_s=seconds)

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self.expires_at

    def remaining_s(self) -> float:
        return max(0.0, self.expires_at - time.monotonic())


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------


def _estimate_retry_after(inflight: int, rate_rps: float) -> float:
    """Backlog over observed service rate, clamped to [0.1, 60] s. With
    no rate evidence yet (cold start, first compile still running) answer
    1 s — retrying into a compile stampede is the failure mode this
    avoids. Pure function of its arguments so callers holding the
    controller lock can use it on their consistent snapshot."""
    if rate_rps <= 0.0:
        return 1.0
    return min(60.0, max(0.1, inflight / rate_rps))


class AdmissionController:
    """Bounded per-bucket queues + global in-flight cap, with a service-
    rate estimate for ``Retry-After``.

    The scheduler reports every request transition: ``try_admit`` at
    submit (raises :class:`Overloaded` over either bound), ``on_dequeue``
    when entries leave a bucket queue (into a flush group, an expired
    drop, or a drain sweep), ``on_done`` when their futures resolve, and
    ``observe_batch`` after each completed flush (feeds the EWMA service
    rate). In-flight = admitted and not yet answered, so it covers both
    queued and executing work — the thing a capacity bound must cover.
    """

    def __init__(self, max_queue_depth: int = 64, max_inflight: int = 256):
        if max_queue_depth < 1 or max_inflight < 1:
            raise ValueError(
                "max_queue_depth and max_inflight must be >= 1, got "
                f"{max_queue_depth}/{max_inflight}")
        self.max_queue_depth = int(max_queue_depth)
        self.max_inflight = int(max_inflight)
        self._lock = threading.Lock()
        self._queued: Dict[Hashable, int] = defaultdict(int)
        self._inflight = 0
        self._admitted = 0
        self._rejected_queue = 0
        self._rejected_inflight = 0
        # EWMA requests/second over completed flushes; 0 = no evidence yet.
        self._rate = 0.0

    # -- lifecycle hooks (called by the scheduler) -------------------------

    def try_admit(self, bucket: Hashable) -> None:
        """Admit one request into ``bucket``'s queue or raise
        :class:`Overloaded` with a computed ``retry_after_s``."""
        with self._lock:
            if self._inflight >= self.max_inflight:
                self._rejected_inflight += 1
                retry = _estimate_retry_after(self._inflight, self._rate)
                label = "inflight_full"
                reason = (f"{self._inflight} requests in flight >= "
                          f"max_inflight {self.max_inflight}")
            elif self._queued[bucket] >= self.max_queue_depth:
                self._rejected_queue += 1
                retry = _estimate_retry_after(self._inflight, self._rate)
                label = "queue_full"
                reason = (f"bucket {bucket!r} queue depth "
                          f"{self._queued[bucket]} >= max_queue_depth "
                          f"{self.max_queue_depth}")
            else:
                self._queued[bucket] += 1
                self._inflight += 1
                self._admitted += 1
                _ACCEPTED.inc()
                return
        _REJECTED.inc(reason=label)
        raise Overloaded(f"overloaded: {reason}", retry_after_s=retry)

    def on_dequeue(self, bucket: Hashable, n: int = 1) -> None:
        """``n`` entries left ``bucket``'s queue (flush group / expired
        drop / drain sweep); they remain in flight until ``on_done``."""
        with self._lock:
            left = self._queued[bucket] - int(n)
            if left > 0:
                self._queued[bucket] = left
            else:
                self._queued.pop(bucket, None)

    def on_done(self, n: int = 1) -> None:
        """``n`` admitted requests got their answer (result OR typed
        failure) — capacity is free again."""
        with self._lock:
            self._inflight = max(0, self._inflight - int(n))

    def cancel(self, bucket: Hashable) -> None:
        """Undo one ``try_admit`` that never actually enqueued (e.g. the
        scheduler turned out to be closed)."""
        self.on_dequeue(bucket, 1)
        self.on_done(1)

    def observe_batch(self, n_requests: int, seconds: float) -> None:
        """Feed one completed flush into the service-rate EWMA."""
        if n_requests <= 0 or seconds <= 0:
            return
        rate = n_requests / seconds
        with self._lock:
            self._rate = rate if self._rate == 0.0 else (
                0.7 * self._rate + 0.3 * rate)

    # -- retry-after -------------------------------------------------------

    def retry_after_s(self) -> float:
        with self._lock:
            return _estimate_retry_after(self._inflight, self._rate)

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "max_queue_depth": self.max_queue_depth,
                "max_inflight": self.max_inflight,
                "inflight": self._inflight,
                "queued": sum(self._queued.values()),
                "queued_by_bucket": {str(k): v
                                     for k, v in self._queued.items()},
                "admitted": self._admitted,
                "rejected_queue_full": self._rejected_queue,
                "rejected_inflight_full": self._rejected_inflight,
                "service_rate_rps": round(self._rate, 3),
                "retry_after_s": round(
                    _estimate_retry_after(self._inflight, self._rate), 3),
            }


# ---------------------------------------------------------------------------
# Load shedding
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShedderConfig:
    """Degraded-mode policy (CLI surface: ``cli/serve.py``).

    Utilization = admitted-in-flight / ``max_inflight`` — the leading
    indicator (it saturates before latency does). Two more triggers read
    the other overload signals: ``enter_queue_depth`` (total queued
    across buckets; 0 disables) and the compile-stall rule — a cold
    compile (in the port, the CUDA graph capture of a new key; the names
    are the JAX package's) in flight WHILE utilization is already past the exit
    threshold degrades immediately, because one long compile stalls
    every flush behind the exec lock and queueing behind it only makes
    the spike worse. The p99 trigger reads the same registry histogram
    ``/metrics`` serves; 0 disables it (the histogram is cumulative-
    since-start, so it is a confirming signal, not the fast path).
    Enter on ANY trigger; exit only when EVERY signal is back under its
    exit threshold AND the minimum dwell has passed — classic
    hysteresis so a boundary load cannot flap the server between
    modes."""

    enabled: bool = True
    enter_utilization: float = 0.9
    exit_utilization: float = 0.5
    enter_queue_depth: int = 0  # 0 disables the queue-depth trigger
    shed_on_compile_stall: bool = True
    enter_p99_ms: float = 0.0  # 0 disables the latency trigger
    exit_p99_ms: float = 0.0
    min_degraded_s: float = 2.0

    def __post_init__(self):
        if not 0.0 < self.exit_utilization <= self.enter_utilization:
            raise ValueError(
                "need 0 < exit_utilization <= enter_utilization, got "
                f"{self.exit_utilization}/{self.enter_utilization}")


class LoadShedder:
    """Two-state (healthy/degraded) switch over live overload signals.

    ``signals_fn`` returns the current ``{"utilization", "queue_depth",
    "p99_ms", "compile_inflight"}`` snapshot (the server wires it to the
    admission controller + the ``obs`` registry). ``evaluate()`` is
    called on every POST and every ``/healthz`` — it is a handful of
    float compares, so polling it per-request costs nothing and keeps
    the mode current without a background thread to manage."""

    def __init__(self, cfg: ShedderConfig,
                 signals_fn: Callable[[], Dict[str, float]],
                 now_fn: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self._signals_fn = signals_fn
        self._now = now_fn
        self._lock = threading.Lock()
        self._degraded = False
        self._since = self._now()
        self._transitions = 0
        self._last_signals: Dict[str, float] = {}
        self._last_reason = ""

    # -- state machine -----------------------------------------------------

    def _enter_reason(self, sig: Dict[str, float]) -> str:
        cfg = self.cfg
        util = float(sig.get("utilization", 0.0))
        if util >= cfg.enter_utilization:
            return (f"utilization {util:.2f} >= {cfg.enter_utilization:.2f}")
        queued = float(sig.get("queue_depth", 0.0))
        if cfg.enter_queue_depth > 0 and queued >= cfg.enter_queue_depth:
            return (f"queue depth {queued:.0f} >= {cfg.enter_queue_depth}")
        compiling = float(sig.get("compile_inflight", 0.0))
        if (cfg.shed_on_compile_stall and compiling > 0
                and util >= cfg.exit_utilization):
            return (f"cold compile in flight at utilization {util:.2f} "
                    "(flushes stalled behind the exec lock)")
        p99 = float(sig.get("p99_ms", 0.0))
        if cfg.enter_p99_ms > 0 and p99 >= cfg.enter_p99_ms:
            return f"p99 {p99:.0f}ms >= {cfg.enter_p99_ms:.0f}ms"
        return ""

    def _can_exit(self, sig: Dict[str, float]) -> bool:
        cfg = self.cfg
        if float(sig.get("utilization", 0.0)) > cfg.exit_utilization:
            return False
        if (cfg.enter_queue_depth > 0
                and float(sig.get("queue_depth", 0.0))
                >= cfg.enter_queue_depth):
            return False
        # No compile-inflight exit clause: the utilization check above
        # already holds recovery until load is genuinely low, and pinning
        # degraded on ANY compile would strand a warmup-compiling but
        # idle server in degraded mode.
        return not (cfg.exit_p99_ms > 0
                    and float(sig.get("p99_ms", 0.0)) > cfg.exit_p99_ms)

    def evaluate(self) -> bool:
        """Refresh state from the live signals; True while degraded."""
        if not self.cfg.enabled:
            return False
        sig = self._signals_fn()
        now = self._now()
        with self._lock:
            self._last_signals = dict(sig)
            if not self._degraded:
                reason = self._enter_reason(sig)
                if reason:
                    self._degraded = True
                    self._since = now
                    self._transitions += 1
                    self._last_reason = reason
                    _SHED_TRANSITIONS.inc(to="degraded")
                    _SHED_DEGRADED.set(1.0)
            else:
                dwell = now - self._since
                if dwell >= self.cfg.min_degraded_s and self._can_exit(sig):
                    self._degraded = False
                    self._since = now
                    self._transitions += 1
                    self._last_reason = "recovered"
                    _SHED_TRANSITIONS.inc(to="healthy")
                    _SHED_DEGRADED.set(0.0)
            return self._degraded

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded

    def count_rejection(self) -> None:
        """One 429 answered while degraded (kept here so every shedder
        consumer shares the ``di_shed_rejected_total`` series)."""
        _SHED_REJECTED.inc()

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.cfg.enabled,
                "degraded": self._degraded,
                "since_s": round(self._now() - self._since, 3),
                "transitions": self._transitions,
                "reason": self._last_reason,
                "signals": dict(self._last_signals),
                "enter_utilization": self.cfg.enter_utilization,
                "exit_utilization": self.cfg.exit_utilization,
                "min_degraded_s": self.cfg.min_degraded_s,
            }


def expired_counter(where: str) -> None:
    """Count one deadline expiry at ``where`` (admission / queue /
    wait) — one helper so every layer shares the same series."""
    _DEADLINE_EXPIRED.inc(where=where)


def overload_signals() -> Dict[str, float]:
    """Process-local overload evidence in one readout — the inputs a
    capacity controller reads from the admission layer.
    ``admission_rejected`` / ``shed_rejected`` are CUMULATIVE counts
    (pollers diff between reads); ``shed_degraded`` is the live 0/1
    shedder state."""
    rejected = sum(value for _, _, value in _REJECTED.samples())
    return {
        "admission_rejected": float(rejected),
        "shed_rejected": _SHED_REJECTED.value(),
        "shed_degraded": _SHED_DEGRADED.value(),
    }
