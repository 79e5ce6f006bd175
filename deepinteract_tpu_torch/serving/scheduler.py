"""Micro-batching scheduler: coalesce concurrent requests per shape bucket.

Port of ``deepinteract_tpu/serving/scheduler.py`` (stdlib only). The
engine's CUDA graphs are keyed on padded bucket shapes, so only
same-bucket requests can share a device dispatch. This scheduler
holds a per-bucket pending queue and flushes a bucket's group when either

* it reaches ``max_batch`` requests (a full batch is ready now), or
* its oldest request has waited ``max_delay_ms`` (latency bound: a lone
  request never waits longer than the delay budget for company).

All flushes run on ONE worker thread, which serializes device dispatch —
correct for a single-accelerator process (concurrent dispatches would just
queue on the card) and keeps the engine's graphs free of replay races. HTTP handler threads block on the returned futures.

The queue discipline is per-bucket FIFO with oldest-deadline-first
selection across buckets, so a hot bucket cannot starve a cold one beyond
the delay budget.

Overload discipline (serving/admission.py): when an
:class:`~deepinteract_tpu_torch.serving.admission.AdmissionController` is
attached, ``submit`` enforces its bounded per-bucket queues and global
in-flight cap (typed ``Overloaded`` rejection at submit time, never a
silent unbounded queue), and per-request deadlines are swept at batch
assembly — an expired request is failed with ``DeadlineExceeded``
*before* it occupies a padded batch slot or a device dispatch. A flush
failure (assembly or dispatch) fails only its own group's futures and is
counted on ``di_serving_batch_failures_total``; the worker thread
survives by construction, so one poisoned batch cannot wedge the engine.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict, deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

from deepinteract_tpu_torch.obs import metrics as obs_metrics
from deepinteract_tpu_torch.serving.admission import (
    AdmissionController,
    Deadline,
    DeadlineExceeded,
    ShuttingDown,
    expired_counter,
)

logger = logging.getLogger(__name__)

_FLUSHES = obs_metrics.counter(
    "di_serving_flushes_total", "Coalesced groups handed to the flush fn")
_GROUP_SIZE = obs_metrics.histogram(
    "di_serving_coalesced_group_size", "Requests per coalesced flush",
    buckets=(1, 2, 4, 8, 16, 32, 64))
_BATCH_FAILURES = obs_metrics.counter(
    "di_serving_batch_failures_total",
    "Coalesced flushes that failed their whole group (worker survived)")


class SchedulerClosed(RuntimeError):
    """submit() after drain(): the serving process is shutting down."""


class MicroBatchScheduler:
    """Groups pending requests by bucket key and flushes on ``max_batch``
    or ``max_delay_ms``.

    ``flush_fn(key, payloads) -> results`` executes one coalesced batch
    and must return one result per payload (in order); it runs on the
    worker thread. An exception from ``flush_fn`` fails every future in
    the group (the batch shares one dispatch, so there is no per-item
    failure to attribute) — and ONLY that group: the worker loop is
    exception-proof and keeps serving subsequent groups.

    ``admission`` (optional) bounds the queues; ``on_expired(payload,
    deadline) -> Exception`` (optional) lets the owner build the typed
    failure for a deadline-swept entry (the engine attaches the request's
    trace decomposition there)."""

    def __init__(
        self,
        flush_fn: Callable[[Hashable, List[Any]], List[Any]],
        max_batch: int = 8,
        max_delay_ms: float = 5.0,
        admission: Optional[AdmissionController] = None,
        on_expired: Optional[Callable[[Any, Deadline], Exception]] = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._flush_fn = flush_fn
        self.max_batch = int(max_batch)
        self.max_delay_s = max(0.0, float(max_delay_ms)) / 1e3
        self.admission = admission
        self._on_expired = on_expired
        self._cv = threading.Condition()
        # key -> deque[(payload, future, enqueue_time, deadline|None)]
        self._pending: Dict[Hashable, deque] = defaultdict(deque)
        self._closed = False
        self._flushes = 0
        self._coalesced: Dict[int, int] = defaultdict(int)  # batch size -> count
        self._submitted = 0
        self._expired = 0
        self._batch_failures = 0
        self._worker = threading.Thread(
            target=self._loop, name="microbatch-flush", daemon=True
        )
        self._worker.start()

    # -- producer side ----------------------------------------------------

    def submit(self, key: Hashable, payload: Any,
               deadline: Optional[Deadline] = None) -> Future:
        """Enqueue one request. Raises :class:`Overloaded` when the
        admission controller's bounds are hit (typed, with
        ``retry_after_s``) and :class:`SchedulerClosed` after drain."""
        fut: Future = Future()
        if self.admission is not None:
            # Admission BEFORE the queue lock: the controller has its own
            # lock and never takes _cv, so the two never nest.
            self.admission.try_admit(key)
        try:
            with self._cv:
                if self._closed:
                    raise SchedulerClosed(
                        "scheduler is draining; no new requests")
                self._pending[key].append(
                    (payload, fut, time.monotonic(), deadline))
                self._submitted += 1
                self._cv.notify()
        except BaseException:
            if self.admission is not None:
                self.admission.cancel(key)
            raise
        return fut

    def drain(self, timeout: float = 60.0) -> bool:
        """Stop accepting requests, flush everything pending, and join the
        worker. Idempotent; safe to call from any thread (SIGTERM drain).

        Returns False when the worker is still flushing at the timeout —
        but never silently: every request still QUEUED at that point is
        failed with a typed :class:`ShuttingDown` (clients get an answer
        instead of hanging on ``.result()`` after the process exits), and
        the stranded-work situation is logged loudly. The one group the
        worker is actively flushing keeps its futures pending — failing
        them would race a flush that may still complete."""
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._worker.join(timeout=timeout)
        if self._worker.is_alive():
            with self._cv:
                leftovers = [(key, entry)
                             for key, q in self._pending.items()
                             for entry in q]
                self._pending.clear()
            for key, (payload, fut, _, _) in leftovers:
                if not fut.cancelled():
                    fut.set_exception(ShuttingDown(
                        "server shutting down before this request could "
                        "be served; retry against another replica"))
                if self.admission is not None:
                    self.admission.on_dequeue(key, 1)
                    self.admission.on_done(1)
            logger.error(
                "drain timed out after %.0fs with %d queued request(s) "
                "failed ShuttingDown (plus any group still in flight) — "
                "exiting now drops accepted work",
                timeout, len(leftovers))
            return False
        return True

    # -- worker side ------------------------------------------------------

    def _take_ready_group(self) -> Tuple[List, Optional[Hashable], Any]:
        """Sweep expired-deadline entries out of every queue, then pop
        the group that should flush now. Returns ``(expired_entries,
        key, group)`` or ``(expired, None, wait_seconds)`` when nothing
        is ready. Expired entries never enter a group — they are failed
        by the caller BEFORE the batch they would have padded is
        assembled. Ready-bucket choice and the wake-up time are tracked
        SEPARATELY: a not-yet-ready bucket's earlier deadline must
        influence when to wake, but never which ready bucket flushes
        first (conflating them let a pending bucket shadow an
        older-deadline ready one). The Condition's lock is an RLock, so
        the explicit ``with`` below is a no-cost re-entry under _loop's
        hold — and makes the guarding verifiable instead of asserted."""
        now = time.monotonic()
        expired: List[Tuple[Hashable, Tuple]] = []
        ready_key = None
        ready_deadline = None
        wake_deadline = None
        with self._cv:
            for key in list(self._pending):
                q = self._pending[key]
                if any(e[3] is not None and now >= e[3].expires_at
                       for e in q):
                    kept = deque()
                    for entry in q:
                        dl = entry[3]
                        if dl is not None and now >= dl.expires_at:
                            expired.append((key, entry))
                        else:
                            kept.append(entry)
                    self._pending[key] = q = kept
                if not q:
                    del self._pending[key]
                    continue
                deadline = q[0][2] + self.max_delay_s
                if len(q) >= self.max_batch or now >= deadline or self._closed:
                    # Oldest-deadline-first across READY buckets.
                    if ready_key is None or deadline < ready_deadline:
                        ready_key, ready_deadline = key, deadline
                elif wake_deadline is None or deadline < wake_deadline:
                    wake_deadline = deadline
                # A queued request's own deadline must also bound the
                # sleep: its expiry sweep (and typed failure) should
                # happen near the deadline, not at the next flush-delay
                # wake-up.
                for entry in q:
                    dl = entry[3]
                    if dl is not None and (wake_deadline is None
                                           or dl.expires_at < wake_deadline):
                        wake_deadline = dl.expires_at
            if ready_key is not None:
                q = self._pending[ready_key]
                group = [q.popleft()
                         for _ in range(min(len(q), self.max_batch))]
                if not q:
                    del self._pending[ready_key]
                return expired, ready_key, group
        wait = None if wake_deadline is None else max(0.0, wake_deadline - now)
        return expired, None, wait

    def _fail_expired(self, entries: List[Tuple[Hashable, Tuple]]) -> None:
        """Outside the lock: answer every deadline-swept entry with a
        typed failure (the owner's on_expired hook may attach the
        request's trace) and release its admission slot. Every step is
        per-entry exception-guarded — this runs on the ONE worker
        thread, and a hook surprise or a future state race must cost at
        most that entry, never the worker (the same survival contract
        the flush catch-all gives batches)."""
        for key, (payload, fut, t_enq, dl) in entries:
            with self._cv:
                self._expired += 1
            expired_counter("queue")
            exc: Exception
            try:
                if self._on_expired is not None:
                    exc = self._on_expired(payload, dl)
                else:
                    exc = DeadlineExceeded(
                        f"deadline expired after {dl.budget_s * 1e3:.0f}ms "
                        "while queued; the request was dropped before batch "
                        "assembly")
            except BaseException:  # noqa: BLE001 - worker must survive
                logger.exception("on_expired hook failed; failing the "
                                 "future with a plain DeadlineExceeded")
                exc = DeadlineExceeded(
                    f"deadline expired after {dl.budget_s * 1e3:.0f}ms "
                    "while queued")
            try:
                if not fut.cancelled():
                    fut.set_exception(exc)
            except BaseException:  # noqa: BLE001 - future state race
                logger.exception("failing an expired future raised")
            if self.admission is not None:
                self.admission.on_dequeue(key, 1)
                self.admission.on_done(1)

    def _loop(self) -> None:
        while True:
            with self._cv:
                expired, key, group_or_wait = self._take_ready_group()
                if not expired and key is None:
                    if self._closed and not self._pending:
                        return
                    self._cv.wait(timeout=group_or_wait)
                    continue
            if expired:
                self._fail_expired(expired)
            if key is None:
                continue
            group = group_or_wait
            if self.admission is not None:
                self.admission.on_dequeue(key, len(group))
            payloads = [p for p, _, _, _ in group]
            t0 = time.perf_counter()
            try:
                results = self._flush_fn(key, payloads)
                if len(results) != len(payloads):
                    raise RuntimeError(
                        f"flush_fn returned {len(results)} results for "
                        f"{len(payloads)} payloads"
                    )
            except BaseException as exc:  # noqa: BLE001 - fanned out to futures
                # The group fails; the WORKER survives. Before this
                # catch-all counted failures, an exception escaping the
                # future fan-out below could kill the thread silently and
                # wedge every subsequent request behind a dead worker.
                with self._cv:
                    self._batch_failures += 1
                _BATCH_FAILURES.inc()
                logger.exception(
                    "flush of %d request(s) for bucket %r failed; failing "
                    "the group's futures, worker continues", len(group), key)
                for _, fut, _, _ in group:
                    try:
                        if not fut.cancelled():
                            fut.set_exception(exc)
                    except BaseException:  # noqa: BLE001 - state race
                        logger.exception("failing a group future raised")
                if self.admission is not None:
                    self.admission.on_done(len(group))
                continue
            finally:
                with self._cv:
                    self._flushes += 1
                    self._coalesced[len(group)] += 1
                _FLUSHES.inc()
                _GROUP_SIZE.observe(len(group))
            try:
                for (_, fut, _, _), result in zip(group, results):
                    if not fut.cancelled():
                        fut.set_result(result)
            except BaseException:  # noqa: BLE001 - worker must survive
                logger.exception("result fan-out failed for bucket %r", key)
            if self.admission is not None:
                self.admission.observe_batch(
                    len(group), time.perf_counter() - t0)
                self.admission.on_done(len(group))

    # -- observability ----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            depth = {str(k): len(q) for k, q in self._pending.items() if q}
            return {
                "queue_depth": sum(len(q) for q in self._pending.values()),
                "queue_depth_by_bucket": depth,
                "submitted": self._submitted,
                "flushes": self._flushes,
                "batch_size_histogram": dict(sorted(self._coalesced.items())),
                "max_batch": self.max_batch,
                "max_delay_ms": self.max_delay_s * 1e3,
                "draining": self._closed,
                "deadline_expired": self._expired,
                "batch_failures": self._batch_failures,
            }
