"""Batch placement: the loader -> step boundary as a pipeline stage.

Port of ``deepinteract_tpu/data/pipeline.py`` on one device. The trainer
groups an epoch's batches into same-shape runs (``training/loop.py``,
``_shape_runs``) and hands each run to a :class:`BatchPlacement`:

* **inline** (``transfer=False``): ``batch.to(device)`` at the dispatch
  site, on the training stream: the path the loop always took;
* **transfer** (``transfer=True``, ``--device_prefetch``): run on the
  placement thread of :func:`placed_runs`. On a CUDA device the run's host
  tensors are copied into pinned memory, then copied to the card with
  ``non_blocking`` copies on the thread's own side ``torch.cuda.Stream``,
  and one ``torch.cuda.Event`` recorded behind the last copy travels with
  the :class:`PlacedRun`. Before the first step that reads the run, the
  consumer calls :meth:`BatchPlacement.ready`: the training stream waits on the event and
  every placed tensor is ``record_stream``-ed on the training stream, so
  the caching allocator does not hand a placed tensor's block back to the
  side stream while a step still reads it. The pinned staging buffers
  come from torch's caching host allocator, which keeps a block out of
  reuse until the copy that read it has finished. On a CPU device there is
  nothing to copy and the placed batch is the host batch.

The JAX package's ``place_stacked`` (the ``[K, B, ...]`` scan stack) has no
counterpart: the port's steps are eager and take batches one by one, so a
run of K batches is placed as K per-batch payloads behind one event.
:func:`placed_runs` keeps at most ``depth`` placed runs (pinned and on the
device) ahead of the consumer, counting the one being dispatched.

Telemetry keeps the JAX names: ``di_data_h2d_seconds_total`` and
``di_data_h2d_bytes_total`` (every placement), ``di_data_placed_dispatches_total
{mode}`` and ``di_data_device_prefetched_batches_total`` (batches copied on
the placement thread), and ``di_data_pinned_peak_bytes``, the most pinned
staging bytes a placement held at once. Fault sites: ``data.place`` raises a
:class:`PlacementError` (on the consumer's side even when the placement
ran on the thread) and ``data.place_hang`` freezes the placing thread while
the heartbeat keeps beating.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Any, Iterable, List, NamedTuple, Optional

import torch

from deepinteract_tpu_torch.data.graph import PairedComplex, ProteinGraph
from deepinteract_tpu_torch.obs import metrics as obs_metrics
from deepinteract_tpu_torch.obs import spans as obs_spans
from deepinteract_tpu_torch.robustness import faults

logger = logging.getLogger(__name__)

_H2D_SECONDS = obs_metrics.counter(
    "di_data_h2d_seconds_total",
    "Wall seconds spent placing train batches on the device by the input pipeline's "
    "placement layer (overlaps device compute when --device_prefetch is on)")
_H2D_BYTES = obs_metrics.counter(
    "di_data_h2d_bytes_total",
    "Host bytes handed to device placement by the input pipeline's placement layer")
_PLACED_DISPATCHES = obs_metrics.counter(
    "di_data_placed_dispatches_total",
    "Dispatch payloads (single batches or runs of K batches) placed by the input "
    "pipeline's placement layer", labelnames=("mode",))
_DEVICE_PREFETCHED = obs_metrics.counter(
    "di_data_device_prefetched_batches_total",
    "Batches whose host-to-device copy was issued on the placement thread")
_PINNED_PEAK = obs_metrics.gauge(
    "di_data_pinned_peak_bytes",
    "Most bytes of pinned staging buffers one placement held at once (placed runs not yet "
    "handed to a step)")


class PlacementError(RuntimeError):
    """Typed failure of the placement stage, raised at the trainer's next
    dispatch even when the placement ran on the placement thread."""


class PlacedRun(NamedTuple):
    """One same-shape run of host batches and its placed form.

    ``kind`` is ``"per_batch"`` (a run shorter than the dispatch width:
    each batch is its own dispatch, ``h2d_s`` one float per batch) or
    ``"run"`` (a full run of K batches, one dispatch, ``h2d_s`` one float).
    ``placed`` aligns with ``host``. ``event`` fires when the run's copies
    are done (None when the placement needed no wait); ``staging`` holds
    the pinned host copies the run was read from, ``pinned_bytes`` their
    size (counted as held until :meth:`BatchPlacement.ready`)."""

    host: List[PairedComplex]
    kind: str
    placed: List[PairedComplex]
    h2d_s: tuple
    event: Optional[Any] = None
    staging: tuple = ()
    pinned_bytes: int = 0


def _map(batch, fn):
    """``batch`` with ``fn`` applied to each tensor (a PairedComplex, its
    graphs, or one tensor)."""
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    if isinstance(batch, (PairedComplex, ProteinGraph)):
        return dataclasses.replace(batch, **{f.name: _map(getattr(batch, f.name), fn)
                                             for f in dataclasses.fields(batch)})
    raise TypeError(f"cannot place a {type(batch).__name__}")


def tensors(batch) -> List[torch.Tensor]:
    """Every tensor of a PairedComplex (or graph), in field order."""
    if isinstance(batch, torch.Tensor):
        return [batch]
    return [t for f in dataclasses.fields(batch) for t in tensors(getattr(batch, f.name))]


def batch_nbytes(batch) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(batch))


def is_placed(batch, device) -> bool:
    """True when every tensor of ``batch`` already lives on ``device``:
    placing it again would copy nothing, so a step takes it as it is."""
    device = torch.device(device)
    return all(t.device.type == device.type
               and (device.index is None or t.device.index == device.index)
               for t in tensors(batch))


def _chaos_probe(mode: str) -> None:
    faults.maybe_raise("data.place", lambda: PlacementError(
        f"injected data.place fault (placement mode {mode})"))
    if faults.fire("data.place_hang"):
        logger.error("data.place_hang fault injected: placement frozen until killed")
        while True:
            time.sleep(0.25)


class BatchPlacement:
    """The placement function of one dispatch configuration on ``device``.
    ``transfer`` places eagerly for the placement thread (pinned memory and
    a side stream on a CUDA device); otherwise the copy runs inline."""

    def __init__(self, device, steps_per_dispatch: int = 1, transfer: bool = True):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.steps_per_dispatch = max(1, steps_per_dispatch)
        self.transfer = transfer
        self._local = threading.local()  # each placing thread's side stream
        # Pinned bytes of placed runs not yet ready on a stream, and their
        # high-water mark (mirrored in di_data_pinned_peak_bytes).
        self._lock = threading.Lock()
        self._pinned_held = 0
        self.pinned_peak = 0

    @property
    def mode(self) -> str:
        """``single/per-step`` or ``single/scanned`` (K-step runs): the JAX
        package's labels of the fit-start log line and the dispatch counter."""
        return "single/" + ("scanned" if self.steps_per_dispatch > 1 else "per-step")

    def _side_stream(self):
        stream = getattr(self._local, "stream", None)
        if stream is None:
            torch.cuda.set_device(self.device)
            stream = self._local.stream = torch.cuda.Stream(self.device)
        return stream

    def _copy(self, batches: List[PairedComplex]):
        """(placed batches, event, pinned staging batches) of one placement."""
        if self.device.type != "cuda" or not self.transfer:
            return [b.to(self.device) for b in batches], None, []
        pinned = [_map(b, lambda t: t.pin_memory()) for b in batches]
        with self._lock:
            self._pinned_held += sum(batch_nbytes(b) for b in pinned)
            if self._pinned_held > self.pinned_peak:
                self.pinned_peak = self._pinned_held
                _PINNED_PEAK.set(self.pinned_peak)
        stream = self._side_stream()
        with torch.cuda.stream(stream):
            placed = [_map(b, lambda t: t.to(self.device, non_blocking=True)) for b in pinned]
            event = torch.cuda.Event()
            event.record(stream)
        _DEVICE_PREFETCHED.inc(len(batches))
        return placed, event, pinned

    def _place(self, batches: List[PairedComplex]):
        _chaos_probe(self.mode)
        try:
            t0 = time.perf_counter()
            if self.transfer:  # on the placement thread: a profiler range of its own
                with obs_spans.annotation("h2d"):
                    out = self._copy(batches)
            else:  # inline: inside the loop's h2d span
                out = self._copy(batches)
            _H2D_SECONDS.inc(time.perf_counter() - t0)
            _H2D_BYTES.inc(sum(batch_nbytes(b) for b in batches))
            _PLACED_DISPATCHES.inc(mode=self.mode)
            return out
        except PlacementError:
            raise
        except Exception as exc:
            raise PlacementError(f"batch placement failed (mode {self.mode}): {exc}") from exc

    def place_batch(self, batch: PairedComplex) -> PairedComplex:
        """One batch placed for a single-step dispatch and ready on the
        current stream."""
        return self.ready(self.place_run([batch]))[0]

    def place_run(self, run: List[PairedComplex]) -> PlacedRun:
        """One same-shape run as its :class:`PlacedRun`: a run shorter than
        the dispatch width is placed batch by batch (one fault probe and
        one counted dispatch each), a full run at once behind one event."""
        k = self.steps_per_dispatch
        if len(run) < max(k, 2):
            placed, times, staging, event = [], [], [], None
            for b in run:
                t0 = time.perf_counter()
                (p,), event, pinned = self._place([b])
                times.append(time.perf_counter() - t0)
                placed.append(p)
                staging += pinned
            # Copies on one stream complete in order: the last event covers all.
            kind, h2d_s = "per_batch", tuple(times)
        else:
            t0 = time.perf_counter()
            placed, event, staging = self._place(run)
            kind, h2d_s = "run", (time.perf_counter() - t0,)
        return PlacedRun(run, kind, placed, h2d_s, event, tuple(staging),
                         sum(batch_nbytes(b) for b in staging))

    def ready(self, pr: PlacedRun) -> List[PairedComplex]:
        """Make ``pr``'s placed batches safe to read on the current stream:
        the stream waits on the run's copy event, and each placed tensor is
        recorded as in use by it. Returns the placed batches."""
        if pr.event is not None:
            current = torch.cuda.current_stream(pr.placed[0].contact_map.device)
            current.wait_event(pr.event)
            for batch in pr.placed:
                for t in tensors(batch):
                    t.record_stream(current)
        if pr.pinned_bytes:
            with self._lock:
                self._pinned_held -= pr.pinned_bytes
        return pr.placed


def placed_runs(runs: Iterable[List[PairedComplex]], placement: BatchPlacement, depth: int):
    """Place ``runs`` on a daemon thread and yield their :class:`PlacedRun`
    in order. A semaphore slot is taken before each placement and given
    back only when the consumer asks for the next item, so at most
    ``depth`` placed runs are held, the one being dispatched included.
    Exceptions of the source or the placement re-raise on the consumer's
    side; abandoning the generator stops the worker."""
    depth = max(1, int(depth))
    sem = threading.Semaphore(depth)
    q: "queue.Queue" = queue.Queue()
    done = object()
    stop = threading.Event()

    def worker():
        try:
            if placement.device.type == "cuda":
                torch.cuda.set_device(placement.device)
            for run in runs:
                while not sem.acquire(timeout=0.1):
                    if stop.is_set():
                        return
                if stop.is_set():
                    return
                q.put(placement.place_run(run))
        except BaseException as exc:  # noqa: BLE001 - re-raised on the consumer's side
            q.put((done, exc))
            return
        q.put((done, None))

    threading.Thread(target=worker, daemon=True, name="di-placement").start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is done:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
            # Only now: the run just yielded counted against the bound
            # while its steps ran.
            sem.release()
    finally:
        stop.set()
