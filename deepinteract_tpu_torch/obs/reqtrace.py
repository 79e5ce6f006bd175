"""Request-scoped tracing: one trace_id per serving request, end to end.

Port of ``deepinteract_tpu/obs/reqtrace.py`` (stdlib only). A
:class:`RequestTrace` is minted when the HTTP handler accepts a
request, rides inside the scheduler payload through the engine's flush,
and comes back in the response — so one id connects the client's JSON,
the ``events.jsonl`` span events, and the ``di_request_*`` histograms in
``/metrics``. The decomposition it carries answers the operator question
"where did this request's latency go":

* ``queue_wait_ms`` — submit -> dequeue by the flush worker (micro-batch
  delay + queue depth);
* ``batch_assembly_ms`` — featurize/pad/stack of the coalesced group;
* ``compile_ms`` — graph acquisition (≈0 on a warm bucket; the CUDA
  graph capture when this request was the unlucky first of its key);
* ``device_ms`` — graph replay + the copy of the batch's results to the
  host (the copy waits for the replay: no extra syncs).

Batch-shared phases (assembly/compile/device) are recorded once per
request at the batch's value with ``coalesced`` saying how many requests
shared them; attributing a 1/N split would misstate what the request
actually waited on.

Cost discipline matches the rest of :mod:`deepinteract_tpu_torch.obs`: a mark
is one ``perf_counter`` call; histogram recording is a dict update; span
events are only written when a sink is configured.
"""

from __future__ import annotations

import time
import uuid
from typing import Dict, Optional

from deepinteract_tpu_torch.obs import metrics as obs_metrics
from deepinteract_tpu_torch.obs import spans as obs_spans

# One histogram family per phase, labeled by route — /predict and
# other routes stay separate series without minting per-request cardinality.
_PHASE_HIST = {
    "queue_wait": obs_metrics.histogram(
        "di_request_queue_wait_seconds",
        "Request time spent queued before its flush", ("route",)),
    "batch_assembly": obs_metrics.histogram(
        "di_request_batch_assembly_seconds",
        "Featurize/pad/stack time of the request's coalesced batch",
        ("route",)),
    "compile": obs_metrics.histogram(
        "di_request_compile_seconds",
        "Graph acquisition time (≈0 warm, the CUDA graph capture cold)",
        ("route",)),
    "device": obs_metrics.histogram(
        "di_request_device_seconds",
        "Device dispatch + host fetch time of the request's batch",
        ("route",)),
}
_TOTAL_HIST = obs_metrics.histogram(
    "di_request_total_seconds",
    "End-to-end traced-request time (mint to finish)", ("route",))

# The decomposition phases, in pipeline order (also the span event set a
# finished request writes — tests read them back by trace_id).
PHASES = ("queue_wait", "batch_assembly", "compile", "device")


def mint_trace_id() -> str:
    return uuid.uuid4().hex[:16]


class RequestTrace:
    """Mutable per-request mark sheet; thread-compatible by handoff (the
    handler thread marks submit, the flush worker marks the rest — never
    concurrently)."""

    __slots__ = ("trace_id", "route", "t_start", "phase_s", "coalesced",
                 "cached", "_marks", "_finished")

    def __init__(self, route: str, trace_id: Optional[str] = None):
        self.trace_id = trace_id or mint_trace_id()
        self.route = route
        self.t_start = time.perf_counter()
        self.phase_s: Dict[str, float] = {}
        self.coalesced = 1
        self.cached = False
        self._marks: Dict[str, float] = {"start": self.t_start}
        self._finished = False

    def mark(self, name: str) -> None:
        self._marks[name] = time.perf_counter()

    def since(self, name: str) -> float:
        t = self._marks.get(name)
        return 0.0 if t is None else max(0.0, time.perf_counter() - t)

    def set_phase(self, name: str, seconds: float) -> None:
        self.phase_s[name] = max(0.0, float(seconds))

    def phase_between(self, name: str, start_mark: str,
                      end_mark: str) -> None:
        a, b = self._marks.get(start_mark), self._marks.get(end_mark)
        self.set_phase(name, (b - a) if a is not None and b is not None
                       else 0.0)

    # -- completion --------------------------------------------------------

    def finish(self, coalesced: int = 1, cached: bool = False,
               **extra_ms) -> Dict:
        """Record histograms, write span events, and return the response
        decomposition dict. Idempotent: a retried finish (scheduler
        failure paths re-raise through futures) records once."""
        total_s = max(0.0, time.perf_counter() - self.t_start)
        self.coalesced = int(coalesced)
        self.cached = bool(cached)
        decomposition = {
            "trace_id": self.trace_id,
            "route": self.route,
            "total_ms": round(total_s * 1e3, 3),
            "coalesced": self.coalesced,
            "cached": self.cached,
        }
        for phase in PHASES:
            decomposition[f"{phase}_ms"] = round(
                self.phase_s.get(phase, 0.0) * 1e3, 3)
        for key, val in extra_ms.items():
            decomposition[f"{key}_ms"] = round(float(val) * 1e3, 3)
        if self._finished:
            return decomposition
        self._finished = True
        for phase in PHASES:
            _PHASE_HIST[phase].observe(self.phase_s.get(phase, 0.0),
                                       route=self.route)
        _TOTAL_HIST.observe(total_s, route=self.route)
        if obs_spans.configured():
            for phase in PHASES:
                obs_spans.emit(f"request_{phase}",
                               self.phase_s.get(phase, 0.0),
                               trace_id=self.trace_id, route=self.route)
            obs_spans.emit("request", total_s, trace_id=self.trace_id,
                           route=self.route, coalesced=self.coalesced,
                           cached=self.cached,
                           **{k: decomposition[f"{k}_ms"] / 1e3
                              for k in ("queue_wait", "batch_assembly",
                                        "compile", "device")})
        return decomposition
