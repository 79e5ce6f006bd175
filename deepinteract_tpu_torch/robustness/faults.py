"""Deterministic fault injection for the chaos tests.

Port of ``deepinteract_tpu/robustness/faults.py`` without its telemetry
counter. Fault sites are named probe points in the failure-prone layers;
each site counts its calls, and a fault plan maps sites to the 1-based
call numbers that should fail. Plans are exact (no randomness), so every
chaos test reproduces bit for bit.

Plan syntax (``DI_FAULTS`` environment variable or :func:`configure`)::

    site=N          first N calls fault       loader.batch=2
    site=@i,j,k     exactly calls i, j, k     train.nan_batch=@3
    plan;plan;...   multiple sites            loader.batch=2;train.sigterm=@6

Sites of the port:

* ``native.compile``     raises OSError before the geometry library's
  compiler runs (``pipeline/native.py``; a transient failure, retried)
* ``hhblits.run``        raises CalledProcessError (exit 137, an OOM kill)
  before hhblits runs (``pipeline/postprocess.py``; retried)
* ``loader.batch``       raises ValueError while a batch is assembled
  (``data/loader.py``; the skip budget's test hook)
* ``train.nan_batch``    poisons every float tensor of the batch with NaN
* ``train.sigterm``      requests preemption (a simulated SIGTERM) at that
  train batch
* ``training.step_crash`` raises RuntimeError at that train batch: a crash
  with a traceback, which the training supervisor restarts into --resume
* ``training.hang``      freezes the step loop forever at that train batch
  while the heartbeat thread keeps beating: a wedged step, which only the
  training supervisor's watchdog (``training/supervisor.py``) ends
* ``data.place``         raises ``PlacementError`` while a train run is
  placed on the device (``data/pipeline.py``), inline or on the placement
  thread
* ``data.place_hang``    freezes the placement thread forever while the
  heartbeat keeps beating: a wedged input pipeline
* ``checkpoint.restore`` marks a checkpoint step corrupt when restore
  verifies it, driving the last-good walk (``training/checkpoint.py``)
* ``storage.write``      raises OSError before an atomic write opens its
  tmp file (``robustness/artifacts.py``)
* ``storage.fsync``      raises OSError once the tmp holds the content,
  before fsync: the torn-tmp crash point
* ``storage.replace``    raises OSError before the atomic rename
* ``storage.read``       poisons a verified read with a CorruptArtifact
* ``serving.admission``  rejects a submit with ``Overloaded``
  (``serving/engine.py``), before the result cache is read
* ``serving.assembly``   fails a coalesced batch while it is padded and
  stacked: ``BatchExecutionError(stage="assembly")``, its group only
* ``serving.dispatch``   fails a coalesced batch before its graph replay:
  ``BatchExecutionError(stage="dispatch")``, its group only
* ``fleet.spawn``        raises OSError before a worker process is spawned
  (``serving/fleet.py``; the restart backoff path)
* ``fleet.probe``        raises ConnectionError at a worker health probe (a
  healthy worker looks unreachable to the supervisor)
* ``fleet.kill``         raises OSError when the supervisor signals a
  worker (a drain's SIGTERM fails; the SIGKILL fallback must still retire
  the worker)
* ``fleet.preempt``      fires once per supervisor poll tick: the newest
  routable worker is preempted (SIGTERM, no circuit penalty, immediate
  replacement)
* ``autoscale.decision`` raises RuntimeError when an autoscaler decision
  would commit (``serving/autoscaler.py``); the tick counts it and leaves
  the fleet unchanged

With no plan configured every probe is a lookup in an empty map.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
from typing import Dict, Optional, Set, Union

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_plan: Optional[Dict[str, Set[int]]] = None  # None: read the environment lazily
_counts: Dict[str, int] = {}


def _parse(spec: str) -> Dict[str, Set[int]]:
    plan: Dict[str, Set[int]] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        site, eq, val = part.partition("=")
        site, val = site.strip(), val.strip()
        if not eq or not site or not val:
            raise ValueError(f"malformed fault spec {part!r} (want site=N or site=@i,j,k)")
        if val.startswith("@"):
            plan[site] = {int(v) for v in val[1:].split(",") if v.strip()}
        else:
            plan[site] = set(range(1, int(val) + 1))
    return plan


def configure(plan: Union[str, Dict[str, object], None]) -> None:
    """Install a fault plan: a ``DI_FAULTS`` string, or a dict of site ->
    N (the first N calls) or site -> iterable of call numbers. ``None``
    re-arms the lazy read of the environment. Call counts restart."""
    global _plan
    with _lock:
        _counts.clear()
        if plan is None:
            _plan = None
        elif isinstance(plan, str):
            _plan = _parse(plan)
        else:
            _plan = {site: set(range(1, val + 1)) if isinstance(val, int)
                     else {int(v) for v in val} for site, val in plan.items()}


def reset() -> None:
    """Clear the plan and every call count."""
    global _plan
    with _lock:
        _plan = {}
        _counts.clear()


def _active_plan() -> Dict[str, Set[int]]:
    global _plan
    if _plan is None:
        with _lock:
            if _plan is None:
                try:
                    _plan = _parse(os.environ.get("DI_FAULTS", ""))
                except ValueError as exc:
                    # Probes run inside data and storage paths whose error
                    # handling must see their own failures, not a typo in
                    # the plan (the loader's skip budget would count it as
                    # a corrupt batch). configure() still raises.
                    logger.error("ignoring malformed DI_FAULTS=%r: %s",
                                 os.environ.get("DI_FAULTS"), exc)
                    _plan = {}
    return _plan


def fire(site: str) -> bool:
    """Count a call at ``site``; True iff this call is in the plan."""
    plan = _active_plan()
    if not plan:
        return False
    with _lock:
        if site not in plan:
            return False
        _counts[site] = _counts.get(site, 0) + 1
        return _counts[site] in plan[site]


def call_count(site: str) -> int:
    with _lock:
        return _counts.get(site, 0)


def maybe_raise(site: str, make_exc) -> None:
    """Raise ``make_exc()`` if ``site`` faults on this call."""
    if fire(site):
        raise make_exc()


def poison_nan(batch):
    """The batch (a dataclass of tensors, nested) with every floating
    tensor filled with NaN: the bad-batch injection for the non-finite
    guard."""
    import torch  # here, not at import: the fleet's control plane imports this module

    if isinstance(batch, torch.Tensor):
        return torch.full_like(batch, float("nan")) if batch.is_floating_point() else batch
    if dataclasses.is_dataclass(batch):
        return dataclasses.replace(batch, **{f.name: poison_nan(getattr(batch, f.name))
                                             for f in dataclasses.fields(batch)})
    return batch


def maybe_poison(site: str, batch):
    return poison_nan(batch) if fire(site) else batch
