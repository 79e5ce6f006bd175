"""Elastic capacity control: turn the fleet's overload signals into
worker-count policy.

Port of ``deepinteract_tpu/serving/autoscaler.py``. The fleet has the
*mechanisms* (supervisor, router, warm rollover) and the serving layer
the *signals* (admission rejections, shed state, request latency); this
controller closes the loop. Every ``interval_s`` it reads one
consolidated signal snapshot —

* **queue depth** — mean in-flight per routable worker, from the
  ``inflight`` field the supervisor's health probes cache in each
  worker snapshot;
* **p99 latency** — the router-side ``di_router_request_seconds``
  histogram (:meth:`FleetRouter.request_p99_ms`), failovers included;
* **shed / admission pressure** — :func:`admission.overload_signals`
  deltas plus any worker whose health reports degraded/shedding;

— and decides **up**, **down**, or **hold**:

* *Hysteresis*: a breach must persist for ``breach_polls`` consecutive
  polls before any action — one slow request never spawns a worker, one
  idle poll never drains one.
* *Cooldown*: after any action the controller holds for ``cooldown_s``
  regardless of signals, so a scale-up's own warm-up window (when
  latency is still settling) cannot trigger the next action. Flapping
  is structurally impossible: action requires breach_polls consecutive
  breaches of the SAME direction *and* an expired cooldown.
* *Scale-up* pre-warms through the rollover machinery: the new worker
  is adopted into the routing table only after it reports warm
  (``status: ok`` + the router's required warm-bucket prefixes), so a
  cold worker never eats live traffic.
* *Scale-down* releases the youngest worker from the routing table
  FIRST, then SIGTERM-drains it through its own drain path — in-flight
  requests finish or fail over; nothing is dropped.
* *Preemption* is the supervisor's own first-class capacity event
  (``WorkerSupervisor.preempt_worker``): an expected loss with no
  circuit penalty and an immediate replacement. The autoscaler does
  not react to it — capacity self-heals one layer below.

Chaos: the ``autoscale.decision`` fault site raises at the moment a
decision would commit; the tick swallows it, counts it
(``di_autoscale_decisions_total{decision="error"}``), and leaves the
fleet unchanged — a broken controller must degrade to "no policy",
never to "random policy".

The controller's target and counters persist through the supervisor's
atomic ``fleet_state.json`` (``set_extra_state("autoscale", ...)``);
after a kill -9 the next controller resumes the persisted target and
*reconciles* the respawned fleet up or down to it.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Dict, Optional, Tuple

from deepinteract_tpu_torch.obs import metrics as obs_metrics
from deepinteract_tpu_torch.robustness import faults
from deepinteract_tpu_torch.serving import admission
from deepinteract_tpu_torch.serving.fleet import WorkerSupervisor
from deepinteract_tpu_torch.serving.router import FleetRouter

logger = logging.getLogger(__name__)

_DECISIONS = obs_metrics.counter(
    "di_autoscale_decisions_total",
    "Autoscaler control decisions by kind",
    labelnames=("decision",))
_TARGET = obs_metrics.gauge(
    "di_autoscale_target_workers",
    "The autoscaler's current worker-count target")


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Capacity policy (CLI surface: ``cli/serve.py --autoscale``)."""

    min_workers: int = 1
    max_workers: int = 4
    # Control period; signals are sampled and streaks advanced per tick.
    interval_s: float = 1.0
    # Mean in-flight per routable worker above which the fleet is
    # under-provisioned / below which it is over-provisioned. The gap
    # between the two thresholds is the hysteresis band.
    queue_high: float = 2.0
    queue_low: float = 0.25
    # Router-side p99 (ms) that also counts as a high-pressure breach;
    # 0 disables the latency trigger (the histogram is cumulative, so
    # this is a scale-UP signal only).
    p99_high_ms: float = 0.0
    # Consecutive breaching polls required before any action.
    breach_polls: int = 3
    # Hold-down after ANY action, in seconds.
    cooldown_s: float = 10.0
    # Bound on the new worker's warm-up before a scale-up aborts.
    warm_timeout_s: float = 60.0
    # SIGTERM-drain grace for scale-down victims.
    drain_timeout_s: float = 30.0


class Autoscaler:
    """One control loop over a (supervisor, router) pair (module
    docstring). ``overrides`` seed new workers' spawn knobs (e.g. the
    primary ``weights_signature``) so scaled-up capacity joins the
    version the traffic actually wants."""

    def __init__(self, supervisor: WorkerSupervisor, router: FleetRouter,
                 cfg: AutoscalerConfig = AutoscalerConfig(),
                 overrides: Optional[Dict[str, Any]] = None):
        if cfg.min_workers < 1 or cfg.max_workers < cfg.min_workers:
            raise ValueError(
                f"need 1 <= min_workers <= max_workers, got "
                f"[{cfg.min_workers}, {cfg.max_workers}]")
        self.sup = supervisor
        self.router = router
        self.cfg = cfg
        self.overrides = dict(overrides or {})
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._target = self._clamp(supervisor.cfg.num_workers)
        self._high_streak = 0
        self._low_streak = 0
        self._last_action_ts = 0.0  # monotonic; 0 = never acted
        self._scale_ups = 0
        self._scale_downs = 0
        self._errors = 0
        self._last_signals: Dict[str, Any] = {}
        self._prev_pressure = 0.0  # cumulative shed+admission rejects
        self._restore()
        _TARGET.set(float(self._target))

    def _clamp(self, n: int) -> int:
        return max(self.cfg.min_workers, min(self.cfg.max_workers, n))

    def _restore(self) -> None:
        """Resume the persisted target after a control-plane kill -9 —
        the fleet reconciles back to it instead of resetting to the
        static ``num_workers``."""
        record = self.sup.recovered_state().get("autoscale")
        if not isinstance(record, dict):
            return
        target = record.get("target_workers")
        if isinstance(target, int) and not isinstance(target, bool):
            with self._lock:
                self._target = self._clamp(target)
        for key in ("scale_ups", "scale_downs"):
            value = record.get(key)
            if isinstance(value, int) and not isinstance(value, bool):
                with self._lock:
                    setattr(self, f"_{key}", value)
        logger.info("autoscale: restored state from fleet_state.json: "
                    "%s", record)
        self._persist()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(
            target=self._run, name="autoscaler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - the loop must survive
                logger.exception("autoscale: tick failed")

    # -- signals -----------------------------------------------------------

    def signals(self) -> Dict[str, float]:
        """One consolidated overload snapshot (module docstring)."""
        infos = self.sup.routable_workers()
        inflight = []
        degraded = 0
        for w in infos:
            health = w.get("health") or {}
            q = health.get("inflight")
            if isinstance(q, (int, float)) and not isinstance(q, bool):
                inflight.append(float(q))
            if health.get("degraded") or health.get("shedding"):
                degraded += 1
        shed = admission.overload_signals()
        pressure = shed["admission_rejected"] + shed["shed_rejected"]
        with self._lock:
            pressure_delta = max(0.0, pressure - self._prev_pressure)
            self._prev_pressure = pressure
        return {
            "workers": float(len(infos)),
            "mean_inflight": (sum(inflight) / len(inflight)
                              if inflight else 0.0),
            "degraded_workers": float(degraded),
            "p99_ms": round(self.router.request_p99_ms(), 3),
            "shed_degraded": shed["shed_degraded"],
            "pressure_delta": pressure_delta,
        }

    # -- control -----------------------------------------------------------

    def poll_once(self) -> Optional[str]:
        """One control decision; returns the action taken (``"up"``,
        ``"down"``, ``"reconcile_up"``, ``"reconcile_down"``) or None.
        The ``autoscale.decision`` fault raises BEFORE any mutation —
        an injected failure is counted and the fleet stays unchanged."""
        sig = self.signals()
        decision, target = self._decide(sig)
        with self._lock:
            self._last_signals = dict(sig)
        if decision is None:
            return None
        try:
            faults.maybe_raise(
                "autoscale.decision",
                lambda: RuntimeError("injected autoscale.decision fault"))
            if decision.endswith("up"):
                self._scale_up(target)
            else:
                self._scale_down(target)
        except Exception as exc:  # noqa: BLE001 - chaos containment
            with self._lock:
                self._errors += 1
            _DECISIONS.inc(decision="error")
            logger.warning("autoscale: %s -> %d failed (%s) — fleet "
                           "unchanged", decision, target, exc)
            return None
        with self._lock:
            self._target = target
            self._last_action_ts = time.monotonic()
            self._high_streak = 0
            self._low_streak = 0
        _TARGET.set(float(target))
        _DECISIONS.inc(decision=decision)
        self._persist()
        logger.info("autoscale: %s -> target %d (signals %s)", decision,
                    target, sig)
        return decision

    def _decide(self, sig: Dict[str, float],
                ) -> Tuple[Optional[str], int]:
        """(decision, new_target). Streaks advance every poll; actions
        additionally require an expired cooldown. Reconciliation (the
        live fleet disagrees with the persisted target after a restart)
        bypasses hysteresis — the decision was already made — but still
        honors cooldown."""
        cfg = self.cfg
        high = (sig["mean_inflight"] >= cfg.queue_high
                or sig["degraded_workers"] > 0
                or sig["shed_degraded"] > 0
                or sig["pressure_delta"] > 0
                or (cfg.p99_high_ms > 0
                    and sig["p99_ms"] >= cfg.p99_high_ms))
        low = (sig["mean_inflight"] <= cfg.queue_low
               and sig["degraded_workers"] == 0
               and sig["shed_degraded"] == 0
               and sig["pressure_delta"] == 0)
        now = time.monotonic()
        with self._lock:
            self._high_streak = self._high_streak + 1 if high else 0
            self._low_streak = self._low_streak + 1 if low else 0
            target = self._target
            cooling = (self._last_action_ts > 0
                       and now - self._last_action_ts < cfg.cooldown_s)
            high_streak, low_streak = self._high_streak, self._low_streak
        if cooling:
            return None, target
        workers = int(sig["workers"])
        if workers and workers < target:
            return "reconcile_up", target
        if workers > self.cfg.max_workers or (
                workers and workers > target):
            return "reconcile_down", target
        if high_streak >= cfg.breach_polls and target < cfg.max_workers:
            return "up", target + 1
        if low_streak >= cfg.breach_polls and target > cfg.min_workers:
            return "down", target - 1
        return None, target

    def _scale_up(self, target: int) -> None:
        """Spawn one worker, wait until it is WARM (the rollover bar:
        healthy + status ok + required warm-bucket prefixes), then adopt
        it into the routing table. A worker that never warms is drained
        and the scale-up fails — cold capacity is not capacity."""
        worker_id = self.sup.spawn_worker(dict(self.overrides))
        target_sig = self.overrides.get("weights_signature")
        deadline = time.monotonic() + self.cfg.warm_timeout_s
        wait_s = min(max(self.sup.cfg.probe_interval_s, 0.05), 0.25)
        while time.monotonic() < deadline:
            self.sup.poll_once()
            if self.router._is_warm(worker_id, target_sig):
                self.router.adopt_worker(worker_id)
                logger.info("autoscale: scale-up adopted %s", worker_id)
                with self._lock:
                    self._scale_ups += 1
                return
            time.sleep(wait_s)
        self.sup.drain_many([worker_id], timeout_s=5.0)
        raise RuntimeError(
            f"scale-up worker {worker_id} not warm after "
            f"{self.cfg.warm_timeout_s:.0f}s — drained, fleet unchanged")

    def _scale_down(self, target: int) -> None:
        """Retire the YOUNGEST routable worker above the target: release
        it from routing first (new picks stop instantly), then SIGTERM-
        drain it through its own drain path — zero dropped requests."""
        routable = sorted(
            (w["worker_id"] for w in self.sup.routable_workers()),
            key=lambda wid: int(wid.lstrip("w") or 0))
        if len(routable) <= self.cfg.min_workers:
            raise RuntimeError(
                f"scale-down refused: {len(routable)} routable "
                f"worker(s) <= min_workers={self.cfg.min_workers}")
        victim = routable[-1]
        self.router.release_worker(victim)
        self.sup.drain_worker(victim,
                              timeout_s=self.cfg.drain_timeout_s)
        with self._lock:
            self._scale_downs += 1
        logger.info("autoscale: scale-down drained %s", victim)

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "target_workers": self._target,
                "min_workers": self.cfg.min_workers,
                "max_workers": self.cfg.max_workers,
                "scale_ups": self._scale_ups,
                "scale_downs": self._scale_downs,
                "errors": self._errors,
                "high_streak": self._high_streak,
                "low_streak": self._low_streak,
                "last_signals": dict(self._last_signals),
            }

    def _persist(self) -> None:
        with self._lock:
            record = {
                "target_workers": self._target,
                "scale_ups": self._scale_ups,
                "scale_downs": self._scale_downs,
                "errors": self._errors,
            }
        try:
            self.sup.set_extra_state("autoscale", record)
        except (OSError, ValueError) as exc:
            logger.warning("autoscale: persist failed: %s", exc)
