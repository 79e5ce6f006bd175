"""Worker supervision: spawn, watch, restart, and retire engine workers.

Port of ``deepinteract_tpu/serving/fleet.py``. One serving process is
overload-safe and durable, but it is still ONE process: a crash, a
preemption, or a weights update is client-visible downtime. The fleet
layer splits serving into a supervisor/router pair (this module +
``serving/router.py``) in front of N single-engine worker processes
(``cli/serve.py`` with ``--workers 0``, each capturing its own CUDA
graphs, or the ``serving/worker_stub.py`` rehearsal double):

* **spawn** — each worker is a child process with its own port,
  heartbeat file, and log, built by an injectable ``cmd_fn`` (the CLI
  provides the real engine-worker command line; tests provide
  :func:`stub_worker_cmd`);
* **watch** — a monitor thread polls every worker: process liveness
  (``Popen.poll``), heartbeat freshness
  (:func:`deepinteract_tpu_torch.obs.heartbeat.read_heartbeat`, the same
  check the training supervisor uses), and a ``GET /healthz`` probe
  whose payload (``weights_signature``, ``warm_buckets``, ``inflight``)
  the router and the autoscaler read. A live process with a wedged beat
  (stale past ``wedge_kill_factor`` times the max age) is SIGKILLed so
  the normal crash-restart path recovers it;
* **restart** — a crashed worker is respawned with exponential backoff
  (``robustness/retry.compute_delay``: jittered, capped), and a
  flapping worker — more than ``circuit_max_restarts`` restarts inside
  ``circuit_window_s`` — opens a circuit breaker: the supervisor stops
  feeding it restarts (a poisoned checkpoint or bad flag would otherwise
  crash-loop forever), keeps the rest of the fleet serving, and reports
  the open circuit on ``/stats`` + ``di_fleet_circuit_open``;
* **retire** — rollover and shutdown drain workers through their own
  SIGTERM path (finish in-flight, exit 0) and mark them retired so an
  expected exit is never misread as a crash.
* **preempt** — spot/preemptible capacity loss is a FIRST-CLASS event,
  not a crash: :meth:`WorkerSupervisor.preempt_worker` marks the worker
  ``preempted`` and SIGTERMs it (the worker's own drain path finishes
  in-flight work), and when the process exits the supervisor retires it
  with NO circuit-breaker penalty and spawns a replacement immediately
  (no backoff — the capacity is wanted back now). ``fleet.preempt`` is
  the chaos site: a planned firing inside :meth:`poll_once` preempts the
  newest healthy worker.

Chaos sites (``robustness/faults.py``): ``fleet.spawn`` fails a worker
spawn (exercises the backoff path), ``fleet.probe`` poisons a health
probe (worker looks unreachable), ``fleet.kill`` fails the SIGTERM of a
drain (the SIGKILL fallback must still retire the worker),
``fleet.preempt`` injects a preemption event at a supervision tick.

Supervisor state (worker states, restart counts, exit codes) is
persisted to ``<state_dir>/fleet_state.json`` through
``robustness/artifacts.atomic_write`` after every transition, so an
operator reading mid-crash never sees torn JSON. Control-plane records
ride the same file: :meth:`WorkerSupervisor.set_extra_state` merges e.g.
the autoscaler's target and the router's version weights into the
payload, and a restarted supervisor recovers them (plus reaps any
still-alive workers the dead supervisor left behind) via
:func:`load_persisted_state` before spawning its own fleet — kill -9
mid-scale-event recovers to a consistent fleet.

The module imports no torch: the control plane and the stub worker start
in well under a second.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from http.server import ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Sequence

from deepinteract_tpu_torch.obs import metrics as obs_metrics
from deepinteract_tpu_torch.obs.heartbeat import HeartbeatStatus, read_heartbeat
from deepinteract_tpu_torch.robustness import artifacts, faults
from deepinteract_tpu_torch.robustness.retry import compute_delay

logger = logging.getLogger(__name__)

_RESTARTS = obs_metrics.counter(
    "di_fleet_worker_restarts_total",
    "Crashed workers respawned by the supervisor", labelnames=("worker",))
_SPAWN_FAILURES = obs_metrics.counter(
    "di_fleet_spawn_failures_total",
    "Worker spawn attempts that failed (retried with backoff)",
    labelnames=("worker",))
_PROBE_FAILURES = obs_metrics.counter(
    "di_fleet_probe_failures_total",
    "Health probes that errored or timed out", labelnames=("worker",))
_WEDGE_KILLS = obs_metrics.counter(
    "di_fleet_wedge_kills_total",
    "Live-but-wedged workers (stale heartbeat) SIGKILLed for restart",
    labelnames=("worker",))
_UP = obs_metrics.gauge(
    "di_fleet_worker_up", "1 while the worker process is alive and probed "
    "healthy", labelnames=("worker",))
_CIRCUIT = obs_metrics.gauge(
    "di_fleet_circuit_open",
    "1 while the worker's restart circuit breaker is open",
    labelnames=("worker",))
_WORKERS_TOTAL = obs_metrics.gauge(
    "di_fleet_workers_total", "Workers under supervision (not retired)")
_WORKERS_HEALTHY = obs_metrics.gauge(
    "di_fleet_workers_healthy", "Workers currently probed healthy")
_PREEMPTIONS = obs_metrics.counter(
    "di_fleet_preemptions_total",
    "Workers lost to preemption (expected capacity loss: no circuit "
    "penalty, immediate replacement)")
_ORPHANS_REAPED = obs_metrics.counter(
    "di_fleet_orphans_reaped_total",
    "Still-alive workers of a dead supervisor killed at startup")

# Retired worker records kept around for /stats & fleet_state.json
# visibility; older ones are GC'd so a long-lived fleet's daily
# rollovers cannot grow supervisor memory, gauge cardinality, and the
# state file without bound.
RETIRED_RETENTION = 8

# Worker command factory: (worker_id, port, heartbeat_path, overrides) ->
# argv. ``overrides`` carries rollover-time replacements (e.g. a new
# ``ckpt_name`` / target ``weights_signature``) interpreted by the
# factory, so the supervisor never needs to know a worker's flag surface.
CmdFn = Callable[[str, int, str, Dict[str, Any]], List[str]]


def fan_out(tasks: Dict[str, Callable[[], Any]],
            join_timeout_s: Optional[float] = None,
            name: str = "fanout") -> Dict[str, Any]:
    """Run named thunks concurrently (one thread each) and return the
    results of those that finished — the ONE fan-out the parallel
    drains, health probes, and the router's aggregation fetches share,
    so their join/timeout semantics cannot drift.

    ``join_timeout_s`` is a COLLECTIVE deadline (None = wait forever):
    each join consumes the remaining budget, so N hung thunks cost one
    timeout total, not N. Threads are daemon — a thunk wedged past the
    deadline (hung NFS stat, a worker dribbling bytes forever) is
    abandoned, its key absent from the result, and it can never block
    interpreter exit. Callers decide what a missing key means. The
    RETURNED dict is a post-join snapshot the worker threads never
    touch — a late completion writes into its own pre-created slot and
    can never resize a dict the caller is iterating."""
    _PENDING = object()
    slots: Dict[str, Any] = {key: _PENDING for key in tasks}
    threads = [threading.Thread(
        target=lambda k=key, thunk=fn: slots.__setitem__(k, thunk()),
        name=f"{name}-{key}", daemon=True) for key, fn in tasks.items()]
    for t in threads:
        t.start()
    deadline = (None if join_timeout_s is None
                else time.monotonic() + join_timeout_s)
    for t in threads:
        t.join(timeout=None if deadline is None
               else max(0.0, deadline - time.monotonic()))
    return {key: value for key, value in slots.items()
            if value is not _PENDING}


def watch_parent(parent_pid: int, on_orphan: Callable[[], None],
                 interval_s: float = 1.0) -> Optional[threading.Thread]:
    """Daemon thread firing ``on_orphan`` ONCE when ``parent_pid`` stops
    being this process's parent.

    A SIGKILLed (or otherwise hard-killed) supervisor cannot drain its
    workers — without this, they would keep serving as orphans forever,
    invisible to any router. Workers run it against the supervisor pid
    (``--parent_pid``, set by the worker command factories) and route
    the orphan event into their own drain path, so supervisor death
    degrades to the same clean exit a rollover drain produces. No-op
    (returns None) when ``parent_pid <= 0``."""
    if parent_pid <= 0:
        return None

    def _loop():
        while True:
            if os.getppid() != parent_pid:
                logger.error(
                    "parent %d is gone (ppid now %d): draining — an "
                    "orphaned worker must not serve forever",
                    parent_pid, os.getppid())
                try:
                    on_orphan()
                except Exception:  # noqa: BLE001 - watcher must not crash
                    logger.exception("orphan hook failed")
                return
            time.sleep(interval_s)

    thread = threading.Thread(target=_loop, name="parent-watch",
                              daemon=True)
    thread.start()
    return thread


def endpoint_label(path: str, routes: Sequence[str]) -> str:
    """Metric label for a request path: the matched route, else
    ``"other"`` — unknown client paths (scanners, typos) must not mint
    unbounded label series. Shared by the router and the worker stub
    (the real server has its own pre-fleet copy)."""
    route = path.partition("?")[0]
    return route if route in routes else "other"


class QuietHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose handler-thread errors go to debug
    logging instead of stderr tracebacks: routine client disconnects
    (a router abandoning a SIGKILLed sibling's keep-alive socket, a
    drain tearing idle connections) are not incidents. Shared by the
    router and the worker stub; real failures are answered as 4xx/5xx
    JSON by the handlers themselves."""

    def handle_error(self, request, client_address):  # noqa: N802
        logger.debug("connection error from %s", client_address,
                     exc_info=True)


def batch_slots(n_requests: int, max_batch: int,
                lift_to: int = 1) -> int:
    """Coalesced-group padding policy: next power of two, capped at
    ``max_batch``. ONE implementation shared by the engine's graph
    inventory (``InferenceEngine._batch_slots``) and the rollover
    readiness prefixes (``cli/serve.warm_bucket_prefixes``) — if these
    drifted, replacements would capture labels the router's warm check
    no longer matches and every rollover would abort on timeout.

    ``lift_to`` raises the floor (rounded up to a power of two): a
    data-parallel mesh worker lifts slots to its data-axis size so every
    device holds at least one sample; the ``max_batch`` cap still wins.
    A mesh engine passes its data axis D, except for ``pair`` buckets
    (``InferenceEngine._batch_slots``).
    """
    slots = 1 << (max(1, int(n_requests)) - 1).bit_length()
    floor = 1 << (max(1, int(lift_to)) - 1).bit_length()
    return min(max(slots, floor), max(1, int(max_batch)))


def parse_mesh_shape(spec) -> "tuple[int, int]":
    """``"DxP"`` (e.g. ``"4x1"``, ``"2x4"``) -> ``(data, pair)`` device
    counts. Accepts an already-parsed 2-tuple/list verbatim and ``None``
    / ``""`` as the single-device shape ``(1, 1)``. The ONE parser the
    CLI plumbing, router placement, and stub health payloads share, so a
    topology label can never mean two things."""
    if spec is None or spec == "":
        return (1, 1)
    if isinstance(spec, (tuple, list)):
        if len(spec) != 2:
            raise ValueError(f"mesh shape needs 2 axes, got {spec!r}")
        data, pair = int(spec[0]), int(spec[1])
    else:
        parts = str(spec).lower().split("x")
        if len(parts) != 2:
            raise ValueError(
                f"mesh shape must look like 'DATAxPAIR' (e.g. '4x1'), "
                f"got {spec!r}")
        try:
            data, pair = int(parts[0]), int(parts[1])
        except ValueError:
            raise ValueError(
                f"mesh shape must be two integers 'DATAxPAIR', got "
                f"{spec!r}") from None
    if data < 1 or pair < 1:
        raise ValueError(f"mesh axes must be >= 1, got {data}x{pair}")
    return (data, pair)


def mesh_label(shape) -> str:
    """Canonical ``"DxP"`` topology label for health payloads, graph
    inventory, and the fleet contract (``(1, 1)``/None -> ``"1x1"``)."""
    data, pair = parse_mesh_shape(shape)
    return f"{data}x{pair}"


def mesh_label_prefix(shape) -> str:
    """Compile-label prefix carrying the topology: ``""`` for the
    single-device shape (existing labels, warm prefixes, and rollover
    specs stay valid verbatim), ``"mesh<D>x<P>/"`` otherwise. A PREFIX,
    not a suffix, because the router's warm-readiness check is
    ``label.startswith(required)`` — a 1-chip replacement can never
    satisfy a mesh worker's warm proof, and vice versa."""
    data, pair = parse_mesh_shape(shape)
    if (data, pair) == (1, 1):
        return ""
    return f"mesh{data}x{pair}/"


def mesh_placement(shape, bucket1: int, bucket2: int,
                   pair_threshold: int, shard_pair_map: bool = False) -> str:
    """Placement policy for one bucket on one worker topology:

    * ``"single"`` — no mesh (shape ``(1, 1)``): one-device graph
      entries.
    * ``"pair"`` — the mesh has a pair axis and the bucket's longer side
      reaches ``pair_threshold``: one huge complex row-shards across
      chips (latency scaling for p512+ antibody/spike-scale maps).
      ``shard_pair_map`` (a port-only flag) gives a pair axis of one the
      same placement, over one pair rank.
    * ``"data"`` — everything else on a mesh: batch slots shard over the
      data axis (throughput scaling for small-bucket traffic).

    Pure and torch-free so ``cli/serve.warm_bucket_prefixes`` and the
    router's topology-aware routing share ONE policy.
    """
    data, pair = parse_mesh_shape(shape)
    huge = pair_threshold > 0 and max(int(bucket1), int(bucket2)) >= pair_threshold
    if huge and (pair > 1 or shard_pair_map):
        return "pair"
    if (data, pair) == (1, 1):
        return "single"
    return "data"


def reserve_port(host: str = "127.0.0.1"):
    """(port, the socket that holds it): an OS-assigned free TCP port,
    kept bound by the supervisor while its worker starts. The socket sets
    SO_REUSEADDR and never listens, so the worker's HTTP server (which
    sets SO_REUSEADDR, as ``http.server`` does) binds and listens on the
    port, while a plain bind fails and the kernel gives the port to no
    outgoing connection as its ephemeral port. A bind-0 probe that closes
    its socket at once left the port free until the worker bound it,
    which an engine worker does only after its warm-up, seconds later:
    under load a client connection took the port and the worker died
    with EADDRINUSE (F12)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
    except OSError:
        s.close()
        raise
    return int(s.getsockname()[1]), s


def request_json(host: str, port: int, method: str, path: str,
                 body: Optional[bytes] = None, timeout_s: float = 2.0):
    """One HTTP round trip returning ``(status, parsed_json_or_text)``.
    The ONE http.client block the supervisor probe, the router's
    aggregation fetches, and the rollover client share — transport
    errors propagate to the caller for classification."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        headers = {"Content-Type": "application/json"} if body else {}
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        text = resp.read().decode()
        ctype = resp.getheader("Content-Type", "")
        if ctype.startswith("application/json"):
            return resp.status, json.loads(text)
        return resp.status, text
    finally:
        conn.close()


def probe_healthz(host: str, port: int, timeout_s: float = 2.0) -> Dict:
    """One ``GET /healthz`` against a worker; raises on any transport or
    parse failure (the caller counts and classifies). ``fleet.probe`` is
    the chaos hook that makes a healthy worker look unreachable."""
    faults.maybe_raise(
        "fleet.probe",
        lambda: ConnectionError("injected fleet.probe fault"))
    status, payload = request_json(host, port, "GET", "/healthz",
                                   timeout_s=timeout_s)
    if status != 200:
        raise ConnectionError(f"/healthz answered {status}")
    if not isinstance(payload, dict):
        raise ConnectionError("/healthz payload is not an object")
    return payload


def stub_worker_cmd(worker_id: str, port: int, heartbeat_path: str,
                    overrides: Dict[str, Any]) -> List[str]:
    """Command factory for ``serving/worker_stub.py`` rehearsal workers
    (fleet chaos tests, ``cli/serve.py --fleet_stub_workers``). ``overrides`` keys map onto stub flags;
    ``ckpt_name`` aliases onto the stub's weights signature so rollover
    requests written against real workers rehearse unchanged."""
    cmd = [sys.executable, "-m", "deepinteract_tpu_torch.serving.worker_stub",
           "--worker_id", worker_id, "--port", str(port),
           "--parent_pid", str(os.getpid())]
    if heartbeat_path:
        cmd += ["--heartbeat_file", heartbeat_path]
    # ckpt_name outranks a base weights_signature: a rollover that only
    # names the new checkpoint must repoint the stub's identity even
    # when the fleet was configured with a baseline signature.
    sig = overrides.get("ckpt_name") or overrides.get("weights_signature")
    if sig:
        cmd += ["--weights_signature", str(sig)]
    for key in ("warm_buckets", "delay_ms", "warm_after_s",
                "crash_after_s", "heartbeat_interval_s", "probs_value",
                "mesh_shape"):
        if key in overrides:
            cmd += [f"--{key}", str(overrides[key])]
    return cmd


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Supervision policy (CLI surface: ``cli/serve.py`` fleet flags)."""

    num_workers: int = 2
    # Monitor cadence + probe transport bound.
    probe_interval_s: float = 1.0
    probe_timeout_s: float = 2.0
    # Heartbeat staleness: past max_age the worker is unroutable; past
    # wedge_kill_factor * max_age with a LIVE process it is wedged (beat
    # thread or event loop stuck) and gets SIGKILLed into the restart
    # path. 0 disables heartbeat checks (probe-only supervision).
    heartbeat_max_age_s: float = 15.0
    wedge_kill_factor: float = 3.0
    # Exponential backoff between restart attempts.
    restart_backoff_s: float = 0.5
    restart_backoff_max_s: float = 30.0
    # Circuit breaker: more than this many restarts inside the window
    # stops the restart loop for that worker (operator action required).
    circuit_max_restarts: int = 5
    circuit_window_s: float = 60.0
    # A worker still not probing healthy this long after its spawn is
    # stuck BEFORE it could even start beating (deadlocked import,
    # wedged checkpoint mount): SIGKILL it into the restart path. Must
    # comfortably exceed a real worker's load + capture warmup; 0
    # disables.
    start_grace_s: float = 600.0
    # Heartbeats, per-worker logs, and fleet_state.json live here.
    state_dir: str = ""
    # SIGTERM-drain grace before the SIGKILL fallback at stop/retire.
    drain_timeout_s: float = 30.0


def load_persisted_state(state_path: str) -> Dict[str, Any]:
    """Tolerant read of a (possibly previous-life) ``fleet_state.json``:
    ``{}`` when missing or malformed — recovery must never crash on the
    state it is recovering from."""
    try:
        with open(state_path) as fh:
            state = json.load(fh)
    except (OSError, ValueError):
        return {}
    return state if isinstance(state, dict) else {}


def _pid_runs_worker(pid: int) -> bool:
    """True when ``/proc/<pid>/cmdline`` looks like one of OUR worker
    processes — the guard that makes startup orphan reaping safe against
    pid reuse. Conservative: an unreadable/absent cmdline (non-Linux,
    already-gone process) is False; the worker's own parent-watcher
    remains the self-draining fallback. Matches the workers of either
    package (``deepinteract_tpu`` is a prefix of the port's name)."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as fh:
            cmd = fh.read().replace(b"\x00", b" ").decode("utf-8",
                                                          "replace")
    except OSError:
        return False
    return "deepinteract_tpu" in cmd


class _Worker:
    """Mutable per-worker record. Every field is guarded by the owning
    supervisor's ``_lock``; the Popen handle itself is only ever driven
    (signal/wait) outside the lock via a snapshot reference."""

    def __init__(self, worker_id: str, port: int, heartbeat_path: str,
                 log_path: str, overrides: Dict[str, Any]):
        self.worker_id = worker_id
        self.port = port
        self.heartbeat_path = heartbeat_path
        self.log_path = log_path
        self.overrides = dict(overrides)
        self.proc: Optional[subprocess.Popen] = None
        # spawning -> starting -> healthy <-> unhealthy; dead ->
        # restarting -> spawning; circuit_open, draining, retired are
        # terminal-ish. Registered as "spawning" (not "starting"): the
        # monitor must not classify a worker whose FIRST Popen is still
        # in flight as dead and double-spawn it.
        self.state = "spawning"
        self.restarts = 0
        self.restart_times: deque = deque()
        self.backoff_attempt = 0
        self.next_restart_at = 0.0
        self.last_exit_code: Optional[int] = None
        self.last_error = ""
        self.health: Dict[str, Any] = {}
        self.heartbeat = "unknown"
        self.spawned_at = 0.0  # monotonic stamp of the last spawn
        # The socket holding ``port`` for this incarnation (reserve_port),
        # closed when it is replaced or the worker is retired.
        self.reservation: Optional[socket.socket] = None

    def release_port(self) -> None:
        if self.reservation is not None:
            self.reservation.close()
            self.reservation = None

    def snapshot(self) -> Dict[str, Any]:
        return {
            "worker_id": self.worker_id,
            "port": self.port,
            "pid": self.proc.pid if self.proc is not None else None,
            "state": self.state,
            "restarts": self.restarts,
            "last_exit_code": self.last_exit_code,
            "last_error": self.last_error,
            "heartbeat": self.heartbeat,
            "health": dict(self.health),
            "log_path": self.log_path,
        }


class WorkerSupervisor:
    """Spawn/monitor/restart N worker processes (module docstring)."""

    def __init__(self, cmd_fn: CmdFn, cfg: FleetConfig = FleetConfig(),
                 host: str = "127.0.0.1",
                 overrides: Optional[Dict[str, Any]] = None):
        if cfg.num_workers < 0:
            raise ValueError(f"num_workers must be >= 0, got "
                             f"{cfg.num_workers}")
        self.cfg = cfg
        self.host = host
        self._cmd_fn = cmd_fn
        self._base_overrides = dict(overrides or {})
        # RLock so lookup helpers can guard their reads explicitly (a
        # verifiable no-cost re-entry under callers already holding it —
        # the scheduler's _take_ready_group discipline).
        self._lock = threading.RLock()
        self._workers: Dict[str, _Worker] = {}
        self._seq = 0
        self._started = False
        self._restarts_total = 0
        # Cumulative circuit trips: retirement (e.g. the shutdown
        # drain) clears a worker's OPEN state, but the final fleet/v1
        # contract must still report that supervision degraded during
        # the run — "ok" would otherwise be vacuously true at exit.
        self._circuit_tripped = 0
        # Expected capacity losses (preempt_worker / fleet.preempt):
        # counted separately from restarts because they carry no
        # circuit penalty and say nothing about worker health.
        self._preemptions = 0
        self._orphans_reaped = 0
        # Control-plane records (autoscaler target, version weights)
        # persisted alongside worker state; see set_extra_state.
        self._extras: Dict[str, Dict[str, Any]] = {}
        # Called (old_id, new_id) after a preempted worker's replacement
        # spawns, so a router can swap its routing slot in place.
        self.on_replacement: Optional[Callable[[str, str], None]] = None
        self._stop = threading.Event()
        self._persist_lock = threading.Lock()
        self._monitor: Optional[threading.Thread] = None
        # Absolute: worker paths (heartbeat, log) are handed to child
        # processes and must not depend on anyone's cwd.
        state_dir = os.path.abspath(cfg.state_dir or os.path.join(
            os.getcwd(), "fleet_state"))
        os.makedirs(state_dir, exist_ok=True)
        self.state_dir = state_dir
        self.state_path = os.path.join(state_dir, "fleet_state.json")
        # A previous supervisor life's persisted state, read BEFORE this
        # life writes anything: kill -9 recovery restores control-plane
        # extras (autoscale target, version weights) from here, and
        # start() reaps any of its workers still alive.
        self._recovered_state: Dict[str, Any] = load_persisted_state(
            self.state_path)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "WorkerSupervisor":
        """Spawn the initial fleet and the monitor. IDEMPOTENT: the
        router calls it defensively, and a caller that already started
        the supervisor must not get a second fleet."""
        with self._lock:
            spawn_initial = not self._started
            self._started = True
        if spawn_initial:
            self._reap_orphans()
            for _ in range(self.cfg.num_workers):
                self.spawn_worker(self._base_overrides)
        if self._monitor is None:
            self._stop.clear()
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="fleet-monitor", daemon=True)
            self._monitor.start()
        return self

    def stop(self, timeout_s: Optional[float] = None) -> Dict[str, Optional[int]]:
        """Drain every non-retired worker (SIGTERM -> wait -> SIGKILL
        fallback) and stop the monitor. Returns worker -> exit code."""
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        with self._lock:
            ids = [w.worker_id for w in self._workers.values()
                   if w.state != "retired"]
        codes = self.drain_many(
            ids, timeout_s if timeout_s is not None
            else self.cfg.drain_timeout_s)
        with self._lock:
            for w in self._workers.values():
                w.release_port()
        self._persist_state()
        return codes

    def _reap_orphans(self) -> None:
        """Kill still-alive workers recorded by a PREVIOUS supervisor
        life in this state_dir. kill -9 of a supervisor cannot drain its
        children; each worker's parent-watcher self-drains eventually,
        but recovery must be deterministic and immediate — a restarted
        supervisor spawning a fresh fleet next to orphans would double
        capacity and fight over heartbeat files. Guarded by a /proc
        cmdline check so pid reuse cannot kill an innocent process."""
        with self._lock:
            prior = self._recovered_state
            own_pids = {w.proc.pid for w in self._workers.values()
                        if w.proc is not None}
        workers = prior.get("workers")
        if not isinstance(workers, dict):
            return
        for wid, snap in workers.items():
            if not isinstance(snap, dict):
                continue
            pid = snap.get("pid")
            if (not isinstance(pid, int) or pid <= 0 or pid in own_pids
                    or snap.get("state") == "retired"):
                continue
            if not _pid_runs_worker(pid):
                continue
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                continue
            with self._lock:
                self._orphans_reaped += 1
            _ORPHANS_REAPED.inc()
            logger.warning(
                "fleet: reaped orphaned worker %s (pid %d) left by a "
                "previous supervisor", wid, pid)

    def recovered_state(self) -> Dict[str, Any]:
        """The previous supervisor life's persisted fleet_state.json as
        read at construction ({} on a fresh state_dir): the autoscaler
        and router restore their control-plane records from here after
        a kill -9 restart."""
        with self._lock:
            return dict(self._recovered_state)

    def set_extra_state(self, key: str, value: Dict[str, Any]) -> None:
        """Merge a control-plane record (autoscaler target, version
        weights/shadow config) into ``fleet_state.json`` under ``key``,
        persisted through the same atomic write as worker state — kill
        -9 recovery reads one consistent snapshot, never half of a
        scale event or promotion."""
        if key in ("workers", "updated_ts", "restarts_total",
                   "preemptions"):
            raise ValueError(f"extra-state key {key!r} shadows a core "
                             "fleet_state field")
        with self._lock:
            self._extras[key] = dict(value)
        self._persist_state()

    def extra_state(self, key: str) -> Dict[str, Any]:
        with self._lock:
            return dict(self._extras.get(key, {}))

    def drain_many(self, worker_ids: Sequence[str],
                   timeout_s: float) -> Dict[str, Optional[int]]:
        """Drain several workers IN PARALLEL (one thread each): N x
        drain_timeout_s sequential could outlive a preemption grace
        window or a rollover client's socket budget. The one drain
        fan-out stop(), rollover success, and rollover abort share."""
        return fan_out(
            {wid: (lambda w=wid: self.drain_worker(w, timeout_s))
             for wid in worker_ids}, name="drain")

    # -- spawning ----------------------------------------------------------

    def spawn_worker(self, overrides: Optional[Dict[str, Any]] = None) -> str:
        """Create + spawn one new worker; returns its id. A failed spawn
        still registers the worker (state ``restarting``) so the monitor
        retries it with backoff instead of silently shrinking the
        fleet."""
        if self._stop.is_set():
            # A rollover (e.g. SIGHUP) racing shutdown must not spawn
            # workers AFTER stop()'s drain snapshot — they would run
            # unsupervised and undrained.
            raise RuntimeError("supervisor is stopping; refusing to "
                               "spawn new workers")
        with self._lock:
            self._seq += 1
            worker_id = f"w{self._seq}"
            port, reservation = reserve_port(self.host)
            w = _Worker(
                worker_id, port,
                heartbeat_path=os.path.join(
                    self.state_dir, f"heartbeat_{worker_id}.json"),
                log_path=os.path.join(self.state_dir, f"{worker_id}.log"),
                overrides={**self._base_overrides, **(overrides or {})})
            w.reservation = reservation
            self._workers[worker_id] = w
        self._try_spawn(w, first=True)
        self._update_gauges()
        self._persist_state()
        return worker_id

    def spawn_replacements(self, n: int,
                           overrides: Optional[Dict[str, Any]] = None
                           ) -> List[str]:
        """Rollover entry: ``n`` fresh workers with override knobs (new
        checkpoint / target signature) layered over the fleet's base."""
        return [self.spawn_worker(overrides) for _ in range(n)]

    @staticmethod
    def _prune_restart_window(w: _Worker, now: float,
                              window_s: float) -> None:
        """Drop restart/spawn-attempt stamps older than the sliding
        circuit window (caller holds the lock). ONE implementation so
        the spawn-failure, respawn, and crash paths cannot drift."""
        while w.restart_times and now - w.restart_times[0] > window_s:
            w.restart_times.popleft()

    def _try_spawn(self, w: _Worker, first: bool = False) -> bool:
        """Spawn (or respawn) ``w``'s process. Popen runs OUTSIDE the
        lock (it forks); state transitions re-acquire it. EVERY
        pre-exec step runs inside the failure handling: an exception
        that escaped here would strand the worker in state "spawning",
        which nothing retries."""
        if self._stop.is_set():
            with self._lock:
                w.state = "restarting"  # shutdown drain will retire it
            return False
        try:
            if not first:
                # Fresh (reserved) port per respawn: the old one may be
                # held by a socket of the dead process, and retrying a
                # doomed port would convert a transient conflict into a
                # circuit-open worker. Everything downstream
                # (endpoint(), probes) reads w.port live.
                with self._lock:
                    w.release_port()
                    w.port, w.reservation = reserve_port(self.host)
            cmd = self._cmd_fn(w.worker_id, w.port, w.heartbeat_path,
                               w.overrides)
            # The PREVIOUS incarnation's heartbeat must not outlive it:
            # a real engine worker beats only after checkpoint restore
            # + graph captures, and a leftover stale file would read as
            # "wedged" during that window — the wedge-killer would
            # SIGKILL every warming respawn until the circuit opened.
            try:
                os.unlink(w.heartbeat_path)
            except OSError:
                pass
            faults.maybe_raise(
                "fleet.spawn",
                lambda: OSError("injected fleet.spawn fault"))
            # Streaming child log, append-only and regenerable — the
            # integrity-sidecar regime is for state, not stdout.
            log = open(w.log_path, "ab")  # di: allow[artifact-write] streaming child-process log (append-only, regenerable)
            try:
                # cwd is INHERITED: the worker argv may carry relative
                # paths (--ckpt_name checkpoints/run1) that must resolve
                # exactly as they would for the operator's own process.
                proc = subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT)
            finally:
                log.close()
        except Exception as exc:  # noqa: BLE001 - any pre-exec failure
            _SPAWN_FAILURES.inc(worker=w.worker_id)
            with self._lock:
                w.last_error = f"spawn failed: {exc}"
                # Failed spawn ATTEMPTS count toward the circuit like
                # successful respawns do: a persistently unspawnable
                # worker (missing binary, unopenable log path) must trip
                # the breaker, not spawn-retry forever while the fleet
                # contract reports ok.
                now = time.monotonic()
                w.restart_times.append(now)
                self._prune_restart_window(w, now,
                                           self.cfg.circuit_window_s)
                if (not first and len(w.restart_times)
                        >= self.cfg.circuit_max_restarts):
                    w.state = "circuit_open"
                    self._circuit_tripped += 1
                    logger.error(
                        "fleet: %s failed %d spawn/restart attempts "
                        "inside %.0fs — circuit OPEN (inspect %s)",
                        w.worker_id, len(w.restart_times),
                        self.cfg.circuit_window_s, w.log_path)
                    return False
                w.state = "restarting"
                w.next_restart_at = now + compute_delay(
                    w.backoff_attempt, self.cfg.restart_backoff_s,
                    self.cfg.restart_backoff_max_s)
                w.backoff_attempt += 1
            logger.error("fleet: spawning %s failed (%s); retrying with "
                         "backoff", w.worker_id, exc)
            return False
        with self._lock:
            if w.state in ("draining", "retired"):
                # A concurrent stop/rollover-abort retired this worker
                # while Popen ran outside the lock: the fresh process
                # must not outlive the decision. Kill it unsupervised-
                # never.
                try:
                    proc.kill()
                except OSError:
                    pass
                logger.warning("fleet: %s was retired mid-spawn; killed "
                               "the fresh process", w.worker_id)
                return False
            w.proc = proc
            w.state = "starting"
            w.last_error = ""
            w.spawned_at = time.monotonic()
            if not first:
                w.restarts += 1
                self._restarts_total += 1
                now = time.monotonic()
                w.restart_times.append(now)
                self._prune_restart_window(w, now,
                                           self.cfg.circuit_window_s)
        if not first:
            _RESTARTS.inc(worker=w.worker_id)
            logger.warning("fleet: restarted %s (pid %d, restart #%d)",
                           w.worker_id, proc.pid, w.restarts)
        return True

    # -- monitoring --------------------------------------------------------

    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - monitor must survive
                logger.exception("fleet monitor tick failed")
            self._stop.wait(self.cfg.probe_interval_s)

    def poll_once(self) -> None:
        """One supervision tick: liveness, restarts, probes. Public (and
        re-entrant-safe) so the router's rollover warm-wait and the
        tests can drive supervision deterministically instead of
        sleeping against the monitor cadence."""
        now = time.monotonic()
        # Chaos: an injected preemption notice lands at a supervision
        # tick — the newest routable worker is preempted, exactly like
        # a spot-capacity reclaim arriving out of band.
        if faults.fire("fleet.preempt"):
            victims = self.routable_workers()
            if victims:
                self.preempt_worker(victims[-1]["worker_id"])
        with self._lock:
            workers = [w for w in self._workers.values()
                       if w.state not in ("retired",)]
        changed = False
        to_probe: List[_Worker] = []
        for w in workers:
            with self._lock:
                proc, state = w.proc, w.state
            if state == "draining":
                continue
            rc = proc.poll() if proc is not None else None
            if proc is None or rc is not None:
                changed |= self._handle_down(w, rc, now)
                continue
            if state == "preempted":
                # Alive and draining itself after the preemption
                # SIGTERM: keep watching for the exit, but never
                # probe-reclassify it back to healthy/unhealthy.
                continue
            to_probe.append(w)
        # Probes run CONCURRENTLY: one black-holed worker burning its
        # full probe_timeout_s must not delay crash detection for the
        # rest of the fleet (nor serialize the rollover warm-wait,
        # which ticks this method in a tight loop).
        if len(to_probe) == 1:
            changed |= self._probe(to_probe[0])
        elif to_probe:
            results = fan_out(
                {w.worker_id: (lambda ww=w: self._probe(ww))
                 for w in to_probe},
                join_timeout_s=self.cfg.probe_timeout_s + 2.0,
                name="probe")
            changed |= any(results.values())
        if changed:
            self._persist_state()
        self._update_gauges()

    def _handle_down(self, w: _Worker, rc: Optional[int],
                     now: float) -> bool:
        """``w``'s process is gone (or never spawned). Classify, maybe
        trip the circuit, maybe respawn."""
        respawn = False
        replacement_overrides: Optional[Dict[str, Any]] = None
        with self._lock:
            if w.state == "preempted":
                # EXPECTED capacity loss: retire without a circuit
                # penalty (no restart_times entry, no backoff) and
                # replace immediately — preemption says nothing about
                # worker health, and the capacity is wanted back now.
                w.last_exit_code = rc
                w.state = "retired"
                w.last_error = "preempted (expected capacity loss)"
                self._preemptions += 1
                replacement_overrides = dict(w.overrides)
                self._gc_retired_locked()
        if replacement_overrides is not None:
            _PREEMPTIONS.inc()
            logger.warning(
                "fleet: preempted worker %s exited (rc=%s) — spawning "
                "replacement immediately", w.worker_id, rc)
            if not self._stop.is_set():
                try:
                    new_id = self.spawn_worker(replacement_overrides)
                except RuntimeError:
                    pass  # stop() raced the respawn; drain owns cleanup
                else:
                    if self.on_replacement is not None:
                        try:
                            self.on_replacement(w.worker_id, new_id)
                        except Exception:  # noqa: BLE001 - observer hook
                            logger.exception(
                                "fleet: on_replacement hook failed")
            return True
        with self._lock:
            if w.state in ("circuit_open", "spawning", "draining",
                           "retired"):
                # draining/retired re-checked UNDER the lock: poll_once
                # snapshots states before its per-worker work, and a
                # drain landing in between must not be re-read as an
                # unexpected death (which would respawn a worker someone
                # just retired).
                return False
            if w.state not in ("dead", "restarting"):
                w.last_exit_code = rc
                w.state = "dead"
                w.last_error = f"process exited rc={rc}"
                logger.error("fleet: worker %s died (rc=%s)",
                             w.worker_id, rc)
                # Prune at CHECK time, not only at respawn time: a
                # worker that flapped hours ago and then served
                # healthily must not trip the circuit on its next
                # ordinary crash — the window is a sliding one.
                self._prune_restart_window(w, now,
                                           self.cfg.circuit_window_s)
                if len(w.restart_times) >= self.cfg.circuit_max_restarts:
                    w.state = "circuit_open"
                    self._circuit_tripped += 1
                    logger.error(
                        "fleet: %s restarted %d times inside %.0fs — "
                        "circuit OPEN, no further restarts (inspect %s)",
                        w.worker_id, len(w.restart_times),
                        self.cfg.circuit_window_s, w.log_path)
                    return True
                w.next_restart_at = now + compute_delay(
                    w.backoff_attempt, self.cfg.restart_backoff_s,
                    self.cfg.restart_backoff_max_s)
                w.backoff_attempt += 1
                w.state = "restarting"
                return True
            if w.state == "restarting" and now >= w.next_restart_at:
                # Claim the respawn while holding the lock: poll_once
                # runs on the monitor thread AND from a rollover's
                # warm-wait, and a doubly-spawned worker would leak a
                # process nothing supervises.
                w.state = "spawning"
                respawn = True
        if respawn:
            self._try_spawn(w)
            return True
        return False

    def _probe(self, w: _Worker) -> bool:
        """Health-probe a live worker: /healthz + heartbeat freshness.
        Network I/O runs outside the lock."""
        hb: Optional[HeartbeatStatus] = None
        if w.heartbeat_path and self.cfg.heartbeat_max_age_s > 0:
            hb = read_heartbeat(w.heartbeat_path,
                                self.cfg.heartbeat_max_age_s)
        try:
            health = probe_healthz(self.host, w.port,
                                   timeout_s=self.cfg.probe_timeout_s)
            probe_error = ""
        except Exception as exc:  # noqa: BLE001 - classified below
            health = None
            probe_error = str(exc)
            _PROBE_FAILURES.inc(worker=w.worker_id)
        wedged = (hb is not None and hb.status == "stale"
                  and hb.age_s is not None
                  and hb.age_s > self.cfg.heartbeat_max_age_s
                  * self.cfg.wedge_kill_factor)
        with self._lock:
            spawned_at, state_now = w.spawned_at, w.state
        beating = hb is not None and hb.status == "fresh"
        if (not wedged and not beating and self.cfg.start_grace_s > 0
                and state_now in ("starting", "unhealthy")
                and health is None and spawned_at > 0
                and time.monotonic() - spawned_at
                > self.cfg.start_grace_s):
            # "not beating": a fresh heartbeat proves the process is
            # alive and making progress (a slow warmup legitimately
            # exceeds any fixed grace — engine workers beat BEFORE
            # restore starts); the grace kill is for workers that hung
            # before they could even start the beat thread.
            # Never-came-up wedge: alive past the whole start grace but
            # still unprobeable AND (possibly) never wrote a heartbeat
            # — the stale-beat detector can't see a worker that hung
            # before its first beat, so the grace bound catches it.
            wedged = True
            logger.error(
                "fleet: %s still not healthy %.0fs after spawn "
                "(unprobeable) — SIGKILL for restart", w.worker_id,
                time.monotonic() - spawned_at)
        changed = False
        with self._lock:
            if w.state in ("draining", "retired", "preempted"):
                # A drain (or preemption notice) won the race against
                # this probe's network I/O: a stale success must not
                # resurrect a retired worker (the next tick would
                # respawn it with the OLD weights).
                return False
            prev = w.state
            w.heartbeat = hb.status if hb is not None else "disabled"
            if health is not None:
                w.health = health
                stale = hb is not None and hb.status == "stale"
                routable = health.get("status") in ("ok", "overloaded")
                w.state = ("healthy" if routable and not stale
                           else "unhealthy" if stale else "starting"
                           if health.get("status") == "warming"
                           else "unhealthy")
                if w.state == "healthy":
                    w.backoff_attempt = 0
                    w.last_error = ""
                elif stale:
                    w.last_error = (f"heartbeat stale "
                                    f"({hb.age_s:.1f}s old)")
            else:
                w.last_error = f"probe failed: {probe_error}"
                if w.state == "healthy":
                    w.state = "unhealthy"
            changed = w.state != prev
        if wedged:
            _WEDGE_KILLS.inc(worker=w.worker_id)
            logger.error(
                "fleet: %s is live but wedged (heartbeat %s) — SIGKILL "
                "for restart", w.worker_id,
                f"{hb.age_s:.1f}s stale"
                if hb is not None and hb.age_s is not None
                else "never written")
            self._signal(w, signal.SIGKILL)
            changed = True
        return changed

    # -- stopping / retiring ----------------------------------------------

    def _signal(self, w: _Worker, sig: int) -> bool:
        """Deliver ``sig`` to ``w``'s process. ``fleet.kill`` is the
        chaos hook for a failed delivery (e.g. a PID namespace surprise)
        — callers must keep a fallback path."""
        with self._lock:
            proc = w.proc
        if proc is None or proc.poll() is not None:
            return False
        try:
            faults.maybe_raise(
                "fleet.kill", lambda: OSError("injected fleet.kill fault"))
            proc.send_signal(sig)
            return True
        except OSError as exc:
            with self._lock:
                w.last_error = f"signal {sig} failed: {exc}"
            logger.error("fleet: signalling %s with %s failed: %s",
                         w.worker_id, sig, exc)
            return False

    def drain_worker(self, worker_id: str,
                     timeout_s: float = 30.0) -> Optional[int]:
        """SIGTERM-drain a worker (its own drain path finishes
        in-flight work and exits 0), SIGKILL past the grace, retire it
        either way. Returns the exit code (None if it never ran)."""
        w = self._get(worker_id)
        with self._lock:
            w.state = "draining"
            proc = w.proc
        self._persist_state()
        rc: Optional[int] = None
        if proc is not None:
            terminated = self._signal(w, signal.SIGTERM)
            try:
                rc = proc.wait(timeout=timeout_s if terminated else 0.5)
            except subprocess.TimeoutExpired:
                logger.error("fleet: %s ignored SIGTERM for %.0fs — "
                             "SIGKILL", worker_id, timeout_s)
                try:
                    proc.kill()
                except OSError:
                    pass
                try:
                    rc = proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    rc = None
            if rc is None and terminated is False:
                # SIGTERM delivery itself failed (fleet.kill chaos):
                # fall back to SIGKILL so retire is unconditional.
                try:
                    proc.kill()
                    rc = proc.wait(timeout=5.0)
                except (OSError, subprocess.TimeoutExpired):
                    rc = None
        with self._lock:
            w.last_exit_code = rc
            w.state = "retired"
            self._gc_retired_locked()
        self._update_gauges()
        self._persist_state()
        return rc

    def _gc_retired_locked(self) -> None:
        """Drop the oldest retired records beyond RETIRED_RETENTION
        (registration order approximates retirement order well enough
        for a debugging window), INCLUDING their per-worker metric
        series — without this, daily rollovers would grow the scrape
        with dead worker labels forever."""
        with self._lock:  # re-entrant: callers already hold it
            retired = [w.worker_id for w in self._workers.values()
                       if w.state == "retired"]
            for worker_id in retired:
                self._workers[worker_id].release_port()
            dropped = retired[:max(0, len(retired) - RETIRED_RETENTION)]
            for worker_id in dropped:
                del self._workers[worker_id]
        for worker_id in dropped:
            for family in (_UP, _CIRCUIT, _RESTARTS, _SPAWN_FAILURES,
                           _PROBE_FAILURES, _WEDGE_KILLS):
                family.remove(worker=worker_id)

    def preempt_worker(self, worker_id: str) -> bool:
        """Deliver a preemption notice: mark the worker ``preempted``
        (immediately unroutable — ``routable_workers`` only returns
        ``healthy``) and SIGTERM it so its own drain path finishes
        in-flight work. When the process exits, :meth:`_handle_down`
        retires it with NO circuit penalty and spawns a replacement
        immediately. Returns False when the worker is already on its
        way out (draining/retired/preempted/circuit_open)."""
        w = self._get(worker_id)
        with self._lock:
            if w.state in ("retired", "draining", "preempted",
                           "circuit_open"):
                return False
            w.state = "preempted"
            w.last_error = "preemption notice"
        logger.warning("fleet: %s preempted — SIGTERM sent, replacement "
                       "spawns on exit", worker_id)
        self._persist_state()
        self._update_gauges()
        if not self._signal(w, signal.SIGTERM):
            # Delivery failed (fleet.kill chaos / pid surprise): SIGKILL
            # so the preempted worker cannot linger half-forgotten — the
            # replacement path only triggers on its exit.
            with self._lock:
                proc = w.proc
            if proc is not None and proc.poll() is None:
                try:
                    proc.kill()
                except OSError:
                    pass
        return True

    def kill_worker(self, worker_id: str) -> None:
        """SIGKILL (chaos / operator hammer); the monitor's normal
        crash-restart path picks up the corpse."""
        self._signal(self._get(worker_id), signal.SIGKILL)

    # -- queries -----------------------------------------------------------

    def _get(self, worker_id: str) -> _Worker:
        with self._lock:
            return self._get_locked(worker_id)

    def _get_locked(self, worker_id: str) -> _Worker:
        with self._lock:  # re-entrant: callers already hold it
            try:
                return self._workers[worker_id]
            except KeyError:
                raise KeyError(f"unknown worker {worker_id!r}") from None

    def worker_info(self, worker_id: str) -> Dict[str, Any]:
        with self._lock:
            return self._get_locked(worker_id).snapshot()

    def worker_infos(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [w.snapshot() for w in self._workers.values()]

    def routable_workers(self) -> List[Dict[str, Any]]:
        """Snapshot of workers a router may send requests to right now."""
        with self._lock:
            return [w.snapshot() for w in self._workers.values()
                    if w.state == "healthy"]

    def endpoint(self, worker_id: str) -> Sequence:
        w = self._get(worker_id)
        return self.host, w.port

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            states: Dict[str, int] = {}
            for w in self._workers.values():
                states[w.state] = states.get(w.state, 0) + 1
            return {
                "workers": {w.worker_id: w.snapshot()
                            for w in self._workers.values()},
                "states": states,
                "restarts_total": self._restarts_total,
                "circuit_open": states.get("circuit_open", 0),
                "circuit_tripped_total": self._circuit_tripped,
                "preemptions": self._preemptions,
                "orphans_reaped": self._orphans_reaped,
                "state_path": self.state_path,
            }

    # -- persistence / gauges ---------------------------------------------

    def _persist_state(self) -> None:
        with self._lock:
            state = {
                "updated_ts": time.time(),
                "restarts_total": self._restarts_total,
                "preemptions": self._preemptions,
                "workers": {w.worker_id: w.snapshot()
                            for w in self._workers.values()},
            }
            state.update({key: dict(value)
                          for key, value in self._extras.items()})
        # Serialized: atomic_write's tmp name is pid-based, so two
        # threads persisting concurrently (monitor tick + a drain
        # thread) would collide on the same tmp file.
        with self._persist_lock:
            try:
                artifacts.atomic_write(self.state_path,
                                       json.dumps(state, sort_keys=True),
                                       fsync=False)
            except OSError as exc:
                # A full disk must not take down supervision itself.
                logger.error("fleet: persisting %s failed: %s",
                             self.state_path, exc)

    def _update_gauges(self) -> None:
        with self._lock:
            states = [(w.worker_id, w.state)
                      for w in self._workers.values()]
        healthy = 0
        active = 0
        for worker_id, state in states:
            _UP.set(1.0 if state == "healthy" else 0.0, worker=worker_id)
            _CIRCUIT.set(1.0 if state == "circuit_open" else 0.0,
                         worker=worker_id)
            healthy += state == "healthy"
            active += state not in ("retired",)
        _WORKERS_TOTAL.set(float(active))
        _WORKERS_HEALTHY.set(float(healthy))
