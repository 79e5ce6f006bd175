"""Fleet HTTP front: health-checked routing, failover, warm rollover.

Port of ``deepinteract_tpu/serving/router.py``; the Prometheus relabel and
merge live in ``obs/expfmt.py``.

The router is the one address clients know. Behind it, a
:class:`~deepinteract_tpu_torch.serving.fleet.WorkerSupervisor` keeps N
single-engine workers alive; the router:

* **routes** — ``POST /predict`` / ``POST /screen`` / ``POST
  /assembly`` are proxied to a healthy worker. Same-bucket requests stick to the same worker while
  the fleet is stable (an ``X-DI-Bucket`` hint is hashed onto the active
  list, so a bucket's CUDA graphs and micro-batch coalescing stay
  warm on ONE worker) and fall back to round-robin without a hint. The
  answering worker is echoed in the ``X-DI-Worker`` response header.
* **fails over** — ``predict``/``screen`` are pure functions of the
  request, so when a worker dies mid-flight (connection refused/reset,
  torn response) or answers 503-draining, the SAME request is retried on
  a sibling — bounded by the request deadline
  (``X-Request-Deadline-Ms`` forwarded with the REMAINING budget) and by
  one attempt per distinct healthy worker. Worker application errors
  (400/500 with an intact response) pass through untouched: the worker
  answered; re-asking a sibling would just re-execute a bad request.
* **aggregates** — ``GET /stats`` merges the supervisor's fleet view
  with every worker's own ``/stats``; ``GET /metrics`` renders the
  router's registry plus every live worker's exposition with a
  ``worker="wN"`` label injected into the ``di_*`` families (one merged
  family block per metric, so the scrape stays valid Prometheus text);
  ``GET /healthz`` is the fleet's liveness page.
* **rolls over** — ``POST /admin/rollover`` (or SIGHUP) performs a
  zero-downtime weights/config update: spawn replacement workers (with
  e.g. a new ``ckpt_name``), wait until each reports **warm** on
  ``/healthz`` (``status: ok``, ``warm_buckets`` covering the configured
  prefixes, ``weights_signature`` matching the target when one is
  given), atomically swap the routing table, then SIGTERM-drain the old
  workers through their own drain path. In-flight requests
  finish on the old workers; requests racing the swap fail over to the
  new ones; nothing is dropped and no client ever hits a cold capture.
  A replacement that never warms ABORTS the rollover (replacements are
  killed, the old fleet keeps serving) — rollover is all-or-nothing.
* **serves versions** — rollover's ``weights_signature`` plumbing
  generalizes from "replace the fleet" to "run several checkpoint
  versions concurrently". A request pins a version with the
  ``X-DI-Version`` header (or a ``version`` field in a JSON body) and
  is then routed — including every failover retry — ONLY within that
  version's workers; a pinned version with zero healthy workers answers
  503 + ``Retry-After``, never a silent cross-version fallback.
  Unpinned traffic is split by smooth weighted round-robin over the
  canary weights configured via ``POST /admin/versions``, which also
  arms **shadow traffic**: a sampled fraction of ``/predict`` requests
  is mirrored (off the critical path) to the candidate version, the
  outputs are compared, and every comparison is appended to a JSONL
  agreement ledger written atomically through
  ``robustness/artifacts.py``. ``POST /admin/promote`` shifts routing
  weight to the candidate ONLY when the measured agreement clears the
  configured bar (min samples + min agreement rate) and refuses — fleet
  untouched — otherwise. Version weights, shadow config, and promotion
  count persist through the supervisor's ``fleet_state.json`` so a
  kill -9 of the whole control plane drops no version pins.

The rollover response and the router's final stdout line (printed by
``cli/serve.py``) share the machine-readable ``fleet/v1`` contract
(``tools/check_cli_contract.py`` kind ``fleet``); ``/admin/versions``
answers the ``versions/v1`` contract.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import logging
import os
import signal
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Optional, Tuple

from deepinteract_tpu_torch.obs import expfmt
from deepinteract_tpu_torch.obs import metrics as obs_metrics
from deepinteract_tpu_torch.robustness import artifacts
from deepinteract_tpu_torch.robustness.preemption import PreemptionGuard
from deepinteract_tpu_torch.serving.admission import Deadline
from deepinteract_tpu_torch.serving.fleet import (
    QuietHTTPServer,
    WorkerSupervisor,
    endpoint_label,
    fan_out,
    parse_mesh_shape,
    request_json,
)

logger = logging.getLogger(__name__)


def _bucket_hint_dims(bucket_hint: Optional[str]) -> Optional[Tuple[int, int]]:
    """Parse an ``X-DI-Bucket`` hint ("N1xN2") into its bucket dims;
    None for absent/malformed hints — placement is best-effort, a bad
    header must never fail routing."""
    if not bucket_hint:
        return None
    parts = str(bucket_hint).lower().split("x")
    if len(parts) != 2:
        return None
    try:
        return int(parts[0]), int(parts[1])
    except ValueError:
        return None


def _advertises_pair_axis(health: Optional[Dict[str, Any]]) -> bool:
    """True when a worker's /healthz payload advertises a mesh with a
    pair axis (mesh_shape "DxP", P > 1) — the workers huge-complex
    requests prefer. Tolerant of pre-mesh workers (no field -> 1x1)."""
    try:
        return parse_mesh_shape((health or {}).get("mesh_shape"))[1] > 1
    except ValueError:
        return False

_ROUTED = obs_metrics.counter(
    "di_fleet_routed_total", "Requests answered through the router",
    labelnames=("endpoint", "status"))
_FAILOVERS = obs_metrics.counter(
    "di_fleet_failovers_total",
    "Requests retried on a sibling after a worker failed mid-flight",
    labelnames=("reason",))
_ROLLOVERS = obs_metrics.counter(
    "di_fleet_rollovers_total", "Warm rollovers", labelnames=("outcome",))
_VERSION_PICKS = obs_metrics.counter(
    "di_fleet_version_picks_total",
    "Requests assigned to a checkpoint version (pinned or canary split)",
    labelnames=("version", "mode"))
_SHADOW = obs_metrics.counter(
    "di_fleet_shadow_total",
    "Shadow-mirrored requests by comparison outcome",
    labelnames=("outcome",))
_INDEXED_FANOUTS = obs_metrics.counter(
    "di_fleet_indexed_screens_total",
    "Indexed /screen queries scatter/gathered across partition groups")
_PROMOTIONS = obs_metrics.counter(
    "di_fleet_promotions_total", "Version promotion attempts",
    labelnames=("outcome",))
_REQ_LATENCY = obs_metrics.histogram(
    "di_router_request_seconds",
    "Router-side end-to-end proxy latency, failovers included — the "
    "autoscaler's p99 signal")


class RolloverFailed(RuntimeError):
    """A rollover aborted (replacements never warmed / already rolling).
    The OLD fleet keeps serving — failure is never downtime."""


class RolloverBusy(RolloverFailed):
    """A rollover is already in progress (HTTP 409 — retry later). A
    TYPE, not a message substring, so rewording can't break the status
    mapping."""


class VersionError(ValueError):
    """Malformed ``/admin/versions`` / ``/admin/promote`` request
    (HTTP 400); the routing state is untouched."""


class PromotionRefused(RuntimeError):
    """A promotion did not clear the measured-agreement bar (HTTP 409).
    The fleet's routing weights are UNTOUCHED — a candidate earns
    traffic by evidence, not by asking twice."""

    def __init__(self, msg: str, stats: Optional[Dict[str, Any]] = None):
        super().__init__(msg)
        self.stats = dict(stats or {})


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Routing + rollover policy (CLI surface: ``cli/serve.py``)."""

    # Per-attempt proxy bound when the request carries no deadline.
    proxy_timeout_s: float = 120.0
    # Deadline applied when the client sends none (0 = none; then
    # proxy_timeout_s is the only bound) — mirrors the worker flag.
    default_deadline_ms: float = 0.0
    # Compile-inventory label prefixes a replacement must report in
    # /healthz warm_buckets before a rollover may switch to it
    # (e.g. ("128x128/",) from --warmup_buckets). Empty = status ok
    # (+ signature match) is warm enough.
    required_warm_buckets: Tuple[str, ...] = ()
    # Mesh topology label ("DxP") a replacement must advertise in
    # /healthz before a rollover may switch to it, and the fleet
    # contract's topology record. None = any topology (single-device
    # fleets, mixed rehearsals). With it set, warm_buckets prefixes are
    # already topology-prefixed (serving/fleet.mesh_label_prefix), so
    # the rollover warm proof is per-topology end to end.
    required_mesh_shape: Optional[str] = None
    # Bucket pad at/above which a request's X-DI-Bucket hint prefers
    # workers advertising a pair-axis mesh (mesh_shape "Dx P" with
    # P > 1): huge-complex requests route to pair-sharded workers
    # first, with the rest of the fleet as the failover tail. 0 = off.
    pair_bucket_threshold: int = 0
    # Bound on the replacement warm-up wait before a rollover aborts.
    warm_timeout_s: float = 300.0
    # SIGTERM-drain grace for the old workers after the routing swap.
    drain_timeout_s: float = 60.0
    # Short transport bound for /stats//metrics aggregation fetches.
    aggregate_timeout_s: float = 3.0


class FleetRouter:
    """Supervisor-backed HTTP front (module docstring)."""

    def __init__(self, supervisor: WorkerSupervisor,
                 host: str = "127.0.0.1", port: int = 0,
                 cfg: RouterConfig = RouterConfig()):
        self.sup = supervisor
        self.cfg = cfg
        self._draining = threading.Event()
        self._lock = threading.Lock()
        # Worker ids eligible for routing; swapped atomically by
        # rollover. Retired/unknown ids are filtered at pick time
        # against the supervisor's live states.
        self._active: List[str] = []
        self._rr = 0
        self._routed = 0
        self._failovers = 0
        self._rollovers = 0
        # One rollover at a time; a second request answers 409. The
        # separate _rollover_active flag (under _lock) is what /healthz
        # reports — probing the mutex itself from health() could make a
        # real rollover spuriously 409.
        self._rollover_lock = threading.Lock()
        self._rollover_active = False
        # Multi-version routing state (all under _lock). Empty weights =
        # legacy single-pool behaviour: every active worker is one pool.
        self._version_weights: Dict[str, float] = {}
        self._version_rr: Dict[str, float] = {}
        self._shadow: Optional[Dict[str, Any]] = None
        self._shadow_counter = 0
        # Serializes the shadow ledger's rewrites (disk I/O, outside _lock):
        # two mirror threads writing at once share the artifact's tmp name
        # and could land an older snapshot's file beside a newer sidecar.
        self._ledger_lock = threading.Lock()
        self._shadow_samples = 0
        self._shadow_agree = 0
        self._shadow_ledger: List[Dict[str, Any]] = []
        self._promotions = 0
        # Preemption replacements carry a NEW worker id; the supervisor
        # tells us so the routing table swaps old->new in place.
        supervisor.on_replacement = self._on_replacement
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # noqa: N802 - stdlib name
                logger.debug("router http: " + fmt, *args)

            def _send_body(self, code: int, body: bytes, ctype: str,
                           extra: Optional[Dict[str, str]] = None) -> None:
                _ROUTED.inc(endpoint=endpoint_label(
                    self.path, ("/predict", "/screen", "/assembly",
                                "/healthz", "/stats", "/metrics",
                                "/admin/rollover", "/admin/versions",
                                "/admin/promote")),
                    status=str(code))
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for name, value in (extra or {}).items():
                    self.send_header(name, value)
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, payload: Dict,
                           extra: Optional[Dict[str, str]] = None) -> None:
                self._send_body(code, json.dumps(payload).encode(),
                                "application/json", extra=extra)

            def do_GET(self):  # noqa: N802 - stdlib name
                route = self.path.partition("?")[0]
                if route == "/healthz":
                    self._send_json(200, router.health())
                elif route == "/stats":
                    self._send_json(200, router.stats())
                elif route == "/admin/versions":
                    self._send_json(200, router.versions_record())
                elif route == "/metrics":
                    self._send_body(200, router.metrics_text().encode(),
                                    expfmt.CONTENT_TYPE)
                else:
                    self._send_json(404, {"error": f"no route {route}"})

            def do_POST(self):  # noqa: N802 - stdlib name
                route = self.path.partition("?")[0]
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                if route == "/admin/rollover":
                    self._do_rollover(body)
                    return
                if route == "/admin/versions":
                    self._do_versions(body)
                    return
                if route == "/admin/promote":
                    self._do_promote(body)
                    return
                if route not in ("/predict", "/screen", "/assembly"):
                    self._send_json(404, {"error": f"no route {route}"})
                    return
                if router._draining.is_set():
                    self._send_json(503, {"error": "router is draining"})
                    return
                try:
                    deadline = self._deadline()
                except ValueError as exc:
                    self._send_json(400, {"error": str(exc)})
                    return
                if (route == "/screen" and body
                        and b'"index_path"' in body
                        and b'"partitions"' not in body):
                    # Indexed screen: scatter partition groups across
                    # the fleet, gather + merge the rankings. A body
                    # that already scopes "partitions" is a sub-request
                    # (or a client wanting one worker) and proxies
                    # normally — no recursive fan-out.
                    status, out, headers = router.indexed_screen(
                        body, deadline=deadline,
                        version=self._version_pin(body))
                else:
                    status, out, headers = router.proxy(
                        "POST", self.path, body,
                        content_type=self.headers.get(
                            "Content-Type",
                            "application/octet-stream"),
                        bucket_hint=self.headers.get("X-DI-Bucket"),
                        deadline=deadline,
                        version=self._version_pin(body))
                self._send_body(status, out,
                                headers.pop("Content-Type",
                                            "application/json"),
                                extra=headers)

            def _version_pin(self, body: bytes) -> Optional[str]:
                """The request's pinned version: ``X-DI-Version`` header,
                else a ``version`` field in a JSON body. The body parse
                only runs when the raw bytes can contain the key, so
                unpinned hot-path requests never pay a JSON decode."""
                pin = self.headers.get("X-DI-Version")
                if pin is not None:
                    return pin
                if body and b'"version"' in body:
                    try:
                        payload = json.loads(body.decode())
                    except (ValueError, UnicodeDecodeError):
                        return None  # the worker answers 400 for itself
                    if isinstance(payload, dict) and \
                            payload.get("version") is not None:
                        return str(payload["version"])
                return None

            def _do_versions(self, body: bytes) -> None:
                try:
                    spec = json.loads(body.decode()) if body else {}
                    if not isinstance(spec, dict):
                        raise VersionError(
                            "versions body must be a JSON object")
                    record = router.set_versions(spec)
                except (VersionError, ValueError) as exc:
                    self._send_json(400, {"error": str(exc), "ok": False})
                    return
                self._send_json(200, record)

            def _do_promote(self, body: bytes) -> None:
                try:
                    spec = json.loads(body.decode()) if body else {}
                    if not isinstance(spec, dict):
                        raise VersionError(
                            "promote body must be a JSON object")
                    record = router.promote(spec)
                except PromotionRefused as exc:
                    self._send_json(409, {
                        **router.versions_record(), "ok": False,
                        "error": str(exc), "refused": exc.stats})
                    return
                except (VersionError, ValueError) as exc:
                    self._send_json(400, {"error": str(exc), "ok": False})
                    return
                self._send_json(200, record)

            def _deadline(self) -> Optional[Deadline]:
                hdr = self.headers.get("X-Request-Deadline-Ms")
                if hdr is not None:
                    ms = float(hdr)
                    if not ms > 0:
                        raise ValueError(
                            f"X-Request-Deadline-Ms must be > 0, got "
                            f"{hdr!r}")
                    return Deadline.after(ms / 1e3)
                if router.cfg.default_deadline_ms > 0:
                    return Deadline.after(
                        router.cfg.default_deadline_ms / 1e3)
                return None

            def _do_rollover(self, body: bytes) -> None:
                try:
                    overrides = json.loads(body.decode()) if body else {}
                    if not isinstance(overrides, dict):
                        raise ValueError(
                            "rollover body must be a JSON object")
                except ValueError as exc:
                    self._send_json(400, {"error": str(exc)})
                    return
                try:
                    record = router.rollover(overrides)
                except RolloverFailed as exc:
                    self._send_json(
                        409 if isinstance(exc, RolloverBusy) else 500,
                        {**router.final_contract(),
                         "error": str(exc), "ok": False})
                    return
                self._send_json(200, {**router.final_contract(),
                                      "rollover": record})

        self.httpd = QuietHTTPServer((host, port), Handler)
        self._serve_thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    @property
    def address(self) -> Tuple[str, int]:
        host, port = self.httpd.server_address[:2]
        return str(host), int(port)

    def start(self) -> "FleetRouter":
        """Spawn the fleet (if not already started) and start accepting
        connections. The routing table adopts every current worker;
        routability is still gated per request on live health."""
        self.sup.start()
        with self._lock:
            if not self._active:
                self._active = [w["worker_id"]
                                for w in self.sup.worker_infos()
                                if w["state"] != "retired"]
        self._restore_versions()
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, name="fleet-router",
            daemon=True)
        self._serve_thread.start()
        return self

    def drain(self) -> None:
        """Stop accepting, stop the listener, drain every worker."""
        if self._draining.is_set():
            return
        self._draining.set()
        self.httpd.shutdown()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10.0)
        self.httpd.server_close()
        self.sup.stop()

    def run(self, guard: Optional[PreemptionGuard] = None,
            poll_seconds: float = 0.25) -> int:
        """Blocking serve loop with the preemption discipline, plus
        SIGHUP = warm rollover (the classic reload signal)."""
        own_guard = guard is None
        guard = guard or PreemptionGuard(log=logger.warning)
        if own_guard:
            guard.__enter__()
        self._install_sighup()
        try:
            host, port = self.address
            logger.info(
                "fleet router on http://%s:%d (POST /predict, POST "
                "/screen, POST /assembly, POST /admin/rollover, GET "
                "/healthz, GET /stats, GET /metrics; SIGHUP = rollover)",
                host, port)
            while not guard.requested:
                time.sleep(poll_seconds)
            logger.warning("drain requested (%s): stopping router and "
                           "draining %d worker(s)", guard.reason,
                           len(self.sup.worker_infos()))
        finally:
            self.drain()
            if own_guard:
                guard.__exit__(None, None, None)
        return 0

    def _install_sighup(self) -> None:
        def _on_hup(*_):
            def _roll():
                try:
                    self.rollover({})
                except RolloverFailed as exc:
                    logger.error("SIGHUP rollover failed: %s", exc)

            threading.Thread(target=_roll, name="sighup-rollover",
                             daemon=True).start()

        try:
            signal.signal(signal.SIGHUP, _on_hup)
        except (ValueError, AttributeError, OSError):
            # Not the main thread (tests) or no SIGHUP (platform):
            # /admin/rollover is the portable path.
            logger.debug("SIGHUP rollover handler not installed")

    # -- routing -----------------------------------------------------------

    def _pick_sequence(self, bucket_hint: Optional[str],
                       version: Optional[str] = None) -> List[str]:
        """Failover-ordered candidate workers: every routable worker at
        most once, starting from the bucket-affine (or round-robin)
        choice. A pinned ``version`` restricts candidates — and every
        failover retry — to that version's workers; zero healthy pinned
        workers yields an EMPTY sequence (the caller answers 503 +
        Retry-After), never a cross-version fallback. Unpinned requests
        under configured canary weights choose a version by smooth
        weighted round-robin and order its workers first; other
        versions' workers stay as the failover tail, so an unpinned
        request is never dropped while ANY version is healthy."""
        health_of = {w["worker_id"]: (w.get("health") or {})
                     for w in self.sup.routable_workers()}
        sig_of = {wid: str(health.get("weights_signature"))
                  for wid, health in health_of.items()}
        chosen: Optional[str] = None
        with self._lock:
            candidates = [wid for wid in self._active if wid in sig_of]
            if version is not None:
                candidates = [wid for wid in candidates
                              if sig_of[wid] == version]
            if not candidates:
                return []
            if bucket_hint:
                start = zlib.crc32(bucket_hint.encode()) % len(candidates)
            else:
                start = self._rr % len(candidates)
                self._rr += 1
            sequence = candidates[start:] + candidates[:start]
            if version is None and self._version_weights:
                chosen = self._choose_version_locked(
                    {sig_of[wid] for wid in candidates})
                if chosen is not None:
                    sequence = (
                        [w for w in sequence if sig_of[w] == chosen]
                        + [w for w in sequence if sig_of[w] != chosen])
            if self._wants_pair_worker(bucket_hint):
                # Topology-aware placement LAST (it outranks the version
                # ordering): a p512+ hint goes to pair-sharded workers
                # first — a data-parallel worker would decode the huge
                # map on one chip (models/tiled.py) at a latency the
                # pair path exists to beat. Stable within each group;
                # non-pair workers remain as the failover tail, so the
                # request still completes on a degraded fleet.
                pair_first = [w for w in sequence
                              if _advertises_pair_axis(health_of.get(w))]
                if pair_first:
                    sequence = pair_first + [w for w in sequence
                                             if w not in set(pair_first)]
        picked = version if version is not None else chosen
        if picked is not None:
            _VERSION_PICKS.inc(version=picked,
                               mode="pinned" if version else "weighted")
        return sequence

    def _wants_pair_worker(self, bucket_hint: Optional[str]) -> bool:
        """Placement trigger: the bucket hint's longer side reaches the
        configured pair threshold — the same over-threshold rule the
        engine's placement policy applies (serving/fleet.mesh_placement),
        read from the request side."""
        if self.cfg.pair_bucket_threshold <= 0:
            return False
        dims = _bucket_hint_dims(bucket_hint)
        return (dims is not None
                and max(dims) >= self.cfg.pair_bucket_threshold)

    def _choose_version_locked(self, available: set) -> Optional[str]:
        """Smooth weighted round-robin (the nginx algorithm) over the
        configured weights, restricted to versions that have a routable
        worker RIGHT NOW — a weighted-but-down version never swallows
        picks. Caller holds ``_lock``."""
        weights = {v: w for v, w in self._version_weights.items()  # di: allow[lock-discipline] caller holds _lock
                   if v in available and w > 0}
        if not weights:
            return None
        total = sum(weights.values())
        for v, w in weights.items():
            self._version_rr[v] = self._version_rr.get(v, 0.0) + w  # di: allow[lock-discipline] caller holds _lock
        best = max(sorted(weights), key=lambda v: self._version_rr[v])  # di: allow[lock-discipline] caller holds _lock
        self._version_rr[best] -= total  # di: allow[lock-discipline] caller holds _lock
        return best

    def proxy(self, method: str, path: str, body: bytes,
              content_type: str = "application/json",
              bucket_hint: Optional[str] = None,
              deadline: Optional[Deadline] = None,
              version: Optional[str] = None,
              ) -> Tuple[int, bytes, Dict[str, str]]:
        """Forward one idempotent request, failing over across siblings
        (within the pinned ``version``'s workers when one is given).
        Returns (status, body, response headers); observes the router
        latency histogram (the autoscaler's p99 signal) and mirrors a
        sampled fraction of successful unpinned ``/predict`` requests to
        the shadow candidate off the critical path."""
        t0 = time.monotonic()
        status, out, headers = self._route(
            method, path, body, content_type, bucket_hint, deadline,
            version)
        _REQ_LATENCY.observe(time.monotonic() - t0)
        if version is not None:
            headers.setdefault("X-DI-Version", version)
        elif status == 200:
            self._maybe_shadow(method, path, body, content_type, out)
        return status, out, headers

    def indexed_screen(self, body: bytes,
                       deadline: Optional[Deadline] = None,
                       version: Optional[str] = None,
                       ) -> Tuple[int, bytes, Dict[str, str]]:
        """Partition-affine scatter/gather for an indexed ``/screen``.

        The router reads the index manifest (partition table only — it
        never touches shard bytes), assigns every partition to a worker
        slot by ``crc32(partition_id) % n_workers`` — the SAME affinity
        hash ``_pick_sequence`` applies to the sub-request's
        ``bucket_hint``, so each worker owns a stable partition slice
        and its shard cache stays warm — and fans the sub-requests (the
        client body + a ``partitions`` scope) through :meth:`_route`,
        inheriting failover and version-pinning unchanged: a worker
        SIGKILL'd mid-query just moves its groups to siblings. Gather
        merges the per-group rankings by ``(-score, pair_id)``; groups
        that failed every retry mark the merged answer ``partial``
        rather than voiding the survivors that did come back."""
        try:
            payload = json.loads(body.decode())
            if not isinstance(payload, dict):
                raise ValueError("screen body must be a JSON object")
        except (ValueError, UnicodeDecodeError) as exc:
            return self._count(400, json.dumps(
                {"error": f"indexed screen body: {exc}"}).encode(), {})
        from deepinteract_tpu_torch.index.format import read_manifest
        try:
            manifest = read_manifest(str(payload.get("index_path")))
        except (artifacts.ArtifactError, OSError, TypeError) as exc:
            return self._count(400, json.dumps(
                {"error": f"index: {exc}"}).encode(), {})
        pids = sorted(p["partition_id"] for p in manifest["partitions"])
        if not pids:
            return self._count(400, json.dumps(
                {"error": "index has no partitions"}).encode(), {})
        sequence = self._pick_sequence(None, version)
        if not sequence:
            return self._count(503, json.dumps({
                "error": "no healthy worker available for indexed "
                         "screen" + (f" (version {version!r})"
                                     if version else ""),
                "retry_after_s": 1.0,
            }).encode(), {"Retry-After": "1"})
        n = len(sequence)
        groups: Dict[int, List[str]] = {}
        for pid in pids:
            groups.setdefault(zlib.crc32(pid.encode()) % n,
                              []).append(pid)
        join_s = (deadline.remaining_s() + 1.0 if deadline is not None
                  else self.cfg.proxy_timeout_s + 1.0)
        tasks = {}
        for g in sorted(groups):
            sub = json.dumps({**payload,
                              "partitions": groups[g]}).encode()
            tasks[g] = (lambda b=sub, hint=groups[g][0]: self._route(
                "POST", "/screen", b, "application/json", hint,
                deadline, version))
        _INDEXED_FANOUTS.inc()
        results = fan_out(tasks, join_timeout_s=join_s,
                          name="indexed-screen")
        merged: List[Dict] = []
        served: List[str] = []
        failed: List[Dict] = []
        statuses: List[int] = []
        partial = False
        totals = {"candidates": 0, "survivors": 0, "pairs_decoded": 0}
        for g in sorted(groups):
            res = results.get(g)
            if res is None:
                failed.append({"partitions": groups[g],
                               "error": "fan-out timed out"})
                continue
            status, out, _ = res
            if status != 200:
                try:
                    err = json.loads(out.decode()).get("error", "")
                except (ValueError, UnicodeDecodeError):
                    err = out[:200].decode(errors="replace")
                failed.append({"partitions": groups[g],
                               "status": status, "error": err})
                statuses.append(status)
                continue
            try:
                sub_out = json.loads(out.decode())
            except (ValueError, UnicodeDecodeError):
                failed.append({"partitions": groups[g],
                               "error": "torn worker response"})
                continue
            merged.extend(sub_out.get("ranked", []))
            served.extend(sub_out.get("partitions_served", groups[g]))
            partial = partial or bool(sub_out.get("partial"))
            for key in totals:
                totals[key] += int(sub_out.get(key, 0))
        if failed and not merged and len(failed) == len(groups):
            status = (statuses[0] if statuses
                      and all(s == statuses[0] for s in statuses)
                      else 503)
            return self._count(status, json.dumps({
                "error": "indexed screen failed on every partition "
                         "group",
                "failed_groups": len(failed),
                "failed_detail": failed}).encode(), {})
        merged.sort(key=lambda r: (-float(r.get("score", 0.0)),
                                   str(r.get("pair_id", ""))))
        answer = {
            "indexed": True,
            "index_path": payload.get("index_path"),
            "query": payload.get("query"),
            "chains": int(manifest["num_chains"]),
            "partitions": len(pids),
            "partitions_served": sorted(served),
            "fanout_groups": len(groups),
            "failed_groups": len(failed),
            "failed_detail": failed,
            "partial": partial or bool(failed),
            "ranked": merged,
            **totals,
        }
        headers = {"X-DI-Fanout": str(len(groups))}
        if version is not None:
            headers["X-DI-Version"] = version
        return self._count(200, json.dumps(answer).encode(), headers)

    def _route(self, method: str, path: str, body: bytes,
               content_type: str, bucket_hint: Optional[str],
               deadline: Optional[Deadline], version: Optional[str],
               ) -> Tuple[int, bytes, Dict[str, str]]:
        """The failover loop behind :meth:`proxy`. After exhausting the
        candidate list, ONE re-pick: a request that raced a rollover's
        routing swap may have frozen the OLD (now-draining) workers as
        its candidates while warm replacements exist — the second pick
        reads the post-swap table, keeping the zero-dropped contract.
        When every candidate answered a worker-side 500 (a transient
        batch failure — 'safe to retry' per the serving contract), the
        LAST such response is returned rather than a misleading
        no-healthy-worker 503."""
        attempts: List[str] = []
        last_500: List[Tuple[int, bytes, Dict[str, str]]] = []
        sequence = self._pick_sequence(bucket_hint, version)
        for round_no in (1, 2):
            if round_no == 2:
                refreshed = self._pick_sequence(bucket_hint, version)
                sequence = [wid for wid in refreshed
                            if wid not in attempts]
                if not sequence:
                    break
            status_out = self._proxy_round(
                sequence, attempts, method, path, body, content_type,
                deadline, last_500)
            if status_out is not None:
                return status_out
        if last_500:
            return self._count(*last_500[-1])
        retry_after = 1.0
        pool = ("no healthy worker available" if version is None
                else f"no healthy worker for version {version!r} "
                     "(pinned requests never fall back to another "
                     "version)")
        return self._count(503, json.dumps({
            "error": pool
                     + (f" (attempted {attempts})" if attempts else ""),
            "retry_after_s": retry_after,
        }).encode(), {"Retry-After": str(int(retry_after))})

    def _proxy_round(self, sequence: List[str], attempts: List[str],
                     method: str, path: str, body: bytes,
                     content_type: str, deadline: Optional[Deadline],
                     last_500: List) -> Optional[Tuple]:
        """One pass over ``sequence``; returns an answer tuple or None
        when every candidate failed over (worker-500 responses are
        stashed in ``last_500`` for the caller's fallback)."""
        for worker_id in sequence:
            if deadline is not None and deadline.expired:
                return self._count(504, json.dumps({
                    "error": "deadline expired while failing over",
                    "attempted_workers": attempts}).encode(), {})
            try:
                host, port = self.sup.endpoint(worker_id)
            except KeyError:
                continue
            timeout = self.cfg.proxy_timeout_s
            if deadline is not None:
                timeout = min(timeout, deadline.remaining_s() + 0.25)
            attempts.append(worker_id)
            try:
                status, out, headers = self._attempt(
                    host, port, method, path, body, content_type,
                    deadline, timeout)
            except Exception as exc:  # noqa: BLE001 - transport failover
                self._note_failover(worker_id, f"transport: {exc}",
                                    reason="transport")
                continue
            if status == 503:
                # Draining/shutting-down sibling: the work was refused,
                # not executed — the retry contract says "another
                # replica", and the router IS the other replica's door.
                self._note_failover(worker_id, "worker answered 503",
                                    reason="worker_draining")
                continue
            if status == 500:
                # A worker 500 is a transient batch failure
                # (BatchExecutionError — "safe to retry" in the serving
                # client contract) and predict/screen are pure: retry
                # on a sibling, keeping the response in case every
                # sibling fails the same way.
                headers["X-DI-Worker"] = worker_id
                last_500.append((status, out, headers))
                self._note_failover(worker_id, "worker answered 500",
                                    reason="worker_error")
                continue
            headers["X-DI-Worker"] = worker_id
            if len(attempts) > 1:
                headers["X-DI-Failovers"] = str(len(attempts) - 1)
            return self._count(status, out, headers)
        return None

    def _count(self, status: int, body: bytes,
               headers: Dict[str, str]) -> Tuple[int, bytes, Dict[str, str]]:
        with self._lock:
            self._routed += 1
        return status, body, headers

    def _note_failover(self, worker_id: str, detail: str,
                       reason: str) -> None:
        with self._lock:
            self._failovers += 1
        _FAILOVERS.inc(reason=reason)
        logger.warning("fleet: failing over off %s (%s)", worker_id,
                       detail)

    def _attempt(self, host: str, port: int, method: str, path: str,
                 body: bytes, content_type: str,
                 deadline: Optional[Deadline],
                 timeout: float) -> Tuple[int, bytes, Dict[str, str]]:
        conn = http.client.HTTPConnection(host, port,
                                          timeout=max(0.05, timeout))
        try:
            headers = {"Content-Type": content_type,
                       "Content-Length": str(len(body))}
            if deadline is not None:
                headers["X-Request-Deadline-Ms"] = str(
                    max(1.0, deadline.remaining_s() * 1e3))
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            out = resp.read()
            passthrough = {}
            for name in ("Retry-After", "Content-Type"):
                value = resp.getheader(name)
                if value is not None:
                    passthrough[name] = value
            return resp.status, out, passthrough
        finally:
            conn.close()

    # -- rollover ----------------------------------------------------------

    def rollover(self, overrides: Optional[Dict[str, Any]] = None) -> Dict:
        """Zero-downtime worker replacement (module docstring). Raises
        :class:`RolloverFailed` when replacements never warm (they are
        killed; the old fleet keeps serving) or when another rollover is
        already in progress."""
        overrides = dict(overrides or {})
        if not self._rollover_lock.acquire(blocking=False):
            raise RolloverBusy("a rollover is already in progress")
        with self._lock:
            self._rollover_active = True
        t0 = time.monotonic()
        try:
            target_sig = overrides.get("weights_signature")
            with self._lock:
                old = list(self._active)
            n = len(old) or max(1, self.sup.cfg.num_workers)
            new_ids: List[str] = []
            try:
                new_ids = self.sup.spawn_replacements(n, overrides)
                logger.info("rollover: spawned replacement(s) %s "
                            "(target signature: %s)", new_ids,
                            target_sig or "<any>")
                pending = set(new_ids)
                warm_deadline = (time.monotonic()
                                 + self.cfg.warm_timeout_s)
                # Warm-wait cadence: bounded below the monitor's own
                # interval but never a tight loop — real replacements
                # spend minutes compiling, and hammering /healthz 20x/s
                # fleet-wide would be pure overhead against workers
                # that are busy warming.
                wait_s = min(max(self.sup.cfg.probe_interval_s, 0.05),
                             0.25)
                while pending and time.monotonic() < warm_deadline:
                    self.sup.poll_once()
                    for wid in list(pending):
                        if self._is_warm(wid, target_sig):
                            pending.discard(wid)
                    if pending:
                        time.sleep(wait_s)
                if pending:
                    raise RolloverFailed(
                        f"replacement(s) {sorted(pending)} not warm "
                        f"after {self.cfg.warm_timeout_s:.0f}s — "
                        "rollover aborted, old fleet keeps serving")
            except BaseException as exc:
                # ANY failure before the swap aborts all-or-nothing:
                # already-spawned replacements must not linger under
                # supervision (each retried rollover would strand
                # another batch of new-weights workers).
                if new_ids:
                    self.sup.drain_many(new_ids, timeout_s=5.0)
                _ROLLOVERS.inc(outcome="failed")
                if isinstance(exc, RolloverFailed):
                    raise
                if not isinstance(exc, Exception):
                    # KeyboardInterrupt/SystemExit keep their type —
                    # cleanup done, but exit signals must not be
                    # laundered into an ordinary failed rollover.
                    raise
                raise RolloverFailed(
                    f"rollover failed before the routing swap: {exc!r} "
                    "— replacements cleaned up, old fleet keeps "
                    "serving") from exc
            # The atomic moment: new picks go to the replacements; old
            # workers only see requests already past _pick_sequence (and
            # those either finish during the drain below or fail over).
            with self._lock:
                self._active = list(new_ids)
                self._rollovers += 1
            _ROLLOVERS.inc(outcome="ok")
            # Parallel drains: N x drain_timeout_s sequential could
            # outlive the rollover client's socket timeout on a wide
            # fleet (supervisor drain_many is the shared fan-out).
            exit_codes = self.sup.drain_many(
                old, timeout_s=self.cfg.drain_timeout_s)
            record = {
                "ok": True,
                "old_workers": old,
                "new_workers": new_ids,
                "drain_exit_codes": exit_codes,
                "target_weights_signature": target_sig,
                "elapsed_s": round(time.monotonic() - t0, 3),
            }
            logger.info("rollover complete: %s", record)
            return record
        finally:
            with self._lock:
                self._rollover_active = False
            self._rollover_lock.release()

    def _is_warm(self, worker_id: str,
                 target_sig: Optional[str]) -> bool:
        try:
            info = self.sup.worker_info(worker_id)
        except KeyError:
            return False
        health = info.get("health") or {}
        if info["state"] != "healthy" or health.get("status") != "ok":
            return False
        if target_sig and health.get("weights_signature") != target_sig:
            return False
        if (self.cfg.required_mesh_shape
                and str(health.get("mesh_shape") or "1x1")
                != self.cfg.required_mesh_shape):
            # Wrong topology can never be warm: its graph inventory
            # belongs to a different device layout even if the label
            # prefixes happened to match.
            return False
        warm = health.get("warm_buckets") or []
        return all(any(str(label).startswith(req) for label in warm)
                   for req in self.cfg.required_warm_buckets)

    # -- multi-version serving ---------------------------------------------

    def adopt_worker(self, worker_id: str) -> None:
        """Add a (warm) worker to the routing table — the autoscaler's
        scale-up entry after its replacement finished warming."""
        with self._lock:
            if worker_id not in self._active:
                self._active.append(worker_id)

    def release_worker(self, worker_id: str) -> None:
        """Remove a worker from the routing table BEFORE draining it —
        new picks stop immediately; in-flight requests finish or fail
        over."""
        with self._lock:
            if worker_id in self._active:
                self._active.remove(worker_id)

    def _on_replacement(self, old_id: str, new_id: str) -> None:
        """Supervisor callback: a preempted worker's replacement swaps
        into the old worker's routing slot (same overrides, same
        version) — capacity recovers without operator action."""
        with self._lock:
            if old_id in self._active:
                self._active[self._active.index(old_id)] = new_id

    def request_p99_ms(self) -> float:
        """Router-side p99 latency in ms (0.0 before any request) — one
        of the autoscaler's inputs."""
        return _REQ_LATENCY.percentile(99) * 1e3

    def set_versions(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        """Apply a ``POST /admin/versions`` spec: ``weights`` (canary
        split, ``{signature: weight}``) and/or ``shadow`` (mirror
        config: ``candidate``, ``fraction``, optional ``tolerance`` /
        ``min_agreement`` / ``min_samples`` / ``ledger_path``; null
        disarms). Validates fully BEFORE touching state, persists
        through the supervisor's fleet_state.json, and returns the
        ``versions/v1`` record."""
        weights = None
        if spec.get("weights") is not None:
            weights = self._parse_weights(spec["weights"])
        shadow = None
        if spec.get("shadow") is not None:
            shadow = self._parse_shadow(spec["shadow"])
        with self._lock:
            if weights is not None:
                self._version_weights = weights
                self._version_rr = {}
            if "shadow" in spec:
                old_candidate = (self._shadow or {}).get("candidate")
                self._shadow = shadow
                if shadow is None or \
                        shadow["candidate"] != old_candidate:
                    # A new (or cleared) candidate starts its agreement
                    # evidence from zero — stale ledgers don't promote.
                    self._shadow_counter = 0
                    self._shadow_samples = 0
                    self._shadow_agree = 0
                    self._shadow_ledger = []
        self._persist_versions()
        logger.info("versions: weights=%s shadow=%s",
                    weights if weights is not None else "<unchanged>",
                    shadow if "shadow" in spec else "<unchanged>")
        return self.versions_record()

    @staticmethod
    def _parse_weights(raw: Any) -> Dict[str, float]:
        if not isinstance(raw, dict):
            raise VersionError("weights must be an object "
                               "{signature: weight}")
        weights: Dict[str, float] = {}
        for sig, value in raw.items():
            try:
                w = float(value)
            except (TypeError, ValueError):
                raise VersionError(
                    f"weight for {sig!r} must be a number, got "
                    f"{value!r}")
            if w < 0:
                raise VersionError(f"weight for {sig!r} must be >= 0")
            if w > 0:
                weights[str(sig)] = w
        if raw and not weights:
            raise VersionError("at least one weight must be > 0")
        return weights

    def _parse_shadow(self, raw: Any) -> Dict[str, Any]:
        if not isinstance(raw, dict) or not raw.get("candidate"):
            raise VersionError(
                "shadow must be an object with a 'candidate' signature")
        candidate = str(raw["candidate"])
        try:
            fraction = float(raw.get("fraction", 1.0))
        except (TypeError, ValueError):
            raise VersionError("shadow fraction must be a number")
        if not 0 < fraction <= 1:
            raise VersionError("shadow fraction must be in (0, 1]")
        default_ledger = os.path.join(
            os.path.dirname(self.sup.state_path),
            f"agreement_{candidate}.jsonl")
        return {
            "candidate": candidate,
            "fraction": fraction,
            "tolerance": float(raw.get("tolerance", 1e-6)),
            "min_agreement": float(raw.get("min_agreement", 0.98)),
            "min_samples": int(raw.get("min_samples", 10)),
            "ledger_path": str(raw.get("ledger_path", default_ledger)),
        }

    def promote(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        """``POST /admin/promote``: shift routing weight to the shadow
        candidate ONLY on measured agreement. Raises
        :class:`PromotionRefused` (fleet untouched) when the evidence
        does not clear the bar, :class:`VersionError` when there is no
        candidate to judge."""
        with self._lock:
            shadow = dict(self._shadow) if self._shadow else {}
            samples, agree = self._shadow_samples, self._shadow_agree
        candidate = spec.get("candidate") or shadow.get("candidate")
        if not candidate:
            raise VersionError("no promotion candidate: pass "
                               "'candidate' or arm shadow traffic first")
        min_agreement = float(
            spec.get("min_agreement",
                     shadow.get("min_agreement", 0.98)))
        min_samples = int(
            spec.get("min_samples", shadow.get("min_samples", 10)))
        rate = (agree / samples) if samples else 0.0
        stats = {"candidate": candidate, "samples": samples,
                 "agreements": agree,
                 "agreement_rate": round(rate, 6),
                 "min_agreement": min_agreement,
                 "min_samples": min_samples}
        if samples < min_samples or rate < min_agreement:
            _PROMOTIONS.inc(outcome="refused")
            raise PromotionRefused(
                f"promotion refused: {samples} sample(s) at "
                f"{rate:.4f} agreement vs bar of >= {min_samples} "
                f"samples and >= {min_agreement:.4f} — routing weights "
                "untouched", stats=stats)
        weights = self._parse_weights(
            spec.get("weights") or {candidate: 1.0})
        with self._lock:
            self._version_weights = weights
            self._version_rr = {}
            self._shadow = None
            self._promotions += 1
        _PROMOTIONS.inc(outcome="ok")
        self._persist_versions()
        logger.info("promotion: %s -> weights %s (%s)", candidate,
                    weights, stats)
        return {**self.versions_record(), "promoted": candidate,
                "evidence": stats}

    def versions_record(self) -> Dict[str, Any]:
        """The ``versions/v1`` machine-readable record (the
        ``/admin/versions`` response and ``cli/serve.py --versions``
        final line)."""
        by_version: Dict[str, int] = {}
        for w in self.sup.routable_workers():
            sig = str((w.get("health") or {}).get("weights_signature"))
            by_version[sig] = by_version.get(sig, 0) + 1
        with self._lock:
            weights = dict(self._version_weights)
            shadow = dict(self._shadow) if self._shadow else None
            samples, agree = self._shadow_samples, self._shadow_agree
            promotions = self._promotions
        return {
            "schema": "versions/v1",
            "metric": "fleet_active_versions",
            "value": float(len(by_version)),
            "unit": "versions",
            "ok": True,
            "weights": weights,
            "workers_by_version": by_version,
            "shadow": shadow,
            "shadow_samples": samples,
            "shadow_agreement": (round(agree / samples, 6)
                                 if samples else None),
            "promotions": promotions,
        }

    def _persist_versions(self) -> None:
        with self._lock:
            record = {
                "weights": dict(self._version_weights),
                "shadow": dict(self._shadow) if self._shadow else None,
                "promotions": self._promotions,
            }
        try:
            self.sup.set_extra_state("versions", record)
        except (OSError, ValueError) as exc:
            logger.warning("versions: persist failed: %s", exc)

    def _restore_versions(self) -> None:
        """Recover version weights / shadow config / promotion count
        from a dead supervisor's fleet_state.json — kill -9 of the
        control plane drops no version pins."""
        record = self.sup.recovered_state().get("versions")
        if not isinstance(record, dict):
            return
        weights = record.get("weights")
        shadow = record.get("shadow")
        with self._lock:
            if isinstance(weights, dict):
                restored: Dict[str, float] = {}
                for sig, value in weights.items():
                    if isinstance(value, (int, float)) and value > 0:
                        restored[str(sig)] = float(value)
                self._version_weights = restored
                self._version_rr = {}
            if isinstance(shadow, dict) and shadow.get("candidate"):
                self._shadow = shadow
            promotions = record.get("promotions")
            if isinstance(promotions, int):
                self._promotions = promotions
        logger.info("versions: restored from fleet_state.json: %s",
                    record)
        self._persist_versions()

    def _maybe_shadow(self, method: str, path: str, body: bytes,
                      content_type: str, primary_out: bytes) -> None:
        """Counter-based deterministic sampling: request n is mirrored
        iff floor(n*f) advanced — exactly fraction f of requests, no
        RNG. The mirror runs on its own daemon thread; the client's
        response already left."""
        if path.partition("?")[0] != "/predict":
            return
        with self._lock:
            shadow = self._shadow
            if not shadow:
                return
            self._shadow_counter += 1
            n, f = self._shadow_counter, shadow["fraction"]
            if int(n * f) == int((n - 1) * f):
                return
            shadow = dict(shadow)
        threading.Thread(
            target=self._shadow_one,
            args=(shadow, method, path, body, content_type, primary_out),
            name="shadow-mirror", daemon=True).start()

    def _shadow_one(self, shadow: Dict[str, Any], method: str, path: str,
                    body: bytes, content_type: str,
                    primary_out: bytes) -> None:
        candidate = shadow["candidate"]
        entry: Dict[str, Any] = {"ts": round(time.time(), 3),
                                 "path": path, "candidate": candidate}
        agreed: Optional[bool] = None
        try:
            sequence = self._pick_sequence(None, version=candidate)
            if not sequence:
                entry["outcome"] = "no_worker"
                _SHADOW.inc(outcome="no_worker")
            else:
                worker_id = sequence[0]
                host, port = self.sup.endpoint(worker_id)
                status, out, _ = self._attempt(
                    host, port, method, path, body, content_type, None,
                    self.cfg.proxy_timeout_s)
                entry["shadow_worker"] = worker_id
                if status != 200:
                    entry.update(outcome="error", status=status)
                    _SHADOW.inc(outcome="error")
                else:
                    agreed, diff = _prediction_agreement(
                        primary_out, out, shadow["tolerance"])
                    entry["outcome"] = "agree" if agreed else "disagree"
                    if diff is not None:
                        entry["max_abs_diff"] = diff
                    _SHADOW.inc(outcome=entry["outcome"])
        except Exception as exc:  # noqa: BLE001 - shadow is best-effort
            entry.update(outcome="error", error=str(exc))
            _SHADOW.inc(outcome="error")
            agreed = None
        self._append_ledger(shadow["ledger_path"], entry, agreed)

    def _append_ledger(self, path: str, entry: Dict[str, Any],
                       agreed: Optional[bool] = None) -> None:
        """Append to the in-memory ledger and rewrite the WHOLE JSONL
        atomically (artifact + integrity sidecar): a reader — the
        promotion rule, an operator's tail — sees a complete, verifiable
        ledger or the previous one, never a torn line. Rewrites are
        serialized in append order, so the newest ledger lands last.
        A compared sample (``agreed`` not None) is counted only after its
        rewrite, so a reader that sees n samples finds a ledger on disk
        with at least n entries (counting before the write let a reader
        see the count and then an older, shorter ledger)."""
        with self._ledger_lock:
            with self._lock:
                self._shadow_ledger.append(entry)
                data = "".join(json.dumps(e, sort_keys=True) + "\n"
                               for e in self._shadow_ledger)
                entries = len(self._shadow_ledger)
            try:
                artifacts.atomic_write_artifact(
                    path, data, "agreement_ledger",
                    extra={"entries": entries})
            except OSError as exc:
                logger.warning("shadow: ledger write failed: %s", exc)
            if agreed is not None:
                with self._lock:
                    self._shadow_samples += 1
                    self._shadow_agree += int(agreed)

    # -- observability -----------------------------------------------------

    def health(self) -> Dict[str, Any]:
        infos = self.sup.worker_infos()
        active = [w for w in infos if w["state"] != "retired"]
        healthy = [w for w in active if w["state"] == "healthy"]
        draining = self._draining.is_set()
        status = ("draining" if draining
                  else "down" if not healthy
                  else "ok" if len(healthy) == len(active) else "degraded")
        with self._lock:
            rollover_busy = self._rollover_active
            version_weights = dict(self._version_weights)
            shadow_candidate = (self._shadow or {}).get("candidate")
        return {
            "status": status,
            "role": "fleet-router",
            "draining": draining,
            "workers": len(active),
            "healthy": len(healthy),
            "rollover_in_progress": rollover_busy,
            "weights_signatures": sorted(
                {str(w["health"].get("weights_signature"))
                 for w in healthy if w.get("health")}),
            "version_weights": version_weights,
            "shadow_candidate": shadow_candidate,
        }

    def stats(self) -> Dict[str, Any]:
        worker_stats = self._fetch_workers("/stats")
        with self._lock:
            router = {
                "routed": self._routed,
                "failovers": self._failovers,
                "rollovers": self._rollovers,
                "active_workers": list(self._active),
                "draining": self._draining.is_set(),
                "version_weights": dict(self._version_weights),
                "shadow_samples": self._shadow_samples,
                "promotions": self._promotions,
            }
        return {"router": router, "fleet": self.sup.stats(),
                "workers": worker_stats}

    def _fetch_workers(self, path: str) -> Dict[str, Any]:
        """Fetch ``path`` from every non-retired worker CONCURRENTLY:
        sequential fetches would stall a /stats or /metrics scrape by
        aggregate_timeout_s per hung worker — blinding the operator
        exactly when the fleet is degraded."""
        infos = [info for info in self.sup.worker_infos()
                 if info["state"] != "retired"]
        results = fan_out(
            {info["worker_id"]: (
                lambda i=info: self._fetch_worker(i, path))
             for info in infos},
            join_timeout_s=self.cfg.aggregate_timeout_s + 1.0,
            name="fetch")
        for info in infos:
            results.setdefault(info["worker_id"],
                               {"error": "aggregation fetch timed out"})
        return results

    def _fetch_worker(self, info: Dict[str, Any], path: str):
        if info["state"] != "healthy":
            return {"error": f"worker is {info['state']}"}
        try:
            _, payload = request_json(
                self.sup.host, info["port"], "GET", path,
                timeout_s=self.cfg.aggregate_timeout_s)
            return payload
        except Exception as exc:  # noqa: BLE001 - aggregation best-effort
            return {"error": str(exc)}

    def metrics_text(self) -> str:
        """The router's registry plus every healthy worker's exposition
        with ``worker=`` labels injected into the ``di_*`` families —
        merged per family so the combined scrape stays valid."""
        return expfmt.merge(expfmt.render(), [
            (worker_id, text)
            for worker_id, text in self._fetch_workers("/metrics").items()
            if isinstance(text, str)])

    def final_contract(self) -> Dict[str, Any]:
        """The ``fleet/v1`` machine-readable record: the router's final
        stdout line (``cli/serve.py``) and the base of every
        ``/admin/rollover`` response."""
        sup = self.sup.stats()
        states = sup["states"]
        active = sum(n for state, n in states.items() if state != "retired")
        versions = len({
            str((w.get("health") or {}).get("weights_signature"))
            for w in sup["workers"].values()
            if w["state"] == "healthy"})
        with self._lock:
            routed, failovers, rollovers = (
                self._routed, self._failovers, self._rollovers)
        return {
            "schema": "fleet/v1",
            "metric": "fleet_unplanned_worker_restarts",
            "value": float(sup["restarts_total"]),
            "unit": "restarts",
            # Cumulative trips, not just currently-open: the shutdown
            # drain retires open-circuit workers right before the final
            # line prints, and a degraded run must not exit "ok".
            "ok": (sup["circuit_open"] == 0
                   and sup["circuit_tripped_total"] == 0),
            "circuit_tripped": sup["circuit_tripped_total"],
            "workers": active,
            "healthy": states.get("healthy", 0),
            "restarts": sup["restarts_total"],
            "circuit_open": sup["circuit_open"],
            "rollovers": rollovers,
            "failovers": failovers,
            "routed": routed,
            "preemptions": sup["preemptions"],
            "versions": versions,
            "mesh_shape": self.cfg.required_mesh_shape or "1x1",
            "state_path": sup["state_path"],
        }


# ---------------------------------------------------------------------------
# Shadow-output comparison
# ---------------------------------------------------------------------------


def _flatten(value: Any) -> Optional[List[float]]:
    """Nested number lists -> flat float list; None when the structure
    holds anything that is not a number or a list."""
    if isinstance(value, bool):
        return None
    if isinstance(value, (int, float)):
        return [float(value)]
    if isinstance(value, list):
        out: List[float] = []
        for item in value:
            flat = _flatten(item)
            if flat is None:
                return None
            out.extend(flat)
        return out
    return None


def _prediction_agreement(primary: bytes, shadow: bytes,
                          tolerance: float,
                          ) -> Tuple[bool, Optional[float]]:
    """Compare two /predict response bodies on ``contact_probs``:
    (agreed, max abs elementwise diff). Structural mismatch (missing
    key, different shape, non-JSON) is a DISAGREEMENT with diff None —
    a candidate that changes the response shape must not promote."""
    try:
        a = json.loads(primary.decode())
        b = json.loads(shadow.decode())
    except (ValueError, UnicodeDecodeError):
        return False, None
    if not isinstance(a, dict) or not isinstance(b, dict):
        return False, None
    flat_a = _flatten(a.get("contact_probs"))
    flat_b = _flatten(b.get("contact_probs"))
    if flat_a is None or flat_b is None or len(flat_a) != len(flat_b):
        return False, None
    diff = max((abs(x - y) for x, y in zip(flat_a, flat_b)),
               default=0.0)
    return diff <= tolerance, diff
