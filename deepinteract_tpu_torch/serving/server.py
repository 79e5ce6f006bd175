"""Stdlib HTTP JSON API over the :class:`InferenceEngine`.

Port of ``deepinteract_tpu/serving/server.py``. No web framework — ``http.server.ThreadingHTTPServer``
is enough for a JSON control plane whose heavy lifting (batching, graph
reuse) lives in the engine: handler threads parse the upload with numpy,
enqueue, and block on the future while the scheduler thread owns the card.

Endpoints:

* ``POST /predict`` — body is either a complex ``.npz`` upload
  (``data/io.py`` schema, ``Content-Type: application/octet-stream``) or
  a JSON object ``{"npz_path": ...}`` or ``{"left_pdb": ..., "right_pdb":
  ...}`` (paths the server reads; the pair is featurized on the server by
  :mod:`deepinteract_tpu_torch.pipeline`). Response: ``{"complex_name",
  "trace_id", "n1", "n2", "bucket", "cached", "coalesced", "latency_ms",
  "contact_probs": [[...]]}``; ``?trace=1`` adds the request's latency
  decomposition (queue-wait / batch-assembly / compile / device,
  :mod:`deepinteract_tpu_torch.obs.reqtrace`), the same numbers recorded
  as ``di_request_*`` histograms and, with a span sink configured, as
  ``request_*`` events under that ``trace_id``.
* ``POST /screen`` — small SYNCHRONOUS bulk screen: JSON ``{"npz_paths":
  [...complex npz...], "top_k": 10, "include_self": false, "max_pairs":
  0, "query": ["name:g1", ...]}``. The listed complexes are split into
  chains and every pair is scored through the split phase (N encodes +
  N^2 micro-batched decodes over the server's shared embedding cache,
  ``deepinteract_tpu_torch.screening``); the ranked records come back in
  the response. Screens above ``screen_max_pairs`` are refused with 400
  (``cli/screen.py``, with its manifest and resume, is the tool for
  those). ``{"indexed": true}`` with ``--index_path``, or a payload
  ``index_path``, makes it a ranked-partner query against a proteome
  index (``deepinteract_tpu_torch.index``): exempt from
  ``screen_max_pairs``, and an expired deadline flushes the partners
  ranked so far with ``partial: true``.
* ``POST /assembly`` — synchronous k-chain assembly
  (``deepinteract_tpu_torch.assembly``): C(k, 2) pairs count against
  ``screen_max_pairs``.
* ``GET /healthz`` — status (``ok`` / ``overloaded`` / ``draining``), the
  served weights' identity, the warm graph inventory and the in-flight
  count (what the fleet router and autoscaler read).
* ``GET /stats`` — queue depth, per-bucket graph inventory, result-cache
  hit rate, request-latency percentiles, the shedder's state and a
  ``screening`` block (``/screen`` request counts, the shared embedding
  cache's hit rate).

The split-phase routes run their runners on the handler thread under
one screen lock, never through the micro-batch scheduler: the runners
replay the engine's encode and decode graphs under its exec lock (each
output copied to the host under it), so a ``/predict`` group that
flushes meanwhile waits for the lock instead of interleaving replays
that share the graph pool. A calibration (``calibration_path``) is
verified against the served weights at startup and annotates the ranked
records of ``/screen`` and ``/assembly`` (raw scores kept beside).
* ``GET /metrics`` — the process-wide registry in Prometheus text format.
  ``/stats`` percentiles come from the same registry histogram.

Overload discipline (``serving/admission.py``): a full queue answers
**429 + ``Retry-After``**; an expired deadline (``X-Request-Deadline-Ms``
header, ``deadline_s`` JSON field, or ``--default_deadline_ms``) answers
**504**; under sustained pressure the :class:`LoadShedder` answers POSTs
with 429 before any parse work while ``/stats`` and ``/metrics`` stay
live.

Shutdown: ``run()`` installs a :class:`PreemptionGuard`; on SIGTERM/SIGINT
the server stops accepting (``503`` on new predicts), drains in-flight
requests through the scheduler, answers them, and returns 0.
"""

from __future__ import annotations

import io
import json
import logging
import math
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs

import numpy as np

from deepinteract_tpu_torch.assembly import AssemblyConfig, AssemblyRunner
from deepinteract_tpu_torch.calibration.calibrator import annotate_records, load_calibration
from deepinteract_tpu_torch.data.io import GRAPH_KEYS, load_complex_npz
from deepinteract_tpu_torch.index import ChainIndex, IndexedQueryRunner, QueryConfig
from deepinteract_tpu_torch.obs import expfmt
from deepinteract_tpu_torch.obs import metrics as obs_metrics
from deepinteract_tpu_torch.obs.reqtrace import RequestTrace
from deepinteract_tpu_torch.robustness import artifacts
from deepinteract_tpu_torch.robustness.preemption import PreemptionGuard
from deepinteract_tpu_torch.screening import (ChainLibrary, EmbeddingCache, ScreenConfig,
                                              ScreenRunner, enumerate_pairs)
from deepinteract_tpu_torch.serving.admission import (
    Deadline,
    DeadlineExceeded,
    LoadShedder,
    Overloaded,
    ShedderConfig,
    ShuttingDown,
)
from deepinteract_tpu_torch.serving.engine import InferenceEngine
from deepinteract_tpu_torch.serving.scheduler import SchedulerClosed

logger = logging.getLogger(__name__)

# Every answered request, labeled by route and HTTP status. The 200-count
# on /predict equals the latency histogram's count (both recorded on the
# same success path).
_REQUESTS = obs_metrics.counter(
    "di_serving_requests_total", "HTTP requests answered",
    labelnames=("endpoint", "status"))
_ROUTES = ("/predict", "/screen", "/assembly", "/healthz", "/stats", "/metrics")


def raw_from_npz_bytes(body: bytes) -> Dict:
    """An uploaded ``.npz`` complex (the ``save_complex_npz`` schema) ->
    raw dict, without touching the filesystem."""
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        missing = [k for p in ("g1", "g2")
                   for k in (f"{p}_{key}" for key in GRAPH_KEYS)
                   if k not in z] + [k for k in ("examples",) if k not in z]
        if missing:
            raise ValueError(f"npz upload missing keys: {missing}")
    return load_complex_npz(io.BytesIO(body))


def raw_from_json(payload: Dict) -> Dict:
    """JSON request body -> raw complex dict: a complex ``npz_path``, or a
    PDB pair featurized here on the host (without labels)."""
    if "npz_path" in payload:
        return load_complex_npz(payload["npz_path"])
    if "left_pdb" in payload and "right_pdb" in payload:
        from deepinteract_tpu_torch.pipeline.pair import convert_pdb_pair_to_complex

        return convert_pdb_pair_to_complex(
            payload["left_pdb"], payload["right_pdb"], with_labels=False)
    raise ValueError(
        "JSON body must contain 'npz_path' or both 'left_pdb' and "
        "'right_pdb' (or upload npz bytes as application/octet-stream)")


class _QuietThreadingHTTPServer(ThreadingHTTPServer):
    """Route stdlib's handler-thread tracebacks (routine client
    disconnects, keep-alive sockets torn down by a drain) to debug
    logging; real request failures are answered as 4xx/5xx JSON."""

    def handle_error(self, request, client_address):  # noqa: N802
        logger.debug("connection error from %s", client_address,
                     exc_info=True)


class _LatencyTracker:
    """Request-latency percentiles for /stats, backed by the registry
    histogram ``/metrics`` exposes (so the two cannot disagree)."""

    def __init__(self):
        self._hist = obs_metrics.histogram(
            "di_serving_request_latency_seconds",
            "End-to-end /predict latency (parse to response)")

    def record(self, seconds: float) -> None:
        self._hist.observe(seconds)

    def stats(self) -> Dict[str, Any]:
        count = self._hist.count()
        if count == 0:
            return {"count": 0}
        return {
            "count": count,
            "p50_ms": self._hist.percentile(50) * 1e3,
            "p90_ms": self._hist.percentile(90) * 1e3,
            "p99_ms": self._hist.percentile(99) * 1e3,
            "max_ms": self._hist.max_value() * 1e3,
        }


class ServingServer:
    """Engine + ThreadingHTTPServer + cooperative drain."""

    def __init__(self, engine: InferenceEngine, host: str = "127.0.0.1",
                 port: int = 8008, request_timeout_s: float = 120.0,
                 screen_max_pairs: int = 512,
                 default_deadline_ms: float = 0.0,
                 shedder_cfg: Optional[ShedderConfig] = None,
                 index_path: Optional[str] = None,
                 calibration_path: Optional[str] = None):
        self.engine = engine
        self.latency = _LatencyTracker()
        self._draining = threading.Event()
        self.request_timeout_s = request_timeout_s
        self.screen_max_pairs = int(screen_max_pairs)
        # Requests without their own deadline get this budget; <= 0 means
        # no deadline (request_timeout_s is then the only bound).
        self.default_deadline_ms = float(default_deadline_ms)
        # Degraded-mode switch over the signals /metrics serves, evaluated
        # per POST and per /healthz — no background thread.
        self.shedder = LoadShedder(shedder_cfg or ShedderConfig(),
                                   self._shed_signals)
        # Screens share one embedding cache across requests (a library
        # chain re-screened later skips its encode) and serialize on one
        # lock: each screen is many replays, and two interleaved screens
        # would only thrash the card.
        self._screen_cache: Optional[EmbeddingCache] = None
        self._screen_lock = threading.Lock()
        # Opened proteome indexes are cached per path (shards verify once,
        # stay resident). A --index_path preload happens HERE, so a worker
        # with a bad or stale index fails at startup, not on its first query.
        self.index_path = index_path
        self._indices: Dict[str, Any] = {}
        self._index_lock = threading.Lock()
        if index_path:
            self._get_index(index_path)
        # Verified at startup against the served weights: a worker with a
        # stale or corrupt map fails HERE, not by rescaling its first
        # response.
        self.calibration_path = calibration_path
        self.calibrator = None
        if calibration_path:
            self.calibrator = load_calibration(
                calibration_path, expect_signature=engine.weights_signature())
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # noqa: N802 - stdlib name
                logger.debug("http: " + fmt, *args)

            def _route(self) -> str:
                """Path sans query string."""
                return self.path.partition("?")[0]

            def _trace_requested(self) -> bool:
                query = self.path.partition("?")[2]
                return parse_qs(query).get("trace", ["0"])[-1] in (
                    "1", "true", "yes")

            def _request_deadline(self, payload: Optional[Dict] = None):
                """The ``X-Request-Deadline-Ms`` header wins, then a JSON
                body's ``deadline_s``, then the server-wide default; None =
                no deadline. Raises ValueError on a non-positive or
                non-numeric budget."""
                hdr = self.headers.get("X-Request-Deadline-Ms")
                if hdr is not None:
                    ms = float(hdr)
                    if not ms > 0:
                        raise ValueError(
                            f"X-Request-Deadline-Ms must be > 0, got {hdr!r}")
                    return Deadline.after(ms / 1e3)
                if payload is not None and "deadline_s" in payload:
                    sec = float(payload["deadline_s"])
                    if not sec > 0:
                        raise ValueError(f"deadline_s must be > 0, got {sec!r}")
                    return Deadline.after(sec)
                if server.default_deadline_ms > 0:
                    return Deadline.after(server.default_deadline_ms / 1e3)
                return None

            def _send_overloaded(self, retry_after_s: float, error: str) -> None:
                """429 + Retry-After: the retry contract for admission
                rejections and shedder-degraded mode."""
                retry = max(1, int(math.ceil(retry_after_s)))
                self._send_json(
                    429,
                    {"error": error, "retry_after_s": round(float(retry_after_s), 3)},
                    extra_headers={"Retry-After": str(retry)})

            def _send_body(self, code: int, body: bytes, content_type: str,
                           extra_headers: Optional[Dict] = None) -> None:
                # Counted BEFORE the body write, so a client that
                # disconnects mid-response still counts. The label is the
                # matched route ("other" for 404s): client paths must not
                # mint unbounded label values.
                route = self._route()
                _REQUESTS.inc(endpoint=route if route in _ROUTES else "other",
                              status=str(code))
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for name, value in (extra_headers or {}).items():
                    self.send_header(name, value)
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, payload: Dict,
                           extra_headers: Optional[Dict] = None) -> None:
                self._send_body(code, json.dumps(payload).encode(),
                                "application/json", extra_headers=extra_headers)

            def do_GET(self):  # noqa: N802 - stdlib name
                route = self._route()
                if route == "/healthz":
                    # Degraded is a liveness-page state, not an error: the
                    # process is healthy and REFUSING work on purpose.
                    degraded = server.shedder.evaluate()
                    draining = server._draining.is_set()
                    status = ("draining" if draining
                              else "overloaded" if degraded else "ok")
                    self._send_json(200, {
                        "status": status,
                        "draining": draining,
                        "degraded": degraded,
                        "weights_signature": server.engine.weights_signature(),
                        "mesh_shape": "1x1",
                        "warm_buckets": server.engine.warm_bucket_labels(),
                        # The autoscaler's queue-depth signal, cached by the
                        # fleet supervisor's probe of this route.
                        "inflight": server.engine.admission.stats()["inflight"],
                    })
                elif route == "/stats":
                    self._send_json(200, server.stats())
                elif route == "/metrics":
                    self._send_body(200, server.metrics_text().encode(),
                                    expfmt.CONTENT_TYPE)
                else:
                    self._send_json(404, {"error": f"no route {self.path}"})

            def do_POST(self):  # noqa: N802 - stdlib name
                route = self._route()
                if route not in ("/predict", "/screen", "/assembly"):
                    self._send_json(404, {"error": f"no route {self.path}"})
                    return
                if server._draining.is_set():
                    self._send_json(503, {"error": "server is draining"})
                    return
                if server.shedder.evaluate():
                    # Degraded: drain the body (keep-alive framing must stay
                    # intact) but skip ALL parse work.
                    self.rfile.read(int(self.headers.get("Content-Length", 0)))
                    server.shedder.count_rejection()
                    self._send_overloaded(
                        server.engine.admission.retry_after_s(),
                        "server overloaded (load shedding active); "
                        "retry after the indicated delay")
                    return
                if route != "/predict":
                    self._do_split_phase(route)
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length)
                    ctype = self.headers.get("Content-Type", "")
                    if ctype.startswith("application/json"):
                        payload = json.loads(body.decode())
                        deadline = self._request_deadline(payload)
                        raw = raw_from_json(payload)
                    else:
                        deadline = self._request_deadline()
                        raw = raw_from_npz_bytes(body)
                except Exception as exc:  # noqa: BLE001 - client error
                    self._send_json(400, {"error": str(exc)})
                    return
                # Minted AFTER parse: the trace covers the request's trip
                # through the scheduler and engine; upload decode time is
                # in latency_ms.
                reqtrace = RequestTrace("/predict")
                t0 = time.monotonic()
                try:
                    result = server.engine.predict(
                        raw, timeout=server.request_timeout_s,
                        reqtrace=reqtrace, deadline=deadline)
                except Overloaded as exc:
                    self._send_overloaded(exc.retry_after_s, str(exc))
                    return
                except DeadlineExceeded as exc:
                    response = {"error": str(exc), "trace_id": reqtrace.trace_id}
                    if self._trace_requested() and exc.trace is not None:
                        response["trace"] = exc.trace
                    self._send_json(504, response)
                    return
                except (SchedulerClosed, ShuttingDown):
                    self._send_json(503, {"error": "server is draining"})
                    return
                except Exception as exc:  # noqa: BLE001 - surfaced to client
                    logger.exception("predict failed")
                    self._send_json(500, {"error": str(exc)})
                    return
                latency = time.monotonic() - t0
                server.latency.record(latency)
                response = {
                    "complex_name": raw.get("complex_name", ""),
                    "trace_id": reqtrace.trace_id,
                    "n1": result["n1"],
                    "n2": result["n2"],
                    "bucket": list(result["bucket"]),
                    "cached": result["cached"],
                    "coalesced": result.get("coalesced", 1),
                    "latency_ms": latency * 1e3,
                    "contact_probs": np.asarray(
                        result["probs"], dtype=np.float64).tolist(),
                }
                if self._trace_requested() and "trace" in result:
                    response["trace"] = result["trace"]
                self._send_json(200, response)

            def _do_split_phase(self, route: str) -> None:
                """``POST /screen`` and ``POST /assembly``: a JSON body, the
                runner on this thread, 400 for client mistakes, 504 for an
                expired deadline (checked at batch boundaries)."""
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length).decode())
                    if not isinstance(payload, dict):
                        raise ValueError(f"{route[1:]} body must be a JSON object")
                    deadline = self._request_deadline(payload)
                except Exception as exc:  # noqa: BLE001 - client error
                    self._send_json(400, {"error": str(exc)})
                    return
                reqtrace = RequestTrace(route)
                run = server.run_screen if route == "/screen" else server.run_assembly
                t0 = time.monotonic()
                try:
                    out = run(payload, trace_id=reqtrace.trace_id, deadline=deadline)
                except DeadlineExceeded as exc:
                    self._send_json(504, {"error": str(exc), "trace_id": reqtrace.trace_id})
                    return
                except (ValueError, KeyError, OSError) as exc:
                    self._send_json(400, {"error": str(exc)})
                    return
                except Exception as exc:  # noqa: BLE001 - surfaced to client
                    logger.exception("%s failed", route[1:])
                    self._send_json(500, {"error": str(exc)})
                    return
                out["latency_ms"] = (time.monotonic() - t0) * 1e3
                out["trace_id"] = reqtrace.trace_id
                # The device phases are the encode and decode walls (the
                # replays go straight to the card, no queue).
                encode_s = out.get("encode_seconds", 0.0)
                decode_s = out.get("decode_seconds", 0.0)
                reqtrace.set_phase("device", encode_s + decode_s)
                trace = reqtrace.finish(encode=encode_s, decode=decode_s)
                if self._trace_requested():
                    out["trace"] = trace
                self._send_json(200, out)

        self.httpd = _QuietThreadingHTTPServer((host, port), Handler)
        self._serve_thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        host, port = self.httpd.server_address[:2]
        return str(host), int(port)

    def serve_background(self) -> None:
        """Start accepting connections on a daemon thread (used by run()
        and by tests; the production entry is run())."""
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, name="http-serve", daemon=True)
        self._serve_thread.start()

    def drain(self) -> None:
        """Stop accepting new predicts, finish in-flight ones, stop the
        listener. Idempotent."""
        if self._draining.is_set():
            return
        self._draining.set()
        # Flush everything still queued; handler threads blocked on their
        # futures get their responses before the listener goes away.
        self.engine.close()
        self.httpd.shutdown()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10.0)
        self.httpd.server_close()

    def run(self, guard: Optional[PreemptionGuard] = None,
            poll_seconds: float = 0.25) -> int:
        """Blocking serve loop: SIGTERM/SIGINT -> drain in-flight requests
        -> return 0. ``guard`` is injectable for tests (flag-only outside
        the main thread)."""
        own_guard = guard is None
        guard = guard or PreemptionGuard(log=logger.warning)
        if own_guard:
            guard.__enter__()
        try:
            self.serve_background()
            host, port = self.address
            logger.info("serving on http://%s:%d (POST /predict, POST /screen, "
                        "POST /assembly, GET /healthz, GET /stats, GET /metrics)",
                        host, port)
            while not guard.requested:
                time.sleep(poll_seconds)
            logger.warning("drain requested (%s): refusing new requests, "
                           "flushing %d queued", guard.reason,
                           self.engine.scheduler.stats()["queue_depth"])
        finally:
            self.drain()
            if own_guard:
                guard.__exit__(None, None, None)
        return 0

    # -- split phase -------------------------------------------------------

    def _shared_cache(self) -> EmbeddingCache:
        """The embedding cache every route shares; caller holds the screen
        lock."""
        if self._screen_cache is None:
            self._screen_cache = EmbeddingCache()
        return self._screen_cache

    def _annotate(self, out: Dict) -> Dict:
        if self.calibrator is not None:
            annotate_records(out["ranked"], self.calibrator)
            out["calibration"] = self.calibration_path
        return out

    def run_screen(self, payload: Dict, trace_id: str = "",
                   deadline: Optional[Deadline] = None) -> Dict:
        """Synchronous small screen for ``POST /screen`` (module docstring).
        Raises ValueError/KeyError/OSError for client mistakes (400);
        ``deadline`` is enforced at encode and decode batch boundaries
        (DeadlineExceeded, 504). ``trace_id`` labels the screen's
        ``screen_encode``/``screen_decode`` span events."""
        if payload.get("index_path") or (self.index_path and payload.get("indexed")):
            return self._run_indexed_screen(payload, deadline=deadline)
        npz_paths = payload.get("npz_paths")
        if not npz_paths or not isinstance(npz_paths, list):
            raise ValueError("screen body needs 'npz_paths': a non-empty "
                             "list of complex .npz paths")
        library = ChainLibrary.from_complex_files([str(p) for p in npz_paths])
        pairs = enumerate_pairs(
            library, queries=payload.get("query"),
            include_self=bool(payload.get("include_self", False)),
            max_pairs=int(payload.get("max_pairs", 0)))
        if len(pairs) > self.screen_max_pairs:
            raise ValueError(
                f"screen of {len(pairs)} pairs exceeds the synchronous limit "
                f"({self.screen_max_pairs}); run cli/screen.py for large "
                "libraries (manifest + preemption resume)")
        batch = self.engine.cfg.max_batch
        with self._screen_lock:
            runner = ScreenRunner(self.engine, cache=self._shared_cache(), cfg=ScreenConfig(
                top_k=int(payload.get("top_k", 10)), decode_batch=batch, encode_batch=batch))
            result = runner.screen(library, pairs, trace_id=trace_id, deadline=deadline)
        return self._annotate({"chains": result.chains, "pairs": result.pairs_total,
                               "ranked": result.records, **result.summary()})

    def run_assembly(self, payload: Dict, trace_id: str = "",
                     deadline: Optional[Deadline] = None) -> Dict:
        """Synchronous k-chain assembly for ``POST /assembly``: C(k, 2)
        pairs count against ``screen_max_pairs``, the shared embedding
        cache and screen lock serialize the card's work, and the deadline
        is enforced at batch boundaries. Errors as :meth:`run_screen`."""
        npz_paths = payload.get("npz_paths")
        if not npz_paths or not isinstance(npz_paths, list):
            raise ValueError("assembly body needs 'npz_paths': a "
                             "non-empty list of complex .npz paths")
        library = ChainLibrary.from_complex_files([str(p) for p in npz_paths])
        chain_ids = payload.get("chains")
        if chain_ids is not None and not isinstance(chain_ids, list):
            raise ValueError("'chains' must be a list of chain ids")
        k = len(chain_ids) if chain_ids else len(library.ids())
        pairs = k * (k - 1) // 2
        if pairs > self.screen_max_pairs:
            raise ValueError(
                f"assembly of {k} chains is {pairs} pairs, over the synchronous "
                f"limit ({self.screen_max_pairs}); run cli/assemble.py for "
                "large assemblies")
        keep_maps = bool(payload.get("maps", False))
        batch = self.engine.cfg.max_batch
        with self._screen_lock:
            runner = AssemblyRunner(
                self.engine, cache=self._shared_cache(),
                cfg=AssemblyConfig(
                    top_k=int(payload.get("top_k", 10)), decode_batch=batch,
                    encode_batch=batch,
                    edge_threshold=float(payload.get("edge_threshold", 0.5)),
                    control=bool(payload.get("control", True)), keep_maps=keep_maps),
                calibrator=self.calibrator)
            result = runner.assemble(library, chain_ids=chain_ids, trace_id=trace_id,
                                     deadline=deadline)
        out = {"ranked": result.records, "interface": result.interface,
               "weights_signature": self.engine.weights_signature(),
               "calibration": self.calibration_path, **result.summary()}
        if keep_maps:
            out["maps"] = {pid: np.asarray(m, dtype=np.float64).tolist()
                           for pid, m in result.maps.items()}
        return out

    def _get_index(self, path: str) -> ChainIndex:
        """Open-or-cached index handle; manifest problems surface as
        ValueError (400), never as a silently empty index."""
        key = os.path.abspath(str(path))
        with self._index_lock:
            hit = self._indices.get(key)
            if hit is not None:
                return hit
        try:
            index = ChainIndex.open(key)
        except artifacts.ArtifactError as exc:
            raise ValueError(f"index at {path}: {exc}") from exc
        with self._index_lock:
            return self._indices.setdefault(key, index)

    def _run_indexed_screen(self, payload: Dict,
                            deadline: Optional[Deadline] = None) -> Dict:
        """Ranked-partner query against a prebuilt proteome index. Exempt
        from ``screen_max_pairs``: the pre-filter bounds the decodes to the
        top-M survivors whatever the library's size, and the decode loop
        streams micro-batches under the deadline; expiry mid-decode
        flushes the partners ranked so far with ``partial: true`` instead
        of a 504 (a prefix of the ranking is still useful)."""
        index = self._get_index(payload.get("index_path") or self.index_path)
        query = payload.get("query")
        if isinstance(query, list):
            if len(query) != 1:
                raise ValueError("indexed screen needs exactly one 'query' chain id")
            query = query[0]
        if not query:
            raise ValueError("indexed screen needs 'query': the chain id "
                             "to rank partners for")
        query = str(query)
        partitions = payload.get("partitions")
        if partitions is not None and not isinstance(partitions, list):
            raise ValueError("'partitions' must be a list of partition ids")
        with self._screen_lock:
            runner = IndexedQueryRunner(
                self.engine, index,
                cfg=QueryConfig(top_m=int(payload.get("top_m", 32)),
                                top_k=int(payload.get("top_k", 10)),
                                decode_batch=self.engine.cfg.max_batch),
                cache=self._shared_cache(),
                allow_stale=bool(payload.get("allow_stale", False)))
            npz_paths = payload.get("npz_paths")
            if npz_paths:
                library = ChainLibrary.from_complex_files([str(p) for p in npz_paths])
                entry = library[query]
                result = runner.query_from_raw(entry.chain_id, entry.raw,
                                               partitions=partitions, deadline=deadline,
                                               on_deadline="partial")
            else:
                result = runner.query_from_index(query, partitions=partitions,
                                                 deadline=deadline, on_deadline="partial")
        return self._annotate({
            "indexed": True,
            "index_path": index.index_dir,
            "query": result.query,
            "chains": index.num_chains,
            "partitions_served": (sorted(partitions) if partitions is not None
                                  else index.partition_ids()),
            "weights_signature": self.engine.weights_signature(),
            "ranked": result.records,
            **result.summary(),
        })

    # -- observability -----------------------------------------------------

    def _shed_signals(self) -> Dict[str, float]:
        """The load shedder's inputs, read from the sources /metrics
        serves: admission occupancy, the request-latency p99, and the
        capture-in-flight gauge."""
        adm = self.engine.admission.stats()
        return {
            "utilization": adm["inflight"] / max(1, adm["max_inflight"]),
            "queue_depth": float(adm["queued"]),
            "p99_ms": float(self.latency.stats().get("p99_ms", 0.0)),
            "compile_inflight": obs_metrics.gauge(
                "di_serving_compile_inflight").value(),
        }

    def stats(self) -> Dict[str, Any]:
        # Live in degraded mode by design: the shedder only gates POSTs.
        return {
            "engine": self.engine.stats(),
            "latency": self.latency.stats(),
            "screening": self.screening_stats(),
            "shedding": self.shedder.stats(),
            "draining": self._draining.is_set(),
        }

    def screening_stats(self) -> Dict[str, Any]:
        """The ``/screen`` route's answered and refused counts (from the
        registry counter ``/metrics`` serves) and the shared embedding
        cache's occupancy and hit rate. Takes NO screen lock: a screen
        holds it throughout, and /stats must not block behind the card's
        work. The attribute read is atomic and ``EmbeddingCache.stats``
        takes the cache's own short lock."""
        cache = self._screen_cache
        cache_stats = cache.stats() if cache is not None else {}
        return {
            "requests": _REQUESTS.value(endpoint="/screen", status="200"),
            "requests_rejected": _REQUESTS.value(endpoint="/screen", status="400"),
            "emb_cache_entries": int(cache_stats.get("size", 0)),
            "emb_cache_hit_rate": float(cache_stats.get("hit_rate", 0.0)),
        }

    def metrics_text(self) -> str:
        """Prometheus text for ``GET /metrics``: point-in-time gauges are
        refreshed from the engine at scrape time, then the whole process
        registry is rendered."""
        eng = self.engine.stats()
        g = obs_metrics.gauge
        g("di_serving_queue_depth",
          "Requests pending in the micro-batch scheduler").set(
            eng["scheduler"]["queue_depth"])
        g("di_serving_compiled_executables",
          "Entries in the shape-bucketed graph cache").set(
            eng["num_compiled_executables"])
        g("di_serving_result_cache_size",
          "Entries in the LRU result cache").set(eng["result_cache"]["size"])
        g("di_serving_result_cache_hit_rate",
          "Result-cache hit rate since startup").set(
            eng["result_cache"]["hit_rate"])
        g("di_serving_uptime_seconds", "Engine uptime").set(eng["uptime_seconds"])
        g("di_serving_draining", "1 while the server refuses new work").set(
            float(self._draining.is_set()))
        # di_shed_degraded must show the CURRENT mode at scrape time.
        self.shedder.evaluate()
        adm = eng["admission"]
        g("di_serving_inflight", "Admitted requests not yet answered").set(
            adm["inflight"])
        g("di_serving_retry_after_seconds",
          "Current backlog-drain estimate handed to rejected clients").set(
            adm["retry_after_s"])
        screening = self.screening_stats()
        g("di_serving_screen_emb_cache_entries",
          "Embeddings resident in the shared /screen cache").set(
            screening["emb_cache_entries"])
        g("di_serving_screen_emb_cache_hit_rate",
          "Shared /screen embedding-cache hit rate since startup").set(
            screening["emb_cache_hit_rate"])
        return expfmt.render()
