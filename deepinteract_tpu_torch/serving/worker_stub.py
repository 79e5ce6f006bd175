"""Null-engine fleet worker: the serving wire contract without a model.

Port of ``deepinteract_tpu/serving/worker_stub.py``. The fleet layer
(``serving/fleet.py`` + ``serving/router.py``) is deliberately
model-agnostic — it supervises *processes* that speak the worker
protocol: ``GET /healthz`` (with ``weights_signature`` +
``warm_buckets``), ``GET /stats``, ``GET /metrics``, ``POST /predict``,
a periodic ``obs/heartbeat.py`` liveness file, and SIGTERM
drain-then-exit-0. This module is that protocol with the engine swapped
for a configurable ``time.sleep`` — a worker that starts in a fraction
of a second instead of paying torch import, weight load and CUDA graph
captures, so the fleet tests can kill -9 / flap / roll over a real
multi-process fleet in the fast tier, and an operator can rehearse a
rollover (``cli.serve --workers N --fleet_stub_workers``).

Production workers are ``cli/serve.py`` processes (the supervisor builds
their command line); this stub is the rehearsal double. Everything is
stdlib + the obs/robustness layers — no torch import.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Dict, List, Optional

from deepinteract_tpu_torch.obs import expfmt
from deepinteract_tpu_torch.obs import metrics as obs_metrics
from deepinteract_tpu_torch.obs.heartbeat import Heartbeat

logger = logging.getLogger(__name__)

# The same request-count series the real server records, so the router's
# per-worker relabeled aggregation has the familiar families to carry.
_REQUESTS = obs_metrics.counter(
    "di_serving_requests_total", "HTTP requests answered",
    labelnames=("endpoint", "status"))


class StubWorker:
    """One fake engine worker. ``warm_after_s`` simulates the capture warmup
    window (healthz reports ``status: "warming"`` and an empty
    ``warm_buckets`` until it passes); ``delay_ms`` is the simulated
    device latency per predict; ``crash_after_s`` hard-exits the process
    (os._exit(3)) for supervisor-restart chaos."""

    def __init__(self, worker_id: str, weights_signature: str,
                 warm_buckets: List[str], delay_ms: float,
                 warm_after_s: float, host: str = "127.0.0.1",
                 port: int = 0, probs_value: float = 0.5,
                 mesh_shape: str = "1x1"):
        self.worker_id = worker_id
        self.weights_signature = weights_signature
        # Advertised topology label ("DxP"): a stub never owns devices,
        # but the router's topology-aware placement and rollover warm
        # proofs key on /healthz mesh_shape — this makes them
        # stub-fleet-testable without a device.
        self.mesh_shape = str(mesh_shape or "1x1")
        self.configured_buckets = list(warm_buckets)
        self.delay_s = max(0.0, float(delay_ms)) / 1e3
        # The single fake prediction value: two stubs with different
        # probs_value disagree deterministically — the shadow-traffic
        # agreement ledger's test knob.
        self.probs_value = float(probs_value)
        self._warm_at = time.monotonic() + max(0.0, float(warm_after_s))
        self._started = time.time()
        self._draining = threading.Event()
        self._inflight = 0
        self._served = 0
        self._lock = threading.Lock()
        worker = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # noqa: N802 - stdlib name
                logger.debug("stub http: " + fmt, *args)

            def _send_json(self, code: int, payload: Dict) -> None:
                from deepinteract_tpu_torch.serving.fleet import endpoint_label

                body = json.dumps(payload).encode()
                _REQUESTS.inc(endpoint=endpoint_label(
                    self.path, ("/predict", "/screen", "/assembly",
                                "/healthz", "/stats", "/metrics")),
                    status=str(code))
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 - stdlib name
                route = self.path.partition("?")[0]
                if route == "/healthz":
                    self._send_json(200, worker.healthz())
                elif route == "/stats":
                    self._send_json(200, worker.stats())
                elif route == "/metrics":
                    body = expfmt.render().encode()
                    _REQUESTS.inc(endpoint="/metrics", status="200")
                    self.send_response(200)
                    self.send_header("Content-Type", expfmt.CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._send_json(404, {"error": f"no route {route}"})

            def do_POST(self):  # noqa: N802 - stdlib name
                route = self.path.partition("?")[0]
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                if route not in ("/predict", "/screen", "/assembly"):
                    self._send_json(404, {"error": f"no route {route}"})
                    return
                # Claim the in-flight slot BEFORE the draining check:
                # checked-then-claimed would let drain() observe
                # inflight == 0 in the gap and tear this response.
                with worker._lock:
                    worker._inflight += 1
                if worker._draining.is_set():
                    # The 503 write ALSO stays inside the in-flight
                    # window (same invariant as the 200 path below):
                    # drain() must not shut the listener down while
                    # this response is mid-write.
                    try:
                        self._send_json(503,
                                        {"error": "server is draining"})
                    finally:
                        with worker._lock:
                            worker._inflight -= 1
                    return
                try:
                    # The RESPONSE WRITE stays inside the in-flight
                    # window: drain() waits for inflight == 0 before
                    # stopping the listener, and a request only stops
                    # being in flight once its bytes are on the wire —
                    # otherwise a drain racing the send tears the
                    # connection and the clean-drain contract breaks.
                    time.sleep(worker.delay_s)
                    if route == "/screen" and b'"index_path"' in body:
                        code, out = worker.indexed_screen(body)
                        self._send_json(code, out)
                        return
                    if route == "/assembly":
                        code, out = worker.assembly(body)
                        self._send_json(code, out)
                        return
                    self._send_json(200, {
                        "complex_name": "stub",
                        "n1": 1, "n2": 1, "bucket": [64, 64],
                        "cached": False, "coalesced": 1,
                        "latency_ms": worker.delay_s * 1e3,
                        "contact_probs": [[worker.probs_value]],
                        "worker_id": worker.worker_id,
                        "weights_signature": worker.weights_signature,
                    })
                finally:
                    with worker._lock:
                        worker._inflight -= 1
                        worker._served += 1

        from deepinteract_tpu_torch.serving.fleet import QuietHTTPServer

        self.httpd = QuietHTTPServer((host, port), Handler)

    # -- protocol ----------------------------------------------------------

    @property
    def warm(self) -> bool:
        return time.monotonic() >= self._warm_at

    def indexed_screen(self, body: bytes):
        """Deterministic fake of the real server's indexed ``/screen``
        (ranked partners from a proteome index): reads ONLY the index
        manifest's partition table — no numpy, no shard bytes — and
        scores each chain as ``crc32(chain_id) % 10^4 / 10^4``. Two
        stubs given the same partitions answer identically, so the
        router's scatter/gather merge and SIGKILL failover are testable
        against real fleet processes in the fast tier."""
        import zlib

        try:
            payload = json.loads(body.decode())
            manifest_file = os.path.join(
                str(payload["index_path"]), "index_manifest.json")
            with open(manifest_file) as fh:
                manifest = json.load(fh)
        except (KeyError, ValueError, OSError) as exc:
            return 400, {"error": f"stub indexed screen: {exc}"}
        wanted = payload.get("partitions")
        query = str(payload.get("query", "stub-query"))
        ranked = []
        served = []
        for part in manifest.get("partitions", []):
            pid = part.get("partition_id")
            if wanted is not None and pid not in wanted:
                continue
            served.append(pid)
            for cid in part.get("chains", []):
                if cid == query:
                    continue
                score = (zlib.crc32(str(cid).encode()) % 10_000) / 10_000
                ranked.append({
                    "pair_id": f"{query}|{cid}",
                    "chain1": query, "chain2": cid,
                    "query": query, "partner": cid,
                    "score": score, "max_prob": score,
                    "prefilter_score": score,
                    "partition_id": pid, "top_k": 0,
                    "top_contacts": [],
                })
        ranked.sort(key=lambda r: (-r["score"], r["pair_id"]))
        top_m = int(payload.get("top_m", 0))
        survivors = ranked[:top_m] if top_m > 0 else ranked
        return 200, {
            "indexed": True,
            "query": query,
            "partitions_served": sorted(served),
            "candidates": len(ranked),
            "survivors": len(survivors),
            "pairs_decoded": len(survivors),
            "partial": False,
            "ranked": survivors,
            "worker_id": self.worker_id,
            "weights_signature": self.weights_signature,
        }

    def assembly(self, body: bytes):
        """Deterministic fake of the real server's ``POST /assembly``
        (k-chain complex scoring): takes the request's ``chains`` list
        verbatim (no file IO, no numpy), scores each i<j pair as
        ``crc32(pair_id) % 10^4 / 10^4``, and answers with the real
        route's shape — ranked records, interface graph, encode-once
        accounting (unique_encodes == k) — so the router's proxying of
        /assembly is testable against real fleet processes in the fast
        tier. Two stubs answer identically for the same chains."""
        import zlib

        try:
            payload = json.loads(body.decode())
        except ValueError as exc:
            return 400, {"error": f"stub assembly: {exc}"}
        ids = payload.get("chains") or ["stubA", "stubB"]
        if not isinstance(ids, list) or len(ids) < 2:
            return 400, {"error": "stub assembly: 'chains' must list "
                                  ">= 2 chain ids"}
        ids = [str(c) for c in ids]
        threshold = float(payload.get("edge_threshold", 0.5))
        ranked, edges = [], []
        for i in range(len(ids)):
            for j in range(i + 1, len(ids)):
                c1, c2 = sorted((ids[i], ids[j]))
                pid = f"{c1}|{c2}"
                score = (zlib.crc32(pid.encode()) % 10_000) / 10_000
                ranked.append({"pair_id": pid, "chain1": c1, "chain2": c2,
                               "score": score, "max_prob": score,
                               "top_k": 0, "top_contacts": []})
                if score >= threshold:
                    edges.append({"chain1": c1, "chain2": c2,
                                  "pair_id": pid, "score": score})
        ranked.sort(key=lambda r: (-r["score"], r["pair_id"]))
        return 200, {
            "ranked": ranked,
            "interface": {"nodes": ids, "edges": edges},
            "chains": len(ids),
            "pairs_total": len(ranked),
            "pairs_scored": len(ranked),
            "unique_encodes": len(ids),
            "encode_cache_hits": 0,
            "decode_batches": 1,
            "interface_edges": len(edges),
            "interactability": (sum(r["score"] for r in ranked)
                                / max(1, len(ranked))),
            "control_score": None,
            "calibrated": False,
            "calibration": None,
            "worker_id": self.worker_id,
            "weights_signature": self.weights_signature,
        }

    def healthz(self) -> Dict:
        warm = self.warm
        with self._lock:
            inflight = self._inflight
        return {
            "status": ("draining" if self._draining.is_set()
                       else "ok" if warm else "warming"),
            "draining": self._draining.is_set(),
            "degraded": False,
            "weights_signature": self.weights_signature,
            "mesh_shape": self.mesh_shape,
            "warm_buckets": list(self.configured_buckets) if warm else [],
            "worker_id": self.worker_id,
            # Queue-depth signal: the supervisor's probes cache this in
            # the worker snapshot, where the autoscaler reads it.
            "inflight": inflight,
        }

    def stats(self) -> Dict:
        with self._lock:
            inflight, served = self._inflight, self._served
        return {
            "worker_id": self.worker_id,
            "uptime_seconds": time.time() - self._started,
            "inflight": inflight,
            "served": served,
            "stub": True,
        }

    def drain(self) -> None:
        """SIGTERM path: refuse new predicts, let in-flight handler
        threads finish their sleep+response, stop the listener."""
        if self._draining.is_set():
            return
        self._draining.set()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            with self._lock:
                if self._inflight == 0:
                    break
            time.sleep(0.02)
        self.httpd.shutdown()


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--worker_id", default="stub")
    parser.add_argument("--weights_signature", default="stub-v1")
    parser.add_argument("--warm_buckets", default="64x64/b1",
                        help="comma list of graph-inventory labels "
                             "healthz reports once warm")
    parser.add_argument("--delay_ms", type=float, default=10.0)
    parser.add_argument("--mesh_shape", default="1x1",
                        help="advertised mesh topology label 'DxP' "
                             "(fake: rehearses topology-aware routing)")
    parser.add_argument("--probs_value", type=float, default=0.5,
                        help="the stub's constant contact probability — "
                             "distinct values make two versions disagree "
                             "deterministically (shadow-traffic tests)")
    parser.add_argument("--warm_after_s", type=float, default=0.0)
    parser.add_argument("--crash_after_s", type=float, default=0.0,
                        help="> 0: hard-exit (os._exit 3) after this many "
                             "seconds — the supervisor-restart chaos knob")
    parser.add_argument("--heartbeat_file", default="")
    parser.add_argument("--heartbeat_interval_s", type=float, default=0.5)
    parser.add_argument("--parent_pid", type=int, default=0,
                        help="drain and exit when this stops being our "
                             "parent (orphaned-worker protection; 0 "
                             "disables)")
    args = parser.parse_args(argv)

    worker = StubWorker(
        args.worker_id, args.weights_signature,
        [b for b in args.warm_buckets.split(",") if b.strip()],
        args.delay_ms, args.warm_after_s, host=args.host, port=args.port,
        probs_value=args.probs_value, mesh_shape=args.mesh_shape)
    hb = None
    if args.heartbeat_file:
        hb = Heartbeat(args.heartbeat_file,
                       interval_s=args.heartbeat_interval_s)
        hb.progress(worker_id=args.worker_id, role="stub-worker",
                    port=worker.httpd.server_address[1],
                    weights_signature=args.weights_signature)
        hb.start()

    signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
        target=worker.drain, daemon=True).start())
    from deepinteract_tpu_torch.serving.fleet import watch_parent

    watch_parent(args.parent_pid, worker.drain, interval_s=0.5)
    if args.crash_after_s > 0:
        def _crash():
            time.sleep(args.crash_after_s)
            os._exit(3)

        threading.Thread(target=_crash, daemon=True).start()

    logger.info("stub worker %s on %s:%d", args.worker_id,
                *worker.httpd.server_address[:2])
    try:
        worker.httpd.serve_forever(poll_interval=0.05)
    finally:
        worker.httpd.server_close()
        if hb is not None:
            hb.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
