"""The port's serving stack end to end on the CPU: an input-independent
engine against the JAX one, the HTTP server (``/predict`` with npz and JSON
bodies, ``/healthz``, ``/stats``, ``/metrics``, deadlines, shedding, the
SIGTERM-style drain last in the file) and ``cli.serve``.

One JAX engine and one port engine for the module, with
``input_indep=True`` (the JAX engine's weights carried into the port). The
server listens on port 0. Waits are event-driven or polls: no fixed sleep
exceeds the engine's ``max_delay_ms``."""

import http.client
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from deepinteract_tpu.serving import EngineConfig as JaxEngineConfig
from deepinteract_tpu.serving import InferenceEngine as JaxInferenceEngine
from deepinteract_tpu_torch.data.io import save_complex_npz
from deepinteract_tpu_torch.data.synthetic import random_raw_complex
from deepinteract_tpu_torch.obs import spans as port_spans
from deepinteract_tpu_torch.robustness.preemption import PreemptionGuard
from deepinteract_tpu_torch.serving import (EngineConfig, InferenceEngine, SchedulerClosed,
                                            ServingServer, ShedderConfig)
from test_obs import parse_prometheus_text
from torch_port_helpers import jax_cfg, port_cfg, wait_until

REPO = Path(__file__).resolve().parents[1]
KNN = 6
MAX_DELAY_MS = 25.0
SMALL_FLAGS = ["--num_gnn_hidden_channels", "16", "--num_gnn_attention_heads", "2",
               "--num_interact_layers", "2", "--num_interact_hidden_channels", "16",
               "--node_count_limit", "64"]


def fresh_raw(seed, n1=20, n2=16):
    return random_raw_complex(n1, n2, np.random.default_rng(seed), knn=KNN)


def npz_body(raw) -> bytes:
    buf = io.BytesIO()
    save_complex_npz(buf, raw["graph1"], raw["graph2"], raw["examples"], "c")
    return buf.getvalue()


def request(host, port, method, path, body=None, headers=None, timeout=120):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        payload = data.decode() if path == "/metrics" else json.loads(data)
        return resp.status, payload, resp
    finally:
        conn.close()


def post_npz(host, port, raw, path="/predict", headers=None):
    status, out, _ = request(host, port, "POST", path, npz_body(raw),
                             {"Content-Type": "application/octet-stream", **(headers or {})})
    return status, out


@pytest.fixture(scope="module")
def engines():
    jeng = JaxInferenceEngine(jax_cfg(), cfg=JaxEngineConfig(
        max_batch=4, max_delay_ms=MAX_DELAY_MS, input_indep=True))
    peng = InferenceEngine(
        port_cfg(), cfg=EngineConfig(max_batch=4, max_delay_ms=MAX_DELAY_MS,
                                     input_indep=True),
        device="cpu", weights={"params": jeng.params, "batch_stats": jeng.batch_stats})
    yield jeng, peng
    jeng.close()


@pytest.fixture(scope="module")
def server(engines):
    srv = ServingServer(engines[1], port=0, shedder_cfg=ShedderConfig(min_degraded_s=0.05))
    guard = PreemptionGuard(log=lambda s: None)  # flag-only off the main thread
    rc = {}
    thread = threading.Thread(target=lambda: rc.setdefault("rc", srv.run(guard=guard)),
                              daemon=True)
    thread.start()
    wait_until(lambda: srv._serve_thread is not None)
    yield srv, guard, thread, rc
    guard.request("fixture teardown")  # idempotent with the drain test
    thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.mark.parametrize("seed,n1,n2", [(1, 20, 16), (2, 30, 25)])
def test_input_indep_requests_match_the_jax_engine(engines, seed, n1, n2):
    jeng, peng = engines
    raw = fresh_raw(seed, n1, n2)
    ref, got = jeng.predict(raw), peng.predict(raw)
    np.testing.assert_allclose(got["probs"], ref["probs"], rtol=0, atol=1e-4)
    # The features are zeroed, so only the topology and the padding speak.
    other = fresh_raw(seed + 100, n1, n2)
    other["graph1"]["nbr_idx"] = raw["graph1"]["nbr_idx"]
    other["graph2"]["nbr_idx"] = raw["graph2"]["nbr_idx"]
    for g in ("graph1", "graph2"):
        for key in ("src_nbr_eids", "dst_nbr_eids"):
            other[g][key] = raw[g][key]
    np.testing.assert_allclose(peng.predict(other)["probs"], got["probs"], rtol=0, atol=1e-6)


def test_http_predict_npz_and_json_round_trip(server, tmp_path):
    srv, _, _, _ = server
    host, port = srv.address
    raw = fresh_raw(400)
    status, out = post_npz(host, port, raw)
    assert status == 200
    assert (out["n1"], out["n2"], out["bucket"]) == (20, 16, [64, 64])
    assert len(out["trace_id"]) == 16 and "trace" not in out
    probs = np.asarray(out["contact_probs"])
    direct = srv.engine.predict(raw)
    assert direct["cached"]
    np.testing.assert_allclose(probs, direct["probs"], rtol=1e-6)
    path = tmp_path / "c.npz"
    path.write_bytes(npz_body(fresh_raw(401)))
    status, out, _ = request(host, port, "POST", "/predict",
                             json.dumps({"npz_path": str(path)}).encode(),
                             {"Content-Type": "application/json"})
    assert status == 200 and out["n1"] == 20
    for body, ctype in ((b"not an npz", "application/octet-stream"),
                        (b'{"left_pdb": "x"}', "application/json")):
        status, out, _ = request(host, port, "POST", "/predict", body, {"Content-Type": ctype})
        assert status == 400 and out["error"]
    status, _, _ = request(host, port, "GET", "/nowhere")
    assert status == 404


def test_healthz_reports_weights_signature_and_warm_buckets(server):
    srv, _, _, _ = server
    host, port = srv.address
    srv.engine.predict(fresh_raw(410))
    status, health, _ = request(host, port, "GET", "/healthz")
    assert status == 200 and health["status"] == "ok" and not health["degraded"]
    assert health["weights_signature"] == srv.engine.weights_signature()
    assert health["mesh_shape"] == "1x1"
    assert health["warm_buckets"] == sorted(srv.engine.stats()["compiled_buckets"])
    assert any(label.startswith("64x64/b1/") for label in health["warm_buckets"])


def test_metrics_parse_and_agree_with_stats(server):
    srv, _, _, _ = server
    host, port = srv.address
    post_npz(host, port, fresh_raw(450))
    status, text, resp = request(host, port, "GET", "/metrics")
    assert status == 200 and resp.headers["Content-Type"].startswith("text/plain")
    samples = parse_prometheus_text(text)
    status, stats, _ = request(host, port, "GET", "/stats")
    assert status == 200
    eng = stats["engine"]
    assert samples[("di_serving_request_latency_seconds_count", frozenset())] == (
        stats["latency"]["count"])
    assert samples[("di_serving_requests_total", frozenset(
        [("endpoint", "/predict"), ("status", "200")]))] == stats["latency"]["count"]
    assert samples[("di_serving_compiled_executables", frozenset())] == (
        eng["num_compiled_executables"])
    assert samples[("di_serving_result_cache_hit_rate", frozenset())] == pytest.approx(
        eng["result_cache"]["hit_rate"])
    assert samples[("di_serving_executed_requests_total", frozenset())] >= (
        eng["executed_requests"]) >= 1
    assert samples[("di_serving_compiles_total", frozenset())] >= eng["capture_count"] >= 1
    for family in ("queue_wait", "batch_assembly", "compile", "device", "total"):
        assert (f"di_request_{family}_seconds_count", frozenset([("route", "/predict")])) \
            in samples
    assert stats["latency"]["count"] >= 1 and stats["latency"]["p50_ms"] > 0


def test_trace_id_propagates_to_response_and_events(server, tmp_path):
    srv, _, _, _ = server
    host, port = srv.address
    sink = str(tmp_path / "events.jsonl")
    port_spans.configure(sink)
    try:
        raw = fresh_raw(470)
        status, out = post_npz(host, port, raw, path="/predict?trace=1")
    finally:
        port_spans.close()
    assert status == 200
    trace = out["trace"]
    assert out["trace_id"] == trace["trace_id"] and trace["route"] == "/predict"
    parts = sum(trace[f"{p}_ms"] for p in ("queue_wait", "batch_assembly", "compile",
                                           "device"))
    assert 0 < parts <= trace["total_ms"] * 1.05 and trace["device_ms"] > 0
    events = {e["name"]: e for e in port_spans.read_events(sink)
              if e.get("trace_id") == out["trace_id"]}
    assert set(events) == {"request", "request_queue_wait", "request_batch_assembly",
                           "request_compile", "request_device"}
    for phase in ("queue_wait", "batch_assembly", "compile", "device"):
        assert events[f"request_{phase}"]["dur_s"] * 1e3 == pytest.approx(
            trace[f"{phase}_ms"], abs=0.01)
    status, again = post_npz(host, port, raw)
    assert status == 200 and again["cached"] and again["trace_id"] != out["trace_id"]


def test_http_deadline_header_maps_to_504(server):
    srv, _, _, _ = server
    host, port = srv.address
    executed = srv.engine.stats()["executed_requests"]
    raw = fresh_raw(800)
    status, out = post_npz(host, port, raw, headers={"X-Request-Deadline-Ms": "0.0001"})
    assert status == 504 and "deadline" in out["error"].lower()
    assert len(out["trace_id"]) == 16
    assert srv.engine.stats()["executed_requests"] == executed
    status, _ = post_npz(host, port, raw, headers={"X-Request-Deadline-Ms": "-5"})
    assert status == 400
    status, out = post_npz(host, port, raw, path="/predict?trace=1",
                           headers={"X-Request-Deadline-Ms": "60000"})
    assert status == 200 and out["trace"]["deadline_ms"] == pytest.approx(60_000.0)


def test_http_shedder_degrades_and_recovers(server):
    srv, _, _, _ = server
    host, port = srv.address
    hot = {"utilization": 1.0, "queue_depth": 99.0, "p99_ms": 1e4, "compile_inflight": 1.0}
    real = srv.shedder._signals_fn
    srv.shedder._signals_fn = lambda: dict(hot)
    try:
        status, health, _ = request(host, port, "GET", "/healthz")
        assert health["status"] == "overloaded" and health["degraded"]
        status, out, resp = request(host, port, "POST", "/predict", b"{}",
                                    {"Content-Type": "application/json"})
        assert status == 429 and int(resp.getheader("Retry-After")) >= 1
        assert out["retry_after_s"] > 0
        status, stats, _ = request(host, port, "GET", "/stats")
        assert status == 200 and stats["shedding"]["degraded"] is True
        samples = parse_prometheus_text(srv.metrics_text())
        assert samples[("di_shed_degraded", frozenset())] == 1.0
    finally:
        srv.shedder._signals_fn = real
    wait_until(lambda: not srv.shedder.evaluate(), timeout=5.0)
    status, health, _ = request(host, port, "GET", "/healthz")
    assert health["status"] == "ok"
    assert post_npz(host, port, fresh_raw(820))[0] == 200
    assert srv.shedder.stats()["transitions"] >= 2


def _serve_cmd(*extra):
    return [sys.executable, "-m", "deepinteract_tpu_torch.cli.serve", "--port", "0",
            "--max_delay_ms", "5", *SMALL_FLAGS, *extra]


def _serve_env():
    """One intra-op thread (as the in-process tests pin it), no fault plan."""
    env = {k: v for k, v in os.environ.items() if k != "DI_FAULTS"}
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_cli_serve_on_the_cpu_serves_then_drains_on_sigterm(tmp_path):
    events = tmp_path / "events.jsonl"
    heartbeat = tmp_path / "hb.json"
    proc = subprocess.Popen(_serve_cmd("--device", "cpu", "--warmup_buckets", "64x64x1",
                                       "--events_out", str(events),
                                       "--heartbeat_file", str(heartbeat)),
                            cwd=REPO, env=_serve_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        match = re.match(r"serving on http://([\d.]+):(\d+) \(buckets warm: 1\)", line)
        assert match, (line, proc.stderr.read() if proc.poll() is not None else "")
        host, port = match.group(1), int(match.group(2))
        # kNN 20, as the warm-up's synthetic complex: the warm key serves it.
        raw = random_raw_complex(30, 24, np.random.default_rng(900))
        status, out = post_npz(host, port, raw, path="/predict?trace=1")
        assert status == 200 and out["n1"] == 30
        status, stats, _ = request(host, port, "GET", "/stats")
        assert stats["engine"]["capture_count"] == 1
        assert stats["engine"]["compile_inventory"]["64x64/b1/k20g2"]["replays"] == 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()
    assert json.loads(heartbeat.read_text())["role"] == "engine-worker"
    names = {e["name"] for e in port_spans.read_events(str(events))}
    assert {"request", "request_device"} <= names


def test_cli_serve_without_a_gpu_refuses():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the refusal needs one without")
    proc = subprocess.run(_serve_cmd(), cwd=REPO, env=_serve_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert "serving on" not in proc.stdout


def test_cli_serve_refuses_a_config_that_does_not_capture():
    """The GCN encoder captures now (F5, closed): without a GPU ``cli.serve
    --gnn_layer_type gcn`` gets the flagship's "no CUDA device" refusal."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the refusal needs one without")
    proc = subprocess.run(_serve_cmd("--gnn_layer_type", "gcn"), cwd=REPO, env=_serve_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "no CUDA device" in proc.stderr
    assert "F5" not in proc.stderr and "serving on" not in proc.stdout


def test_parse_warmup_spec():
    from deepinteract_tpu.cli.serve import parse_warmup_spec as jax_parse
    from deepinteract_tpu_torch.cli.serve import parse_warmup_spec

    spec = "128x128x1, 256x192 ,64x256x4,"
    assert parse_warmup_spec(spec) == jax_parse(spec) == (
        (128, 128, 1), (256, 192, 1), (64, 256, 4))
    for bad in ("128", "0x64x1", "1x2x3x4"):
        with pytest.raises(ValueError):
            parse_warmup_spec(bad)


def test_serving_flags_keep_the_jax_defaults():
    import argparse

    from deepinteract_tpu.cli.args import add_serving_args as jax_add
    from deepinteract_tpu_torch.cli.args import add_serving_args

    port, ref = argparse.ArgumentParser(), argparse.ArgumentParser()
    add_serving_args(port)
    jax_add(ref)
    port_defaults = vars(port.parse_args([]))
    ref_defaults = vars(ref.parse_args([]))
    assert port_defaults == {k: ref_defaults[k] for k in port_defaults}


def test_sigterm_drain_completes_inflight_then_refuses(server):
    """Last in the file: it drains the shared server. The worker is held at
    the exec lock with a request in flight; the drain waits for it, a POST
    meanwhile answers 503, and the held request completes."""
    srv, guard, thread, rc = server
    host, port = srv.address
    srv.engine._exec_lock.acquire()
    try:
        fut = srv.engine.submit(fresh_raw(500))
        wait_until(lambda: srv.engine.scheduler.stats()["queue_depth"] == 0)
        guard.request("test SIGTERM")
        wait_until(lambda: srv._draining.is_set())
        status, out = post_npz(host, port, fresh_raw(501))
        assert status == 503 and "draining" in out["error"]
    finally:
        srv.engine._exec_lock.release()
    assert fut.result(timeout=60)["probs"].shape == (20, 16)
    thread.join(timeout=60)
    assert not thread.is_alive() and rc.get("rc") == 0
    with pytest.raises(SchedulerClosed):
        srv.engine.submit(fresh_raw(502))
    with pytest.raises(OSError):
        request(host, port, "GET", "/healthz", timeout=2)
