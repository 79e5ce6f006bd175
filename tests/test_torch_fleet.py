"""The port's fleet layer (``deepinteract_tpu_torch.serving.{fleet,router,
worker_stub}``, ``obs/expfmt.py`` and ``cli/serve.py``'s fleet modes),
mirroring tests/test_fleet.py (its fsck test waits for the port's fsck),
plus what only a port has to show: the pure routing policies against the
JAX package's, each package's router serving the other's stub workers, and
a real ``--device cpu`` engine worker behind the port's router within 1e-4
of the JAX engine.

Most workers are ``serving/worker_stub.py`` null engines (no torch import,
sub-second start), so a REAL multi-process fleet — spawn, SIGKILL,
restart with backoff, circuit breaker, rollover under concurrent load —
fits the fast tier. Every wait polls with a bound, every child is waited
with a timeout, and ports come from the OS."""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from deepinteract_tpu_torch.obs import expfmt
from deepinteract_tpu_torch.obs import metrics as obs_metrics
from deepinteract_tpu_torch.obs.heartbeat import Heartbeat, read_heartbeat
from deepinteract_tpu_torch.robustness import artifacts, faults
from deepinteract_tpu_torch.serving.fleet import (FleetConfig, WorkerSupervisor,
                                                  stub_worker_cmd)
from deepinteract_tpu_torch.serving.router import FleetRouter, RolloverFailed, RouterConfig
from torch_port_helpers import (http_get, http_post, make_fleet, make_supervisor,
                                wait_routable)

REPO = Path(__file__).resolve().parents[1]
post, get = http_post, http_get


# ---------------------------------------------------------------------------
# read_heartbeat (the shared liveness check)
# ---------------------------------------------------------------------------


def test_read_heartbeat_fresh_stale_missing(tmp_path):
    path = str(tmp_path / "heartbeat_w1.json")
    missing = read_heartbeat(path, 5.0)
    assert missing.status == "missing" and not missing.fresh
    assert missing.age_s is None and missing.payload is None

    hb = Heartbeat(path, interval_s=60.0)
    hb.progress(step=7)
    hb.write_now()
    fresh = read_heartbeat(path, 5.0)
    assert fresh.status == "fresh" and fresh.fresh and fresh.age_s < 5.0
    assert fresh.payload["step"] == 7
    # Staleness is judged on the payload's own written_ts.
    payload = dict(fresh.payload, written_ts=time.time() - 100.0)
    artifacts.atomic_write(path, json.dumps(payload), fsync=False)
    stale = read_heartbeat(path, 5.0)
    assert stale.status == "stale" and 95.0 < stale.age_s < 110.0
    assert read_heartbeat(path, 5.0, now=payload["written_ts"] + 1.0).fresh
    # Unparseable bytes are STALE however fresh the mtime.
    bad = str(tmp_path / "heartbeat_torn.json")
    with open(bad, "w") as fh:
        fh.write("{not json")
    torn = read_heartbeat(bad, 5.0)
    assert torn.status == "stale" and torn.payload is None


def test_the_control_plane_imports_no_torch():
    """The supervisor, router, autoscaler and stub worker start without
    torch (and so without CUDA): every restart in a chaos run pays their
    import again."""
    code = ("import sys\n"
            "import deepinteract_tpu_torch.serving.worker_stub, "
            "deepinteract_tpu_torch.serving.router, deepinteract_tpu_torch.serving.autoscaler, "
            "deepinteract_tpu_torch.obs.expfmt\n"
            "from deepinteract_tpu_torch.serving import FleetRouter, WorkerSupervisor\n"
            "print(sorted(m for m in ('torch', 'numpy', 'jax') if m in sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# command factories and the pure policies, against the JAX package's
# ---------------------------------------------------------------------------


def test_stub_worker_cmd_maps_overrides():
    cmd = stub_worker_cmd("w9", 1234, "/tmp/hb.json", {"ckpt_name": "ckpts/run2", "delay_ms": 7})
    assert cmd[:3] == [sys.executable, "-m", "deepinteract_tpu_torch.serving.worker_stub"]
    assert cmd[cmd.index("--weights_signature") + 1] == "ckpts/run2"
    assert cmd[cmd.index("--delay_ms") + 1] == "7"
    assert cmd[cmd.index("--port") + 1] == "1234"


def _last(cmd, flag):
    return cmd[len(cmd) - 1 - cmd[::-1].index(flag) + 1]


def test_engine_worker_cmd_overrides_win_last():
    from deepinteract_tpu_torch.cli.serve import engine_worker_cmd_fn

    fn = engine_worker_cmd_fn(["--ckpt_name", "old", "--workers", "3", "--port", "8008",
                               "--device", "cpu", "--index_path", "idx"])
    cmd = fn("w1", 4242, "/tmp/hb.json", {"ckpt_name": "new"})
    assert cmd[:3] == [sys.executable, "-m", "deepinteract_tpu_torch.cli.serve"]
    assert _last(cmd, "--workers") == "0" and _last(cmd, "--port") == "4242"
    assert _last(cmd, "--ckpt_name") == "new"
    assert cmd[cmd.index("--heartbeat_file") + 1] == "/tmp/hb.json"
    # --device and --index_path reach every worker through the base argv.
    assert _last(cmd, "--device") == "cpu" and _last(cmd, "--index_path") == "idx"
    # A weights rollover drops the base's --ckpt_name (the two are exclusive).
    cmd = fn("w2", 1, "/tmp/hb.json", {"weights": "w2.npz"})
    assert "--ckpt_name" not in cmd and _last(cmd, "--weights") == "w2.npz"
    cmd = engine_worker_cmd_fn(["--weights=w1.npz"])("w3", 1, "", {"ckpt_name": "c"})
    assert not any(a.startswith("--weights") for a in cmd)


def test_worker_cmds_carry_parent_pid():
    from deepinteract_tpu_torch.cli.serve import engine_worker_cmd_fn

    stub = stub_worker_cmd("w1", 1, "/tmp/hb.json", {})
    assert stub[stub.index("--parent_pid") + 1] == str(os.getpid())
    eng = engine_worker_cmd_fn([])("w1", 1, "/tmp/hb.json", {})
    assert eng[eng.index("--parent_pid") + 1] == str(os.getpid())


@pytest.mark.parametrize("spec,kw", [
    ("128x128x1,128x128x8,64x64", {}),
    ("100x100x6", {"max_batch": 4}),
    ("", {}),
    ("128x128x1,600x40x2", {"pad_to_max_bucket": True}),
    ("70x200x3", {"diagonal_buckets": True}),
    ("128x128x1,512x512x2", {"mesh_shape": (4, 1)}),
    ("128x128x3,512x600x1", {"mesh_shape": (2, 4), "pair_shard_threshold": 512}),
])
def test_warm_bucket_prefixes_match_the_jax_package(spec, kw):
    from deepinteract_tpu.cli.serve import warm_bucket_prefixes as jax_prefixes
    from deepinteract_tpu_torch.cli.serve import warm_bucket_prefixes

    assert warm_bucket_prefixes(spec, **kw) == jax_prefixes(spec, **kw)
    if spec.startswith("128x128x1,128x128x8"):
        assert warm_bucket_prefixes(spec) == ("128x128/b1/", "128x128/b8/", "64x64/b1/")


def test_mesh_policies_and_batch_slots_match_the_jax_package():
    from deepinteract_tpu.serving import fleet as jax_fleet
    from deepinteract_tpu_torch.serving import engine, fleet

    shapes = [None, "", "1x1", (1, 1), "4x1", "1x4", "2x4", [8, 2]]
    for shape in shapes:
        assert fleet.parse_mesh_shape(shape) == jax_fleet.parse_mesh_shape(shape)
        assert fleet.mesh_label(shape) == jax_fleet.mesh_label(shape)
        assert fleet.mesh_label_prefix(shape) == jax_fleet.mesh_label_prefix(shape)
        for b1, b2 in ((64, 64), (128, 512), (512, 256), (768, 768)):
            for thr in (0, 256, 512, 1024):
                assert (fleet.mesh_placement(shape, b1, b2, thr)
                        == jax_fleet.mesh_placement(shape, b1, b2, thr))
    for bad in ("4", "ax1", "0x2", (1, 2, 3)):
        with pytest.raises(ValueError):
            fleet.parse_mesh_shape(bad)
        with pytest.raises(ValueError):
            jax_fleet.parse_mesh_shape(bad)
    for n in range(0, 20):
        for mb in (1, 2, 3, 8, 16):
            for lift in (1, 2, 3, 4):
                assert fleet.batch_slots(n, mb, lift) == jax_fleet.batch_slots(n, mb, lift)
        # The engine pads coalesced groups with the fleet's one policy.
        assert engine.batch_slots is fleet.batch_slots


class _FakeSupervisor:
    """The supervisor surface routing and autoscaling POLICY reads: fixed
    routable workers with their health payloads, no processes."""

    def __init__(self, sigs, hosts_pair_axis=(), num_workers=2):
        self._infos = [{"worker_id": f"w{i + 1}", "state": "healthy", "port": 0,
                        "health": {"weights_signature": sig,
                                   "mesh_shape": "1x4" if i in hosts_pair_axis else "1x1"}}
                       for i, sig in enumerate(sigs)]
        self.on_replacement = None
        self.state_path = "/nonexistent/fleet_state.json"
        self.cfg = types.SimpleNamespace(num_workers=num_workers, probe_interval_s=0.1)
        self.extras = {}

    def routable_workers(self):
        return [dict(w) for w in self._infos]

    worker_infos = routable_workers

    def set_extra_state(self, key, value):
        self.extras[key] = dict(value)

    def recovered_state(self):
        return {}


def _routers(sigs, cfg_kw=None, **fake_kw):
    """One FleetRouter per package over the same fake supervisor state."""
    from deepinteract_tpu.serving.router import FleetRouter as JaxFleetRouter
    from deepinteract_tpu.serving.router import RouterConfig as JaxRouterConfig

    out = []
    for cls, cfg_cls in ((FleetRouter, RouterConfig), (JaxFleetRouter, JaxRouterConfig)):
        router = cls(_FakeSupervisor(sigs, **fake_kw), port=0, cfg=cfg_cls(**(cfg_kw or {})))
        router.httpd.server_close()
        router._active = [f"w{i + 1}" for i in range(len(sigs))]
        out.append(router)
    return out


def test_bucket_affinity_and_canary_sequence_match_the_jax_router():
    port, ref = _routers(["v1", "v1", "v2", "v1", "v2"])
    hints = [None, "128x128", "64x256", "256x192", "768x512", "x", "512x512"]
    for hint in hints * 3:
        assert port._pick_sequence(hint) == ref._pick_sequence(hint), hint
    for router in (port, ref):
        router.set_versions({"weights": {"v1": 3, "v2": 1}})
    sig = {w["worker_id"]: w["health"]["weights_signature"]
           for w in port.sup.routable_workers()}
    seq = [[sig[router._pick_sequence(None)[0]] for _ in range(100)] for router in (port, ref)]
    assert seq[0] == seq[1] and seq[0].count("v1") == 75
    for pin in ("v2", "v1", "v9"):
        assert port._pick_sequence("128x128", pin) == ref._pick_sequence("128x128", pin)
    # Topology-aware: a p512+ hint prefers pair-axis workers in both.
    port, ref = _routers(["v1"] * 4, cfg_kw={"pair_bucket_threshold": 512},
                         hosts_pair_axis=(2,))
    for hint in ("512x128", "128x128", "768x768", None):
        assert port._pick_sequence(hint) == ref._pick_sequence(hint)
    assert port._pick_sequence("768x768")[0] == "w3"


@pytest.mark.parametrize("breach_polls,cooldown_s", [(2, 0.0), (1, 0.0), (3, 3600.0)])
def test_autoscaler_decisions_match_the_jax_autoscaler(monkeypatch, breach_polls, cooldown_s):
    from deepinteract_tpu.serving.autoscaler import Autoscaler as JaxAutoscaler
    from deepinteract_tpu.serving.autoscaler import AutoscalerConfig as JaxAutoscalerConfig
    from deepinteract_tpu_torch.serving.autoscaler import Autoscaler, AutoscalerConfig

    base = {"workers": 2.0, "mean_inflight": 0.0, "degraded_workers": 0.0, "p99_ms": 0.0,
            "shed_degraded": 0.0, "pressure_delta": 0.0}
    script = ([{"mean_inflight": 5.0}] * 3 + [{"mean_inflight": 1.0}]
              + [{"mean_inflight": 3.0, "workers": 3.0}] * 4 + [{"degraded_workers": 1.0}] * 2
              + [{"workers": 4.0}] * 3 + [{"mean_inflight": 0.1, "workers": 4.0}] * 5
              + [{"workers": 1.0}] * 2 + [{"pressure_delta": 2.0}] * 3
              + [{"p99_ms": 900.0}] * 3 + [{"workers": 6.0}] * 2)
    decisions = []
    for cls, cfg_cls in ((Autoscaler, AutoscalerConfig), (JaxAutoscaler, JaxAutoscalerConfig)):
        scaler = cls(_FakeSupervisor(["v1", "v1"]), types.SimpleNamespace(),
                     cfg=cfg_cls(min_workers=1, max_workers=5, breach_polls=breach_polls,
                                 cooldown_s=cooldown_s, p99_high_ms=500.0))
        steps = iter(script)
        monkeypatch.setattr(scaler, "signals", lambda: {**base, **next(steps)})
        monkeypatch.setattr(scaler, "_scale_up", lambda target: None)
        monkeypatch.setattr(scaler, "_scale_down", lambda target: None)
        decisions.append([(scaler.poll_once(), scaler.stats()["target_workers"])
                          for _ in script])
    assert decisions[0] == decisions[1]
    assert any(d for d, _ in decisions[0])


# ---------------------------------------------------------------------------
# supervisor mechanics
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_orphaned_worker_exits_when_parent_dies():
    """A worker drains ITSELF when its parent pid is gone: spawned with a
    parent_pid that is not its parent, the watcher fires at once."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepinteract_tpu_torch.serving.worker_stub",
         "--port", "0", "--parent_pid", "1"],
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    try:
        assert proc.wait(timeout=20.0) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10.0)


@pytest.mark.chaos
def test_supervisor_restarts_sigkilled_worker_with_backoff(tmp_path):
    sup = make_supervisor(tmp_path, n=1)
    restarts_counter = obs_metrics.counter("di_fleet_worker_restarts_total",
                                           labelnames=("worker",))
    try:
        sup.start()
        wait_routable(sup, 1)
        (info,) = sup.worker_infos()
        wid, old_pid = info["worker_id"], info["pid"]
        before = restarts_counter.value(worker=wid)
        os.kill(old_pid, signal.SIGKILL)
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            sup.poll_once()
            info = sup.worker_info(wid)
            if info["state"] == "healthy" and info["restarts"] >= 1:
                break
            time.sleep(0.05)
        info = sup.worker_info(wid)
        assert info["state"] == "healthy" and info["restarts"] == 1
        assert info["pid"] != old_pid
        assert restarts_counter.value(worker=wid) == before + 1
        with sup._lock:
            assert sup._workers[wid].backoff_attempt == 0
    finally:
        sup.stop(timeout_s=5.0)


def _late_binding_stub_cmd(worker_id, port, heartbeat_path, overrides):
    """The stub worker, started 1.5 s late: an engine worker binds its
    port only after its warm-up."""
    from deepinteract_tpu_torch.serving.fleet import stub_worker_cmd

    cmd = stub_worker_cmd(worker_id, port, heartbeat_path, overrides)
    assert cmd[1:3] == ["-m", "deepinteract_tpu_torch.serving.worker_stub"]
    return [cmd[0], "-c", "import runpy, time; time.sleep(1.5); runpy.run_module("
            "'deepinteract_tpu_torch.serving.worker_stub', run_name='__main__')", *cmd[3:]]


def test_a_starting_workers_port_is_held_until_the_worker_binds(tmp_path):
    """F12: a fleet record counted 2 unplanned restarts on the card, one of
    them a rollover worker that died with EADDRINUSE. Its port came from a
    bind-0 probe whose socket closed at once, and the worker binds only
    after its warm-up, so a client connection took the port as its
    ephemeral one. The supervisor now holds each worker's port
    (``reserve_port``) while the worker starts: a plain bind of it fails
    (as a connection's would), the worker binds it and comes up without a
    restart, and the hold ends when the worker is retired."""
    import socket

    sup = make_supervisor(tmp_path, n=1, cmd_fn=_late_binding_stub_cmd)
    try:
        sup.start()
        (info,) = sup.worker_infos()
        with socket.socket() as thief, pytest.raises(OSError):
            thief.bind(("127.0.0.1", info["port"]))
        wait_routable(sup, 1)
        info = sup.worker_info(info["worker_id"])
        assert info["state"] == "healthy" and info["restarts"] == 0
        assert http_get("127.0.0.1", info["port"], "/healthz")[0] == 200
    finally:
        sup.stop(timeout_s=5.0)
    with sup._lock:
        assert all(w.reservation is None for w in sup._workers.values())


@pytest.mark.chaos
def test_circuit_breaker_opens_on_flapping_worker(tmp_path):
    sup = make_supervisor(tmp_path, n=1, overrides={"crash_after_s": 0.05},
                          restart_backoff_s=0.02, circuit_max_restarts=2,
                          circuit_window_s=60.0)
    try:
        sup.start()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            sup.poll_once()
            (info,) = sup.worker_infos()
            if info["state"] == "circuit_open":
                break
            time.sleep(0.05)
        (info,) = sup.worker_infos()
        assert info["state"] == "circuit_open" and info["restarts"] == 2
        assert obs_metrics.gauge("di_fleet_circuit_open", labelnames=("worker",)).value(
            worker=info["worker_id"]) == 1.0
        for _ in range(5):
            sup.poll_once()
            time.sleep(0.02)
        assert sup.worker_info(info["worker_id"])["restarts"] == 2
        assert sup.stats()["circuit_open"] == 1
    finally:
        sup.stop(timeout_s=5.0)


@pytest.mark.chaos
def test_circuit_window_is_sliding_not_cumulative(tmp_path):
    import collections

    sup = make_supervisor(tmp_path, n=1, circuit_max_restarts=2, circuit_window_s=60.0)
    try:
        sup.start()
        wait_routable(sup, 1)
        (info,) = sup.worker_infos()
        wid = info["worker_id"]
        with sup._lock:
            sup._workers[wid].restart_times = collections.deque(
                [time.monotonic() - 5000.0] * 5)
        os.kill(info["pid"], signal.SIGKILL)
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            sup.poll_once()
            state = sup.worker_info(wid)["state"]
            assert state != "circuit_open", "stale window entries tripped the circuit"
            if state == "healthy" and sup.worker_info(wid)["restarts"]:
                break
            time.sleep(0.05)
        assert sup.worker_info(wid)["state"] == "healthy"
    finally:
        sup.stop(timeout_s=5.0)


@pytest.mark.chaos
def test_spawn_fault_retries_with_backoff(tmp_path):
    sup = make_supervisor(tmp_path, n=0)
    faults.configure({"fleet.spawn": [1]})
    try:
        wid = sup.spawn_worker()
        assert sup.worker_info(wid)["state"] == "restarting"
        assert obs_metrics.counter("di_fleet_spawn_failures_total",
                                   labelnames=("worker",)).value(worker=wid) >= 1
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            sup.poll_once()
            if sup.worker_info(wid)["state"] == "healthy":
                break
            time.sleep(0.05)
        assert sup.worker_info(wid)["state"] == "healthy"
    finally:
        faults.reset()
        sup.stop(timeout_s=5.0)


@pytest.mark.chaos
def test_probe_fault_marks_a_live_worker_unhealthy_then_recovers(tmp_path):
    # The monitor ticks once at start, then never again: only this test's
    # own poll_once can take the one-shot fault (wait_routable polls by
    # itself). At the default 0.15 s interval the monitor could take it,
    # and the test's probe then saw a worker already healthy again.
    sup = make_supervisor(tmp_path, n=1, probe_interval_s=3600.0)
    try:
        sup.start()
        wait_routable(sup, 1)
        (info,) = sup.worker_infos()
        faults.configure({"fleet.probe": 1})
        sup.poll_once()
        assert sup.worker_info(info["worker_id"])["state"] == "unhealthy"
        assert "injected fleet.probe" in sup.worker_info(info["worker_id"])["last_error"]
        wait_routable(sup, 1)
    finally:
        faults.reset()
        sup.stop(timeout_s=5.0)


@pytest.mark.chaos
def test_fleet_kill_fault_drain_falls_back_to_sigkill(tmp_path):
    sup = make_supervisor(tmp_path, n=1)
    try:
        sup.start()
        wait_routable(sup, 1)
        (info,) = sup.worker_infos()
        faults.configure({"fleet.kill": [1]})
        rc = sup.drain_worker(info["worker_id"], timeout_s=5.0)
        assert sup.worker_info(info["worker_id"])["state"] == "retired"
        assert rc != 0
    finally:
        faults.reset()
        sup.stop(timeout_s=5.0)


def test_state_file_persisted_atomically(tmp_path):
    sup = make_supervisor(tmp_path, n=1)
    try:
        sup.start()
        wait_routable(sup, 1)
        state = json.loads(open(sup.state_path).read())
        assert set(state["workers"]) == {w["worker_id"] for w in sup.worker_infos()}
        assert state["restarts_total"] == 0
        strays = [n for n in os.listdir(os.path.dirname(sup.state_path))
                  if n.endswith(artifacts.TMP_SUFFIX)]
        assert strays == []
    finally:
        sup.stop(timeout_s=5.0)
    state = json.loads(open(sup.state_path).read())
    assert all(w["state"] == "retired" for w in state["workers"].values())


# ---------------------------------------------------------------------------
# router: routing, failover, aggregation
# ---------------------------------------------------------------------------


def test_router_routes_and_bucket_affinity(tmp_path):
    sup, router = make_fleet(tmp_path, n=2)
    try:
        host, port = router.address
        hinted = {post(host, port, headers={"X-DI-Bucket": "128x128"})[2]["X-DI-Worker"]
                  for _ in range(4)}
        assert len(hinted) == 1
        plain = {post(host, port)[2]["X-DI-Worker"] for _ in range(4)}
        assert len(plain) == 2
        status, body = get(host, port, "/healthz")
        payload = json.loads(body)
        assert status == 200 and payload["status"] == "ok"
        assert payload["healthy"] == payload["workers"] == 2
        status, body = get(host, port, "/stats")
        stats = json.loads(body)
        assert set(stats["workers"]) == set(stats["router"]["active_workers"])
        assert all(w.get("stub") for w in stats["workers"].values())
    finally:
        router.drain()


def test_router_metrics_aggregation_per_worker_labels(tmp_path):
    sup, router = make_fleet(tmp_path, n=2)
    try:
        host, port = router.address
        post(host, port)
        status, body = get(host, port, "/metrics")
        text = body.decode()
        assert status == 200
        for wid in [w["worker_id"] for w in sup.worker_infos()]:
            assert f'di_serving_requests_total{{worker="{wid}"' in text
        helps = [ln for ln in text.splitlines()
                 if ln.startswith("# HELP di_serving_requests_total ")]
        assert len(helps) == 1
        assert "di_fleet_workers_healthy" in text
    finally:
        router.drain()


def test_router_proxies_assembly(tmp_path):
    sup, router = make_fleet(tmp_path, n=2)
    try:
        host, port = router.address
        body = json.dumps({"chains": ["a", "b", "c"], "edge_threshold": 0.0}).encode()
        status, raw, headers = post(host, port, "/assembly", body)
        assert status == 200 and "X-DI-Worker" in headers
        payload = json.loads(raw)
        assert payload["chains"] == 3 and payload["pairs_total"] == 3
        assert payload["unique_encodes"] == 3 and payload["weights_signature"] == "v1"
        assert len(payload["ranked"]) == 3 and len(payload["interface"]["edges"]) == 3
        status2, raw2, _ = post(host, port, "/assembly", body)
        assert status2 == 200 and json.loads(raw2)["ranked"] == payload["ranked"]
        status3, _, _ = post(host, port, "/assembly", json.dumps({"chains": ["solo"]}).encode())
        assert status3 == 400
    finally:
        router.drain()


def test_exposition_relabel_and_merge():
    assert expfmt.inject_label('di_x{a="b"} 1', "w1") == 'di_x{worker="w1",a="b"} 1'
    assert expfmt.inject_label("di_x 2.5", "w1") == 'di_x{worker="w1"} 2.5'
    fams = expfmt.parse_exposition(
        "# HELP di_h help text\n# TYPE di_h histogram\n"
        'di_h_bucket{le="1"} 3\ndi_h_sum 0.5\ndi_h_count 3\n', relabel="w2")
    assert set(fams) == {"di_h"} and fams["di_h"]["type"] == "histogram"
    assert fams["di_h"]["samples"][0] == 'di_h_bucket{worker="w2",le="1"} 3'
    own = "# HELP di_c c\n# TYPE di_c counter\ndi_c 1\n# TYPE go_x gauge\ngo_x 2\n"
    worker = "# HELP di_c c\n# TYPE di_c counter\ndi_c 4\n# TYPE go_x gauge\ngo_x 3\n"
    merged = expfmt.merge(own, [("w1", worker), ("w2", worker)]).splitlines()
    assert merged.count("# HELP di_c c") == 1 and merged.count("# TYPE go_x gauge") == 1
    assert 'di_c{worker="w1"} 4' in merged and 'di_c{worker="w2"} 4' in merged
    assert merged.count("go_x 3") == 2  # foreign families pass through unlabeled


@pytest.mark.chaos
def test_chaos_sigkill_worker_mid_batch_under_load(tmp_path):
    """kill -9 a worker holding in-flight requests under concurrent load:
    every request resolves 200 on the sibling, the fleet is restored to
    full size and the restart counter increments."""
    sup, router = make_fleet(tmp_path, n=2, overrides={"delay_ms": 50})
    restarts_counter = obs_metrics.counter("di_fleet_worker_restarts_total",
                                           labelnames=("worker",))
    try:
        host, port = router.address
        results, lock = [], threading.Lock()
        stop_at = time.monotonic() + 3.0

        def client():
            while time.monotonic() < stop_at:
                try:
                    status, body, _ = post(host, port, timeout=10.0)
                except Exception as exc:  # noqa: BLE001 - tallied below
                    status, body = -1, repr(exc).encode()
                with lock:
                    results.append((status, body))

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10.0
        while len(results) < 8 and time.monotonic() < deadline:
            time.sleep(0.01)  # load running; the victim has requests in flight
        victim = sup.worker_infos()[0]
        before = restarts_counter.value(worker=victim["worker_id"])
        os.kill(victim["pid"], signal.SIGKILL)
        for t in threads:
            t.join(timeout=20.0)
        assert not any(t.is_alive() for t in threads)
        assert len(results) > 20
        non_200 = [(s, b) for s, b in results if s != 200]
        assert non_200 == [], f"requests dropped during worker kill: {non_200[:5]}"
        with router._lock:
            assert router._failovers >= 1
        wait_routable(sup, 2)
        assert restarts_counter.value(worker=victim["worker_id"]) == before + 1
    finally:
        router.drain()


# ---------------------------------------------------------------------------
# rollover
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_rollover_under_load_zero_5xx_and_drain_exit_0(tmp_path):
    sup, router = make_fleet(tmp_path, n=2, overrides={"delay_ms": 20})
    try:
        host, port = router.address
        results, lock = [], threading.Lock()
        stop_at = time.monotonic() + 4.0

        def client():
            while time.monotonic() < stop_at:
                try:
                    status, body, _ = post(host, port, timeout=10.0)
                except Exception as exc:  # noqa: BLE001 - tallied below
                    status, body = -1, repr(exc).encode()
                with lock:
                    results.append((status, body))

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        old_ids = [w["worker_id"] for w in sup.worker_infos()]
        status, body, _ = post(host, port, path="/admin/rollover",
                               body=json.dumps({"weights_signature": "v2"}).encode(),
                               timeout=60.0)
        record = json.loads(body)
        for t in threads:
            t.join(timeout=20.0)
        assert not any(t.is_alive() for t in threads)
        assert status == 200 and record["ok"] is True and record["schema"] == "fleet/v1"
        roll = record["rollover"]
        assert roll["old_workers"] == old_ids
        assert set(roll["drain_exit_codes"].values()) == {0}
        assert [s for s, _ in results if s >= 500 or s < 0] == []
        assert len(results) > 20
        _, body, _ = post(host, port)
        assert json.loads(body)["weights_signature"] == "v2"
        _, body = get(host, port, "/healthz")
        assert json.loads(body)["weights_signatures"] == ["v2"]
        for wid in old_ids:
            assert sup.worker_info(wid)["state"] == "retired"
    finally:
        router.drain()


def test_rollover_aborts_when_replacement_never_warms(tmp_path):
    sup, router = make_fleet(tmp_path, n=1, router_cfg=RouterConfig(
        proxy_timeout_s=10.0, warm_timeout_s=1.0, drain_timeout_s=5.0))
    try:
        host, port = router.address
        with pytest.raises(RolloverFailed, match="not warm"):
            router.rollover({"weights_signature": "v2", "warm_after_s": 120})
        status, body, _ = post(host, port)
        assert status == 200 and json.loads(body)["weights_signature"] == "v1"
        assert [w["state"] for w in sup.worker_infos()].count("retired") == 1
        _, body = get(host, port, "/healthz")
        assert json.loads(body)["healthy"] == 1
    finally:
        router.drain()


def test_rollover_http_conflict_while_in_progress(tmp_path):
    sup, router = make_fleet(tmp_path, n=1)
    try:
        host, port = router.address
        assert router._rollover_lock.acquire(blocking=False)
        try:
            status, body, _ = post(host, port, path="/admin/rollover", body=b"{}")
            assert status == 409 and json.loads(body)["ok"] is False
        finally:
            router._rollover_lock.release()
        status, _, _ = post(host, port, path="/admin/rollover", body=b"[1, 2]")
        assert status == 400
    finally:
        router.drain()


# ---------------------------------------------------------------------------
# CLI surface
# ---------------------------------------------------------------------------


def test_serve_cli_rollover_client_mode(tmp_path, capsys):
    from deepinteract_tpu_torch.cli.serve import main
    from tools.check_cli_contract import check_cli_contract_text

    sup, router = make_fleet(tmp_path, n=1)
    try:
        host, port = router.address
        rc = main(["--rollover", "--host", host, "--port", str(port),
                   "--rollover_ckpt", "ckpts/run2"])
        record = check_cli_contract_text(capsys.readouterr().out, "fleet")
        assert rc == 0 and record["rollovers"] == 1
        assert record["rollover"]["target_weights_signature"] is None
        _, body, _ = post(host, port)
        assert json.loads(body)["weights_signature"] == "ckpts/run2"
    finally:
        router.drain()


def _serve_env():
    env = {k: v for k, v in os.environ.items() if k != "DI_FAULTS"}
    env["OMP_NUM_THREADS"] = "1"
    return env


def _router_address(proc, timeout=60.0):
    """The ``fleet router on http://HOST:PORT`` line of a fleet process."""
    line = proc.stdout.readline()
    match = re.match(r"fleet router on http://([\d.]+):(\d+)", line)
    assert match, (line, proc.stderr.read() if proc.poll() is not None else "")
    return match.group(1), int(match.group(2))


def _wait_healthy(host, port, n, timeout=90.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status, body = get(host, port, "/healthz")
        if json.loads(body)["healthy"] >= n:
            return
        time.sleep(0.05)
    raise AssertionError(f"router never reported {n} healthy workers")


def _finish(proc, timeout=60.0):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10.0)
    return out, err


def test_serve_cli_stub_fleet_contracts(tmp_path):
    """``cli.serve --workers 2 --fleet_stub_workers``: the router serves,
    ``--versions`` prints a ``versions/v1`` line, and SIGTERM ends the fleet
    with a ``fleet/v1`` last line; both pass tools/check_cli_contract.py."""
    from tools.check_cli_contract import check_cli_contract_text

    proc = subprocess.Popen(
        [sys.executable, "-m", "deepinteract_tpu_torch.cli.serve", "--workers", "2",
         "--fleet_stub_workers", "--port", "0", "--probe_interval_s", "0.2",
         "--warmup_buckets", "128x128x1", "--fleet_dir", str(tmp_path / "fleet")],
        cwd=REPO, env=_serve_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        host, port = _router_address(proc)
        _wait_healthy(host, port, 2)
        status, _, headers = post(host, port)
        assert status == 200 and headers["X-DI-Worker"] in ("w1", "w2")
        versions = subprocess.run(
            [sys.executable, "-m", "deepinteract_tpu_torch.cli.serve", "--versions",
             "--host", host, "--port", str(port)],
            cwd=REPO, env=_serve_env(), capture_output=True, text=True, timeout=120)
        assert versions.returncode == 0
        record = check_cli_contract_text(versions.stdout, "versions")
        assert record["workers_by_version"] == {"stub-v1": 2}
        _, body = get(host, port, "/healthz")
        proc.send_signal(signal.SIGTERM)
        out, err = _finish(proc)
    finally:
        if proc.poll() is None:
            _finish(proc, timeout=10.0)
    assert proc.returncode == 0, err[-2000:]
    record = check_cli_contract_text(out, "fleet")
    assert record["ok"] and record["routed"] >= 1 and record["mesh_shape"] == "1x1"


@pytest.mark.parametrize("argv", [
    ["--mesh_shape", "64x64"],
    ["--mesh_shape", "64x64", "--workers", "2"],
])
def test_engine_workers_refuse_a_mesh_shape(argv, capsys):
    """A mesh worker is a group of one process per device: an engine
    worker (alone or in a fleet) refuses a shape the host cannot provide,
    before anything starts."""
    from deepinteract_tpu_torch.cli.serve import main

    assert main(["--device", "cpu", *argv]) == 2
    err = capsys.readouterr().err
    assert "--mesh_shape 64x64 needs 4096 devices: this host has" in err


def test_engine_fleet_without_a_gpu_refuses(capsys):
    """The control plane resolves the workers' device (and builds the
    kernels there) before it spawns anything: no GPU, no fleet."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the refusal needs one without")
    from deepinteract_tpu_torch.cli.serve import main

    assert main(["--workers", "2", "--port", "0"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# wire compatibility: each package's router in front of the other's stubs
# ---------------------------------------------------------------------------


def test_port_router_serves_jax_stub_workers(tmp_path):
    from deepinteract_tpu.serving.fleet import stub_worker_cmd as jax_stub_worker_cmd

    sup = make_supervisor(tmp_path, n=2, cmd_fn=jax_stub_worker_cmd)
    router = FleetRouter(sup, port=0, cfg=RouterConfig(proxy_timeout_s=10.0,
                                                       warm_timeout_s=30.0,
                                                       drain_timeout_s=10.0))
    router.start()
    try:
        wait_routable(sup, 2)
        assert all("deepinteract_tpu.serving.worker_stub" in " ".join(
            open(f"/proc/{w['pid']}/cmdline", "rb").read().decode().split("\0"))
            for w in sup.worker_infos())
        host, port = router.address
        workers = set()
        for _ in range(4):
            status, body, headers = post(host, port)
            assert status == 200 and json.loads(body)["weights_signature"] == "v1"
            workers.add(headers["X-DI-Worker"])
        assert workers == {"w1", "w2"}
        status, body = get(host, port, "/metrics")
        assert 'di_serving_requests_total{worker="w1"' in body.decode()
        record = router.rollover({"weights_signature": "v2"})
        assert set(record["drain_exit_codes"].values()) == {0}
    finally:
        router.drain()


def test_jax_router_serves_port_stub_workers(tmp_path):
    from deepinteract_tpu.serving.fleet import FleetConfig as JaxFleetConfig
    from deepinteract_tpu.serving.fleet import WorkerSupervisor as JaxWorkerSupervisor
    from deepinteract_tpu.serving.router import FleetRouter as JaxFleetRouter
    from deepinteract_tpu.serving.router import RouterConfig as JaxRouterConfig
    from torch_port_helpers import STUB_OVERRIDES

    sup = JaxWorkerSupervisor(
        stub_worker_cmd,
        JaxFleetConfig(num_workers=2, state_dir=str(tmp_path / "fleet"),
                       probe_interval_s=0.15, heartbeat_max_age_s=5.0,
                       restart_backoff_s=0.05),
        overrides=dict(STUB_OVERRIDES))
    router = JaxFleetRouter(sup, port=0, cfg=JaxRouterConfig(
        proxy_timeout_s=10.0, warm_timeout_s=30.0, drain_timeout_s=10.0))
    router.start()
    try:
        wait_routable(sup, 2)
        host, port = router.address
        workers = set()
        for _ in range(4):
            status, body, headers = post(host, port)
            assert status == 200 and json.loads(body)["weights_signature"] == "v1"
            workers.add(headers["X-DI-Worker"])
        assert workers == {"w1", "w2"}
        body = json.dumps({"chains": ["a", "b", "c"]}).encode()
        status, raw, _ = post(host, port, "/assembly", body)
        assert status == 200 and json.loads(raw)["unique_encodes"] == 3
        record = router.rollover({"weights_signature": "v2"})
        assert set(record["drain_exit_codes"].values()) == {0}
        _, body, _ = post(host, port)
        assert json.loads(body)["weights_signature"] == "v2"
    finally:
        router.drain()


# ---------------------------------------------------------------------------
# a real engine worker (--device cpu) behind the port's router
# ---------------------------------------------------------------------------

SMALL_FLAGS = ["--num_gnn_hidden_channels", "16", "--num_gnn_attention_heads", "2",
               "--num_interact_layers", "2", "--num_interact_hidden_channels", "16",
               "--node_count_limit", "64"]  # torch_port_helpers.port_cfg()


def test_real_cpu_engine_worker_behind_the_router_matches_the_jax_engine(tmp_path):
    import io

    from deepinteract_tpu.serving import EngineConfig as JaxEngineConfig
    from deepinteract_tpu.serving import InferenceEngine as JaxInferenceEngine
    from deepinteract_tpu_torch.cli.serve import engine_worker_cmd_fn
    from deepinteract_tpu_torch.data.io import save_complex_npz
    from deepinteract_tpu_torch.data.synthetic import random_raw_complex
    from deepinteract_tpu_torch.weights import save_npz
    from torch_port_helpers import jax_cfg

    jeng = JaxInferenceEngine(jax_cfg(), cfg=JaxEngineConfig(max_batch=4))
    weights = str(tmp_path / "w.npz")
    save_npz(weights, {"params": jeng.params, "batch_stats": jeng.batch_stats})
    argv = ["--device", "cpu", "--weights", weights, "--max_delay_ms", "5",
            "--warmup_buckets", "64x64x1", *SMALL_FLAGS]
    sup = WorkerSupervisor(engine_worker_cmd_fn(argv), FleetConfig(
        num_workers=1, state_dir=str(tmp_path / "fleet"), probe_interval_s=0.2))
    router = FleetRouter(sup, port=0, cfg=RouterConfig(proxy_timeout_s=60.0))
    router.start()
    try:
        wait_routable(sup, 1, timeout=120.0)
        (info,) = sup.routable_workers()
        health = info["health"]
        assert health["status"] == "ok" and health["mesh_shape"] == "1x1"
        assert health["weights_signature"].startswith("jax-variables:")
        assert health["warm_buckets"] == ["64x64/b1/k20g2"] and health["inflight"] == 0
        host, port = router.address
        for seed, (n1, n2) in ((1, (30, 24)), (2, (40, 33))):
            raw = random_raw_complex(n1, n2, np.random.default_rng(seed), knn=6)
            buf = io.BytesIO()
            save_complex_npz(buf, raw["graph1"], raw["graph2"], raw["examples"], "c")
            status, body, headers = post(host, port, body=buf.getvalue(), timeout=120.0,
                                         headers={"Content-Type": "application/octet-stream",
                                                  "X-DI-Bucket": "64x64"})
            assert status == 200 and headers["X-DI-Worker"] == "w1", body[:300]
            got = np.asarray(json.loads(body)["contact_probs"])
            np.testing.assert_allclose(got, jeng.predict(raw)["probs"], rtol=0, atol=1e-4)
        status, body = get(host, port, "/stats")
        inventory = json.loads(body)["workers"]["w1"]["engine"]["compile_inventory"]
        assert inventory["64x64/b1/k20g2"]["replays"] == 0  # kNN 6 requests: another key
        codes = sup.stop(timeout_s=30.0)
        assert codes == {"w1": 0}
    finally:
        router.drain()
        jeng.close()


@pytest.mark.chaos
def test_engine_worker_drained_while_warming_exits_0(tmp_path):
    """SIGTERM during the weight load and warm-up captures: the worker
    finishes that step, serves nothing, and exits 0 (a rollover abort
    drains replacements that may still be warming)."""
    heartbeat = tmp_path / "hb.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepinteract_tpu_torch.cli.serve", "--device", "cpu",
         "--port", "0", "--heartbeat_file", str(heartbeat), "--heartbeat_interval_s", "0.2",
         "--warmup_buckets", "64x64x1,128x128x2", *SMALL_FLAGS],
        cwd=REPO, env=_serve_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60.0
        while not heartbeat.exists() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert heartbeat.exists()
        proc.send_signal(signal.SIGTERM)
        _finish(proc, timeout=120.0)
    finally:
        if proc.poll() is None:
            _finish(proc, timeout=10.0)
    assert proc.returncode == 0
