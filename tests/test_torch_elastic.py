"""The port's elastic fleet (``deepinteract_tpu_torch.serving.autoscaler``,
the router's versions, shadow traffic and promotion, preemption and kill -9
recovery), mirroring tests/test_elastic.py; its two fsck tests wait for the
port's fsck.

Real-fleet tests reuse the stub-worker helpers of ``torch_port_helpers``;
policy-only tests run the autoscaler's control law against scripted
signal snapshots, so hysteresis and cooldown are asserted in milliseconds.
Every wait polls with a bound."""

import json
import os
import signal
import threading
import time

import pytest

from deepinteract_tpu_torch.robustness import artifacts, faults
from deepinteract_tpu_torch.serving.autoscaler import Autoscaler, AutoscalerConfig
from deepinteract_tpu_torch.serving.fleet import load_persisted_state
from deepinteract_tpu_torch.serving.router import FleetRouter, RouterConfig
from torch_port_helpers import http_get as get
from torch_port_helpers import http_post as post
from torch_port_helpers import make_fleet, make_supervisor, wait_routable


class _NullRouter:
    """The router surface the autoscaler's POLICY needs — real scale
    actions are monkeypatched out in policy tests."""

    def request_p99_ms(self):
        return 0.0

    def adopt_worker(self, worker_id):
        pass

    def release_worker(self, worker_id):
        pass


def make_policy_autoscaler(tmp_path, monkeypatch, signals, **cfg_kw):
    """Autoscaler over an UNSTARTED supervisor with scripted signals and
    recorded (not executed) scale actions."""
    cfg_kw.setdefault("min_workers", 1)
    cfg_kw.setdefault("max_workers", 4)
    cfg_kw.setdefault("breach_polls", 2)
    cfg_kw.setdefault("cooldown_s", 0.0)
    sup = make_supervisor(tmp_path, n=2)
    scaler = Autoscaler(sup, _NullRouter(), cfg=AutoscalerConfig(**cfg_kw))
    actions = []
    monkeypatch.setattr(scaler, "signals", lambda: dict(signals))
    monkeypatch.setattr(scaler, "_scale_up",
                        lambda target: actions.append(("up", target)))
    monkeypatch.setattr(scaler, "_scale_down",
                        lambda target: actions.append(("down", target)))
    return scaler, actions, signals


IDLE = {"workers": 2.0, "mean_inflight": 0.0, "degraded_workers": 0.0,
        "p99_ms": 0.0, "shed_degraded": 0.0, "pressure_delta": 0.0}
BUSY = {"workers": 2.0, "mean_inflight": 5.0, "degraded_workers": 0.0,
        "p99_ms": 0.0, "shed_degraded": 0.0, "pressure_delta": 0.0}
STEADY = {"workers": 2.0, "mean_inflight": 1.0, "degraded_workers": 0.0,
          "p99_ms": 0.0, "shed_degraded": 0.0, "pressure_delta": 0.0}


def test_autoscaler_hysteresis(tmp_path, monkeypatch):
    """One breaching poll never acts; breach_polls consecutive breaches
    do — and a mid-streak recovery resets the streak."""
    scaler, actions, sig = make_policy_autoscaler(
        tmp_path, monkeypatch, dict(BUSY), breach_polls=3)
    assert scaler.poll_once() is None
    assert scaler.poll_once() is None
    # Streak broken by one healthy poll: the count starts over.
    sig.update(STEADY)
    assert scaler.poll_once() is None
    sig.update(BUSY)
    assert scaler.poll_once() is None
    assert scaler.poll_once() is None
    assert scaler.poll_once() == "up"
    assert actions == [("up", 3)]


def test_autoscaler_cooldown_prevents_flap(tmp_path, monkeypatch):
    """After an action the controller holds for cooldown_s regardless of
    signals; after the cooldown it acts again."""
    scaler, actions, sig = make_policy_autoscaler(
        tmp_path, monkeypatch, dict(BUSY), breach_polls=1,
        cooldown_s=30.0)
    assert scaler.poll_once() == "up"
    # Still saturated, but inside the cooldown: no action, no flap.
    assert scaler.poll_once() is None
    assert scaler.poll_once() is None
    # Cooldown expiry (simulated): the next breach acts again. The
    # mocked _scale_up never grew the fleet, so report it caught up.
    sig["workers"] = 3.0
    scaler._last_action_ts = time.monotonic() - 31.0
    assert scaler.poll_once() == "up"
    assert actions == [("up", 3), ("up", 4)]
    # At max_workers: saturation alone cannot grow further.
    sig["workers"] = 4.0
    scaler._last_action_ts = time.monotonic() - 31.0
    assert scaler.poll_once() is None


def test_autoscaler_scale_down_floor(tmp_path, monkeypatch):
    """Idle polls shrink toward — but never below — min_workers."""
    scaler, actions, sig = make_policy_autoscaler(
        tmp_path, monkeypatch, dict(IDLE), breach_polls=2,
        min_workers=2)
    scaler._target = 3
    sig["workers"] = 3.0
    assert scaler.poll_once() is None
    assert scaler.poll_once() == "down"
    assert actions == [("down", 2)]
    sig["workers"] = 2.0
    assert scaler.poll_once() is None
    assert scaler.poll_once() is None  # at the floor: held, not drained


def test_autoscaler_reconcile_after_restart(tmp_path, monkeypatch):
    """A live fleet below the (persisted) target reconciles up without
    waiting out a breach streak — the decision was already made."""
    scaler, actions, sig = make_policy_autoscaler(
        tmp_path, monkeypatch, dict(STEADY), breach_polls=5)
    scaler._target = 4
    sig["workers"] = 2.0
    assert scaler.poll_once() == "reconcile_up"
    assert actions == [("up", 4)]


@pytest.mark.chaos
def test_autoscale_decision_chaos_leaves_fleet_unchanged(
        tmp_path, monkeypatch):
    """The autoscale.decision fault fires at decision commit: the tick
    swallows it, counts it, and neither target nor fleet changes."""
    scaler, actions, sig = make_policy_autoscaler(
        tmp_path, monkeypatch, dict(BUSY), breach_polls=1)
    try:
        faults.configure({"autoscale.decision": 1})
        assert scaler.poll_once() is None
        assert actions == []
        assert scaler.stats()["target_workers"] == 2
        assert scaler.stats()["errors"] == 1
        # The fault plan exhausted: the controller recovers by itself.
        assert scaler.poll_once() == "up"
        assert actions == [("up", 3)]
    finally:
        faults.reset()


def test_autoscaler_persistence_roundtrip(tmp_path, monkeypatch):
    """The target persists through fleet_state.json and a NEW controller
    over the same state dir resumes it (kill -9 of the control plane
    loses no capacity decision)."""
    scaler, actions, sig = make_policy_autoscaler(
        tmp_path, monkeypatch, dict(BUSY), breach_polls=1)
    assert scaler.poll_once() == "up"
    state = load_persisted_state(scaler.sup.state_path)
    assert state["autoscale"]["target_workers"] == 3
    # Second life: same state dir, fresh supervisor + controller.
    sup2 = make_supervisor(tmp_path, n=2)
    scaler2 = Autoscaler(sup2, _NullRouter(),
                         cfg=AutoscalerConfig(cooldown_s=0.0))
    assert scaler2.stats()["target_workers"] == 3


# ---------------------------------------------------------------------------
# Real-fleet: preemption as a first-class capacity event
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_preemption_no_circuit_penalty_immediate_replacement(tmp_path):
    """preempt_worker: SIGTERM drain, retirement WITHOUT a restart/
    circuit penalty, and an immediate same-overrides replacement that
    the router adopts into the preempted worker's routing slot."""
    sup, router = make_fleet(tmp_path, n=2)
    try:
        victim = sup.routable_workers()[-1]["worker_id"]
        before = sup.stats()
        assert sup.preempt_worker(victim)
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            sup.poll_once()
            stats = sup.stats()
            if (stats["preemptions"] == 1
                    and len(sup.routable_workers()) >= 2):
                break
            time.sleep(0.05)
        stats = sup.stats()
        assert stats["preemptions"] == 1
        # EXPECTED loss: not a restart, no circuit movement.
        assert stats["restarts_total"] == before["restarts_total"]
        assert stats["circuit_open"] == 0
        assert victim not in {w["worker_id"]
                              for w in sup.routable_workers()}
        # The replacement took the victim's routing slot.
        active = router.stats()["router"]["active_workers"]
        assert victim not in active
        assert len(active) == 2
        host, port = router.address
        status, body, _ = post(host, port)
        assert status == 200
        # Preemption shows in the fleet/v1 contract.
        assert router.final_contract()["preemptions"] == 1
    finally:
        router.drain()


@pytest.mark.chaos
def test_fleet_preempt_chaos_site(tmp_path):
    """The fleet.preempt fault preempts a routable worker on that
    supervisor poll tick — deterministic spot-loss injection."""
    sup, router = make_fleet(tmp_path, n=2)
    try:
        faults.configure({"fleet.preempt": 1})
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            sup.poll_once()
            if (sup.stats()["preemptions"] == 1
                    and len(sup.routable_workers()) >= 2):
                break
            time.sleep(0.05)
        assert sup.stats()["preemptions"] == 1
        assert len(sup.routable_workers()) >= 2
    finally:
        faults.reset()
        router.drain()


# ---------------------------------------------------------------------------
# Real-fleet: multi-version routing
# ---------------------------------------------------------------------------


def add_version_worker(sup, router, signature, probs_value=0.5, n=1,
                       delay_ms=5):
    """Spawn ``n`` workers of another version and adopt them."""
    ids = []
    for _ in range(n):
        wid = sup.spawn_worker({"weights_signature": signature,
                                "probs_value": probs_value,
                                "delay_ms": delay_ms,
                                "heartbeat_interval_s": 0.2})
        ids.append(wid)
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        sup.poll_once()
        routable = {w["worker_id"] for w in sup.routable_workers()}
        if all(wid in routable for wid in ids):
            break
        time.sleep(0.05)
    else:
        raise AssertionError(f"{ids} never became routable")
    for wid in ids:
        router.adopt_worker(wid)
    return ids


def body_signature(body):
    return json.loads(body.decode())["weights_signature"]


def test_version_pinning_header_and_json_field(tmp_path):
    sup, router = make_fleet(tmp_path, n=2)  # base version "v1"
    try:
        add_version_worker(sup, router, "v2")
        host, port = router.address
        for _ in range(4):
            status, body, headers = post(
                host, port, headers={"X-DI-Version": "v2"})
            assert status == 200
            assert body_signature(body) == "v2"
            assert headers.get("X-DI-Version") == "v2"
        for _ in range(4):
            status, body, _ = post(
                host, port, body=json.dumps({"version": "v1"}).encode())
            assert status == 200
            assert body_signature(body) == "v1"
    finally:
        router.drain()


def test_pinned_version_zero_healthy_503_no_fallback(tmp_path):
    """A pinned version with zero healthy workers answers 503 +
    Retry-After; v1 siblings NEVER silently absorb the request."""
    sup, router = make_fleet(tmp_path, n=2)
    try:
        (v2_id,) = add_version_worker(sup, router, "v2")
        sup.drain_worker(v2_id, timeout_s=10.0)
        host, port = router.address
        status, body, headers = post(
            host, port, headers={"X-DI-Version": "v2"})
        assert status == 503
        assert "Retry-After" in headers
        assert b"v2" in body
        # Unpinned traffic still flows on the surviving version.
        status, body, _ = post(host, port)
        assert status == 200
        assert body_signature(body) == "v1"
    finally:
        router.drain()


@pytest.mark.chaos
def test_pinned_failover_stays_within_version(tmp_path):
    """Failover retries stay inside the pinned version's worker set:
    with one of two v2 workers SIGKILL'd mid-flight under pinned load,
    EVERY v2-pinned request resolves on the other v2 worker — never on
    a v1 sibling."""
    sup, router = make_fleet(tmp_path, n=2)
    try:
        v2_ids = add_version_worker(sup, router, "v2", n=2,
                                    delay_ms=50)
        host, port = router.address
        results = []
        lock = threading.Lock()
        stop_at = time.monotonic() + 3.0

        def client():
            while time.monotonic() < stop_at:
                try:
                    status, body, _ = post(
                        host, port, timeout=10.0,
                        headers={"X-DI-Version": "v2"})
                except Exception as exc:  # noqa: BLE001
                    status, body = -1, repr(exc).encode()
                with lock:
                    results.append((status, body))

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10.0
        while len(results) < 8 and time.monotonic() < deadline:
            time.sleep(0.01)  # pinned load running, requests in flight
        os.kill(sup.worker_info(v2_ids[0])["pid"], signal.SIGKILL)
        for t in threads:
            t.join(timeout=20.0)
        assert not any(t.is_alive() for t in threads)
        assert len(results) > 10
        non_200 = [(s, b) for s, b in results if s != 200]
        assert non_200 == [], f"pinned requests dropped: {non_200[:5]}"
        # Every answer came from the PINNED version — the retry of the
        # killed worker's in-flight requests never crossed to v1.
        assert {body_signature(b) for _, b in results} == {"v2"}
        with router._lock:
            assert router._failovers >= 1
    finally:
        router.drain()


def test_canary_weighted_split_exact(tmp_path):
    """Smooth weighted round-robin: weights {v1: 3, v2: 1} split 40
    unpinned requests exactly 30/10."""
    sup, router = make_fleet(tmp_path, n=1)
    try:
        add_version_worker(sup, router, "v2")
        host, port = router.address
        status, body, _ = post(
            host, port, path="/admin/versions",
            body=json.dumps({"weights": {"v1": 3, "v2": 1}}).encode())
        assert status == 200
        record = json.loads(body.decode())
        assert record["schema"] == "versions/v1"
        assert record["weights"] == {"v1": 3.0, "v2": 1.0}
        assert record["workers_by_version"] == {"v1": 1, "v2": 1}
        counts = {"v1": 0, "v2": 0}
        for _ in range(40):
            status, body, _ = post(host, port)
            assert status == 200
            counts[body_signature(body)] += 1
        assert counts == {"v1": 30, "v2": 10}
    finally:
        router.drain()


def test_versions_rejects_malformed_spec(tmp_path):
    sup, router = make_fleet(tmp_path, n=1)
    try:
        host, port = router.address
        for bad in ({"weights": {"v1": "heavy"}},
                    {"weights": {"v1": -1}},
                    {"weights": {"v1": 0}},
                    {"shadow": {"fraction": 0.5}},
                    {"shadow": {"candidate": "v2", "fraction": 2.0}}):
            status, body, _ = post(host, port, path="/admin/versions",
                                   body=json.dumps(bad).encode())
            assert status == 400, bad
        # State untouched by every rejected spec.
        status, body = get(host, port, "/admin/versions")
        record = json.loads(body.decode())
        assert record["weights"] == {}
        assert record["shadow"] is None
    finally:
        router.drain()


# ---------------------------------------------------------------------------
# Shadow traffic + promotion
# ---------------------------------------------------------------------------


def arm_shadow(host, port, candidate="v2", min_samples=4,
               min_agreement=0.9, ledger_path=None):
    spec = {"weights": {"v1": 1},
            "shadow": {"candidate": candidate, "fraction": 1.0,
                       "min_samples": min_samples,
                       "min_agreement": min_agreement}}
    if ledger_path:
        spec["shadow"]["ledger_path"] = ledger_path
    status, body, _ = post(host, port, path="/admin/versions",
                           body=json.dumps(spec).encode())
    assert status == 200
    return json.loads(body.decode())


def wait_shadow_samples(host, port, n, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        _, body = get(host, port, "/admin/versions")
        record = json.loads(body.decode())
        if record["shadow_samples"] >= n:
            return record
        time.sleep(0.1)
    raise AssertionError(f"never reached {n} shadow samples: {record}")


def test_shadow_ledger_and_promotion_e2e(tmp_path):
    """The canary/shadow e2e acceptance: shadow traffic flows to the
    candidate, the agreement ledger lands atomically (artifact +
    verified sidecar), and promotion shifts routing weight once the
    evidence clears the bar."""
    sup, router = make_fleet(tmp_path, n=2)
    try:
        add_version_worker(sup, router, "v2", probs_value=0.5)
        host, port = router.address
        ledger = str(tmp_path / "ledger" / "agreement_v2.jsonl")
        arm_shadow(host, port, ledger_path=ledger, min_samples=4)
        for _ in range(6):
            status, body, _ = post(host, port)
            assert status == 200
            assert body_signature(body) == "v1"  # weights say v1
        # All 6 mirrors accounted for, so no shadow thread is still
        # appending when the ledger's integrity is checked.
        record = wait_shadow_samples(host, port, 6)
        assert record["shadow_agreement"] == 1.0
        # Ledger: a verifiable artifact of well-formed JSONL lines.
        deadline = time.monotonic() + 10.0
        while True:
            try:
                artifacts.verify_file(ledger, kind="agreement_ledger")
                break
            except artifacts.ArtifactError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)
        entries = [json.loads(line) for line in
                   open(ledger).read().splitlines() if line]
        assert len(entries) >= 6
        assert all(e["candidate"] == "v2" for e in entries)
        assert all(e["outcome"] == "agree" for e in entries)
        # Promotion clears the bar: weight shifts to the candidate.
        status, body, _ = post(host, port, path="/admin/promote",
                               body=b"{}")
        assert status == 200
        promoted = json.loads(body.decode())
        assert promoted["promoted"] == "v2"
        assert promoted["weights"] == {"v2": 1.0}
        assert promoted["promotions"] == 1
        for _ in range(4):
            status, body, _ = post(host, port)
            assert status == 200
            assert body_signature(body) == "v2"
    finally:
        router.drain()


def test_promotion_refused_on_disagreement(tmp_path):
    """A disagreeing candidate (different probs_value) is REFUSED and
    the routing weights stay untouched."""
    sup, router = make_fleet(tmp_path, n=2)
    try:
        add_version_worker(sup, router, "v2", probs_value=0.9)
        host, port = router.address
        arm_shadow(host, port, min_samples=3)
        for _ in range(5):
            assert post(host, port)[0] == 200
        record = wait_shadow_samples(host, port, 3)
        assert record["shadow_agreement"] == 0.0
        status, body, _ = post(host, port, path="/admin/promote",
                               body=b"{}")
        assert status == 409
        refused = json.loads(body.decode())
        assert refused["ok"] is False
        assert refused["refused"]["agreement_rate"] == 0.0
        # Fleet untouched: weights unchanged, traffic still on v1.
        _, body = get(host, port, "/admin/versions")
        assert json.loads(body.decode())["weights"] == {"v1": 1.0}
        status, body, _ = post(host, port)
        assert body_signature(body) == "v1"
        # Insufficient evidence is also a refusal, even at perfect
        # agreement: promote with an impossible sample floor.
        status, _, _ = post(
            host, port, path="/admin/promote",
            body=json.dumps({"min_samples": 10**6}).encode())
        assert status == 409
    finally:
        router.drain()


# ---------------------------------------------------------------------------
# kill -9 recovery: no orphans, no dropped version pins, target resumes
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_kill9_supervisor_mid_scale_event_recovers(tmp_path):
    """Supervisor life A dies (kill -9 simulation: monitor stopped,
    workers abandoned) mid-scale-event with target=3 persisted; life B
    over the same state dir reaps A's orphaned workers, resumes the
    target, and reconciles the fleet back up to it."""
    sup_a = make_supervisor(tmp_path, n=2)
    sup_a.start()
    try:
        wait_routable(sup_a, 2)
        sup_a.set_extra_state("autoscale", {"target_workers": 3,
                                            "scale_ups": 1,
                                            "scale_downs": 0,
                                            "errors": 0})
        orphan_pids = [w["pid"] for w in sup_a.worker_infos()]
        # Kill -9 simulation: the monitor thread stops dead; no drain,
        # no retirement — workers keep running as orphans.
        sup_a._stop.set()
        if sup_a._monitor is not None:
            sup_a._monitor.join(timeout=10.0)

        sup_b = make_supervisor(tmp_path, n=2)
        router_b = FleetRouter(
            sup_b, port=0, cfg=RouterConfig(proxy_timeout_s=10.0,
                                            warm_timeout_s=30.0,
                                            drain_timeout_s=10.0))
        router_b.start()
        try:
            # Orphans reaped at startup: nothing serves unsupervised.
            # (A SIGKILL'd child of THIS process lingers as a zombie
            # until wait()ed, so "dead" means gone-or-zombie here.)
            def dead(pid):
                try:
                    with open(f"/proc/{pid}/stat") as fh:
                        return fh.read().split(") ")[-1][0] == "Z"
                except OSError:
                    return True

            for pid in orphan_pids:
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline and not dead(pid):
                    time.sleep(0.05)
                assert dead(pid), f"orphan {pid} still alive"
            assert sup_b.stats()["orphans_reaped"] == 2
            wait_routable(sup_b, 2)
            scaler = Autoscaler(
                sup_b, router_b,
                cfg=AutoscalerConfig(min_workers=1, max_workers=4,
                                     cooldown_s=0.0, breach_polls=3,
                                     warm_timeout_s=30.0))
            assert scaler.stats()["target_workers"] == 3
            assert scaler.poll_once() == "reconcile_up"
            assert len(sup_b.routable_workers()) == 3
            assert len(router_b.stats()["router"]["active_workers"]) == 3
            host, port = router_b.address
            assert post(host, port)[0] == 200
        finally:
            router_b.drain()
    finally:
        sup_a.stop()


@pytest.mark.chaos
def test_kill9_mid_promotion_drops_no_version_pins(tmp_path):
    """Life A persists canary weights + a promotion; life B restores
    them from fleet_state.json — pinned routing and the weighted split
    both survive the control plane's death."""
    sup_a, router_a = make_fleet(tmp_path, n=1)
    host_a, port_a = router_a.address
    add_version_worker(sup_a, router_a, "v2")
    status, _, _ = post(
        host_a, port_a, path="/admin/versions",
        body=json.dumps({"weights": {"v1": 1, "v2": 1}}).encode())
    assert status == 200
    # Kill -9 simulation (as above): abandon life A un-drained.
    sup_a._stop.set()
    if sup_a._monitor is not None:
        sup_a._monitor.join(timeout=10.0)
    router_a._draining.set()
    router_a.httpd.shutdown()

    sup_b = make_supervisor(tmp_path, n=1)
    router_b = FleetRouter(
        sup_b, port=0, cfg=RouterConfig(proxy_timeout_s=10.0,
                                        warm_timeout_s=30.0,
                                        drain_timeout_s=10.0))
    router_b.start()
    try:
        wait_routable(sup_b, 1)
        # The version weights survived the crash.
        assert router_b.health()["version_weights"] == {
            "v1": 1.0, "v2": 1.0}
        host, port = router_b.address
        # A pin on the (now-absent) v2 fails LOUDLY — 503 + Retry-After
        # — instead of silently landing on v1: the pin survived.
        status, _, headers = post(host, port,
                                  headers={"X-DI-Version": "v2"})
        assert status == 503
        assert "Retry-After" in headers
        add_version_worker(sup_b, router_b, "v2")
        status, body, _ = post(host, port,
                               headers={"X-DI-Version": "v2"})
        assert status == 200
        assert body_signature(body) == "v2"
    finally:
        router_b.drain()
        sup_a.stop()
