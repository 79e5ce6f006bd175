"""The port's serving machinery against the JAX package's: the result cache
and content hash, the micro-batching scheduler, admission control,
deadlines, the load shedder and the request trace.

Where a decision is deterministic, the same inputs go to the JAX class
and to the port's, and the outputs must be equal; the scheduler cases run
on both. No engine and no model here. Waits are event-driven: the only
sleeps are polls, never longer than the scheduler's ``max_delay_ms``."""

import copy
import threading
import time

import numpy as np
import pytest

from deepinteract_tpu.obs import reqtrace as jax_reqtrace
from deepinteract_tpu.serving import admission as jax_admission
from deepinteract_tpu.serving import cache as jax_cache
from deepinteract_tpu.serving import scheduler as jax_scheduler
from deepinteract_tpu_torch.data.synthetic import random_raw_complex
from deepinteract_tpu_torch.obs import metrics as port_metrics
from deepinteract_tpu_torch.obs import reqtrace as port_reqtrace
from deepinteract_tpu_torch.serving import admission as port_admission
from deepinteract_tpu_torch.serving import cache as port_cache
from deepinteract_tpu_torch.serving import scheduler as port_scheduler
from torch_port_helpers import wait_until

PACKAGES = {
    "jax": (jax_cache, jax_scheduler, jax_admission),
    "port": (port_cache, port_scheduler, port_admission),
}


def raw(seed, n1=20, n2=16):
    return random_raw_complex(n1, n2, np.random.default_rng(seed), knn=6)


# ---------------------------------------------------------------------------
# cache.py
# ---------------------------------------------------------------------------


def cache_trace(module, capacity):
    """Every observable outcome of one op sequence on a ResultCache."""
    cache = module.ResultCache(capacity=capacity)
    out = []
    cache.put("a", 1)
    cache.put("b", 2)
    out.append(cache.get("a"))  # refreshes recency: b is now LRU
    cache.put("c", 3)
    out += [cache.get("b"), cache.get("c"), cache.get("a"), len(cache)]
    cache.put("d", 4)
    out += [cache.get(k) for k in "abcd"]
    out.append(cache.stats())
    return out


@pytest.mark.parametrize("capacity", [0, 1, 2, 3])
def test_result_cache_matches_jax_eviction_and_stats(capacity):
    port, ref = cache_trace(port_cache, capacity), cache_trace(jax_cache, capacity)
    assert port == ref
    if capacity == 2:
        assert port[1:4] == [None, 3, 1] and port[-1]["size"] == 2


@pytest.mark.parametrize("extra", [(), ("input_indep", False), ("input_indep", True)])
@pytest.mark.parametrize("seed", [1, 2])
def test_content_hash_equals_jax_digest(seed, extra):
    r = raw(seed)
    assert port_cache.content_hash(r, extra=extra) == jax_cache.content_hash(r, extra=extra)


def test_content_hash_sensitive_to_features_shapes_and_flags():
    a, b = raw(1), raw(2)
    h = port_cache.content_hash
    assert h(a) == h(copy.deepcopy(a)) and h(a) != h(b)
    c = copy.deepcopy(a)
    c["graph1"]["node_feats"][0, 0] += 1.0
    assert h(a) != h(c)
    d = copy.deepcopy(a)  # same bytes, another shape
    d["graph2"]["nbr_idx"] = d["graph2"]["nbr_idx"].reshape(-1)
    assert h(a) != h(d)
    assert h(a, extra=("input_indep", False)) != h(a, extra=("input_indep", True))


# ---------------------------------------------------------------------------
# scheduler.py: each case on both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_scheduler_coalesces_full_batch_and_partial_on_delay(pkg):
    _, sched_mod, _ = PACKAGES[pkg]
    flushed = []

    def flush(key, payloads):
        flushed.append((key, list(payloads)))
        return [p * 10 for p in payloads]

    sched = sched_mod.MicroBatchScheduler(flush, max_batch=4, max_delay_ms=40.0)
    try:
        futs = [sched.submit("k", i) for i in range(4)]
        assert [f.result(timeout=5) for f in futs] == [0, 10, 20, 30]
        assert flushed[-1] == ("k", [0, 1, 2, 3])
        t0 = time.monotonic()
        futs = [sched.submit("k", i) for i in (7, 8)]
        assert [f.result(timeout=5) for f in futs] == [70, 80]
        assert time.monotonic() - t0 >= 0.03  # waited ~max_delay for company
        assert flushed[-1] == ("k", [7, 8])
        fa, fb = sched.submit("a", 1), sched.submit("b", 2)
        assert (fa.result(timeout=5), fb.result(timeout=5)) == (10, 20)
        assert {k for k, _ in flushed[-2:]} == {"a", "b"}
        hist = sched.stats()["batch_size_histogram"]
        assert hist.get(4) == 1 and hist.get(2) == 1
    finally:
        sched.drain()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_scheduler_drain_flushes_pending_then_rejects(pkg):
    _, sched_mod, _ = PACKAGES[pkg]
    sched = sched_mod.MicroBatchScheduler(lambda k, p: list(p), max_batch=8,
                                          max_delay_ms=10_000.0)
    fut = sched.submit("k", 42)  # would wait 10 s for company
    assert sched.drain(timeout=10)
    assert fut.result(timeout=1) == 42
    with pytest.raises(sched_mod.SchedulerClosed):
        sched.submit("k", 43)
    assert sched.stats()["draining"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_scheduler_flush_error_fails_only_its_group(pkg):
    _, sched_mod, adm_mod = PACKAGES[pkg]
    calls = {"n": 0}

    def flush(key, payloads):
        calls["n"] += 1
        if calls["n"] == 1:
            raise adm_mod.BatchExecutionError("injected poison", stage="dispatch")
        return list(payloads)

    sched = sched_mod.MicroBatchScheduler(flush, max_batch=2, max_delay_ms=5.0)
    try:
        futs = [sched.submit("k", i) for i in range(2)]
        for f in futs:
            with pytest.raises(adm_mod.BatchExecutionError, match="poison"):
                f.result(timeout=5)
        assert sched.submit("k", 2).result(timeout=5) == 2  # the worker survived
        assert sched.stats()["batch_failures"] == 1
    finally:
        sched.drain()


def test_port_scheduler_counts_batch_failures_in_its_registry():
    counter = port_metrics.counter("di_serving_batch_failures_total")
    before = counter.value()

    def flush(key, payloads):
        raise RuntimeError("device fell over")

    sched = port_scheduler.MicroBatchScheduler(flush, max_batch=1, max_delay_ms=0.0)
    try:
        with pytest.raises(RuntimeError, match="fell over"):
            sched.submit("k", 1).result(timeout=5)
    finally:
        sched.drain()
    assert counter.value() == before + 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_scheduler_bounded_queue_rejects_typed_overloaded(pkg):
    _, sched_mod, adm_mod = PACKAGES[pkg]
    gate, entered = threading.Event(), threading.Event()

    def flush(key, payloads):
        entered.set()
        gate.wait(10)
        return list(payloads)

    adm = adm_mod.AdmissionController(max_queue_depth=2, max_inflight=64)
    sched = sched_mod.MicroBatchScheduler(flush, max_batch=2, max_delay_ms=1.0,
                                          admission=adm)
    try:
        accepted = [sched.submit("k", 0), sched.submit("k", 1)]
        assert entered.wait(10)  # the worker holds the first batch
        accepted += [sched.submit("k", 2), sched.submit("k", 3)]
        rejected = []
        for i in range(4, 8):
            with pytest.raises(adm_mod.Overloaded) as exc:
                sched.submit("k", i)
            rejected.append(exc.value.retry_after_s)
        assert len(rejected) == 4 and all(r > 0 for r in rejected)
        gate.set()
        assert sorted(f.result(timeout=10) for f in accepted) == [0, 1, 2, 3]
        wait_until(lambda: adm.stats()["inflight"] == 0)
    finally:
        gate.set()
        sched.drain()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_scheduler_deadline_sweep_drops_before_batch_assembly(pkg):
    _, sched_mod, adm_mod = PACKAGES[pkg]
    gate, entered = threading.Event(), threading.Event()
    flushed = []

    def flush(key, payloads):
        entered.set()
        gate.wait(10)
        flushed.append(list(payloads))
        return list(payloads)

    sched = sched_mod.MicroBatchScheduler(flush, max_batch=1, max_delay_ms=0.0)
    try:
        f_live = sched.submit("k", "live")
        assert entered.wait(10)
        deadline = adm_mod.Deadline.after(0.05)
        f_dead = sched.submit("k", "doomed", deadline=deadline)
        wait_until(lambda: deadline.expired)
        gate.set()
        assert f_live.result(timeout=10) == "live"
        with pytest.raises(adm_mod.DeadlineExceeded, match="queued"):
            f_dead.result(timeout=10)
        assert all("doomed" not in group for group in flushed)
        assert sched.stats()["deadline_expired"] == 1
    finally:
        gate.set()
        sched.drain()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_scheduler_drain_timeout_fails_queued_with_shutting_down(pkg):
    _, sched_mod, adm_mod = PACKAGES[pkg]
    gate, entered = threading.Event(), threading.Event()

    def flush(key, payloads):
        entered.set()
        gate.wait(30)
        return list(payloads)

    adm = adm_mod.AdmissionController(max_queue_depth=8, max_inflight=8)
    sched = sched_mod.MicroBatchScheduler(flush, max_batch=1, max_delay_ms=0.0,
                                          admission=adm)
    try:
        stuck = sched.submit("k", 1)
        assert entered.wait(10)
        queued = sched.submit("k", 2)
        assert sched.drain(timeout=0.3) is False
        with pytest.raises(adm_mod.ShuttingDown):
            queued.result(timeout=5)
        assert adm.stats()["queued"] == 0
        assert not stuck.done()
    finally:
        gate.set()
    assert stuck.result(timeout=10) == 1


# ---------------------------------------------------------------------------
# admission.py
# ---------------------------------------------------------------------------


def admission_trace(adm_mod):
    """Outcomes and stats of one op sequence on an AdmissionController."""
    adm = adm_mod.AdmissionController(max_queue_depth=2, max_inflight=3)
    out = []

    def admit(bucket):
        try:
            adm.try_admit(bucket)
            out.append(("ok", bucket))
        except adm_mod.Overloaded as exc:
            out.append(("overloaded", bucket, exc.retry_after_s))

    for bucket in ("k", "k", "k", "k2", "k3"):
        admit(bucket)
    out.append(adm.stats())
    adm.on_dequeue("k", 2)
    out.append(adm.stats())
    adm.on_done(2)
    admit("k")
    for n, seconds in ((8, 1.0), (4, 2.0), (16, 0.5)):
        adm.observe_batch(n, seconds)
        out.append(adm.retry_after_s())
    admit("z")
    adm.cancel("z")
    out.append(adm.stats())
    return out


def test_admission_controller_matches_jax_bounds_and_retry_after():
    port, ref = admission_trace(port_admission), admission_trace(jax_admission)
    assert port == ref
    assert [o[0] for o in port[:5]] == ["ok", "ok", "overloaded", "ok", "overloaded"]
    assert port[5]["rejected_queue_full"] == 1 and port[5]["rejected_inflight_full"] == 1
    assert port[7] == ("ok", "k") and all(0.1 <= r <= 60.0 for r in port[8:11])


@pytest.mark.parametrize("args", [(0, 1), (1, 0)])
def test_admission_controller_rejects_bad_bounds(args):
    with pytest.raises(ValueError):
        port_admission.AdmissionController(*args)


@pytest.mark.parametrize("inflight,rate", [(0, 0.0), (5, 0.0), (5, 10.0), (1, 100.0),
                                           (10_000, 1.0)])
def test_retry_after_estimate_equals_jax(inflight, rate):
    assert (port_admission._estimate_retry_after(inflight, rate)
            == jax_admission._estimate_retry_after(inflight, rate))


def test_deadline_expiry_and_remaining():
    dl = port_admission.Deadline.after(60.0)
    assert not dl.expired and 59.0 < dl.remaining_s() <= 60.0
    gone = port_admission.Deadline.after(-0.001)
    assert gone.expired and gone.remaining_s() == 0.0


def shedder_trace(adm_mod):
    """Mode after each step of one signal/clock script (hysteresis, the
    compile-stall and queue-depth triggers), plus the transitions."""
    sig = {"utilization": 0.0, "queue_depth": 0.0, "p99_ms": 0.0, "compile_inflight": 0.0}
    clock = {"t": 100.0}
    shed = adm_mod.LoadShedder(
        adm_mod.ShedderConfig(enter_utilization=0.9, exit_utilization=0.5,
                              min_degraded_s=2.0, enter_p99_ms=500.0, exit_p99_ms=100.0),
        signals_fn=lambda: dict(sig), now_fn=lambda: clock["t"])
    script = [({}, 0.0), ({"utilization": 0.95}, 0.0), ({"utilization": 0.1}, 1.0),
              ({"utilization": 0.7}, 5.0), ({"utilization": 0.2}, 0.0),
              ({"utilization": 0.6, "compile_inflight": 1.0}, 10.0),
              ({"utilization": 0.0}, 10.0), ({"compile_inflight": 0.0, "p99_ms": 600.0}, 1.0),
              ({"p99_ms": 200.0}, 5.0), ({"p99_ms": 50.0}, 0.0)]
    modes = []
    for update, dt in script:
        sig.update(update)
        clock["t"] += dt
        modes.append((shed.evaluate(), shed.stats()["reason"]))
    q = adm_mod.LoadShedder(adm_mod.ShedderConfig(enter_queue_depth=10, min_degraded_s=0.0),
                            signals_fn=lambda: {"utilization": 0.0, "queue_depth": 12.0},
                            now_fn=lambda: clock["t"])
    off = adm_mod.LoadShedder(adm_mod.ShedderConfig(enabled=False),
                              signals_fn=lambda: {"utilization": 1.0})
    return modes, shed.stats()["transitions"], q.evaluate(), q.stats()["reason"], off.evaluate()


def test_load_shedder_matches_jax_transitions():
    port, ref = shedder_trace(port_admission), shedder_trace(jax_admission)
    assert port == ref
    modes, transitions, q_degraded, q_reason, off = port
    assert [m for m, _ in modes] == [False, True, True, True, False, True, False, True,
                                     True, False]
    assert "compile" in modes[5][1] and "p99" in modes[7][1]
    assert transitions == 6 and q_degraded and "queue depth" in q_reason and off is False


@pytest.mark.parametrize("bad", [(0.5, 0.9), (0.9, 0.0)])
def test_shedder_config_rejects_inverted_thresholds(bad):
    enter, exit_ = bad
    with pytest.raises(ValueError):
        port_admission.ShedderConfig(enter_utilization=enter, exit_utilization=exit_)


def test_overload_signals_read_the_port_registry():
    sig = port_admission.overload_signals()
    assert set(sig) == set(jax_admission.overload_signals())
    before = sig["admission_rejected"]
    adm = port_admission.AdmissionController(max_queue_depth=1, max_inflight=1)
    adm.try_admit("k")
    with pytest.raises(port_admission.Overloaded):
        adm.try_admit("k")
    assert port_admission.overload_signals()["admission_rejected"] == before + 1


# ---------------------------------------------------------------------------
# obs/reqtrace.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cached", [False, True])
def test_request_trace_decomposition_has_the_jax_keys(cached):
    out = {}
    for name, mod in (("jax", jax_reqtrace), ("port", port_reqtrace)):
        rt = mod.RequestTrace("/predict")
        rt.mark("submit")
        rt.set_phase("queue_wait", rt.since("submit"))
        rt.set_phase("device", 0.002)
        out[name] = rt.finish(coalesced=3, cached=cached, deadline=1.5)
    assert set(out["port"]) == set(out["jax"])
    assert out["port"]["device_ms"] == 2.0 and out["port"]["deadline_ms"] == 1500.0
    assert out["port"]["coalesced"] == 3 and out["port"]["cached"] is cached
    assert len(out["port"]["trace_id"]) == 16 == len(port_reqtrace.mint_trace_id())


def test_request_trace_records_its_histograms_once():
    hist = port_metrics.histogram("di_request_device_seconds", labelnames=("route",))
    before = hist.count(route="/unit")
    rt = port_reqtrace.RequestTrace("/unit")
    rt.finish()
    rt.finish()  # idempotent
    assert hist.count(route="/unit") == before + 1
