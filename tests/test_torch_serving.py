"""The port's InferenceEngine against the JAX package's, and its own
behaviour (mirroring tests/test_serving.py's engine cases).

One JAX engine and one port engine for the module, from one tiny config
(``torch_port_helpers``: hidden 16, 2 heads, decoder of 2 chunks, the JAX
side with ``depad_stats=False``); the JAX engine's params and batch
statistics are carried into the port with ``weights.load_jax_variables``.
The port's engine runs on the CPU (``device="cpu"``), where each dispatch
is the eager forward through the plain attention; its CUDA graph entry
(``serving/graphs.py``) is held against the eager forward by the
``cuda``-marked test at the end, which skips without a card (``chip_smoke.py``
phase 9 gives its verdict on the card).

Waits are event-driven or polls: no fixed sleep exceeds the engines'
``max_delay_ms``."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from deepinteract_tpu.serving import EngineConfig as JaxEngineConfig
from deepinteract_tpu.serving import InferenceEngine as JaxInferenceEngine
from deepinteract_tpu_torch.data.synthetic import random_raw_complex
from deepinteract_tpu_torch.obs import metrics as port_metrics
from deepinteract_tpu_torch.obs.reqtrace import RequestTrace
from deepinteract_tpu_torch.robustness import faults
from deepinteract_tpu_torch.serving import (BatchExecutionError, Deadline, DeadlineExceeded,
                                            EngineConfig, InferenceEngine, Overloaded)
from deepinteract_tpu_torch.serving.engine import batch_slots
from torch_port_helpers import jax_cfg, port_cfg, wait_until

KNN = 6
MAX_BATCH, MAX_DELAY_MS = 4, 25.0
BAR = 1e-4  # f32 probabilities, the port's logit bar


def fresh_raw(seed, n1=26, n2=22):
    return random_raw_complex(n1, n2, np.random.default_rng(seed), knn=KNN)


@pytest.fixture(scope="module")
def engines():
    jeng = JaxInferenceEngine(jax_cfg(), cfg=JaxEngineConfig(
        max_batch=MAX_BATCH, max_delay_ms=MAX_DELAY_MS, result_cache_size=64))
    peng = InferenceEngine(
        port_cfg(), cfg=EngineConfig(max_batch=MAX_BATCH, max_delay_ms=MAX_DELAY_MS,
                                     result_cache_size=64),
        device="cpu", weights={"params": jeng.params, "batch_stats": jeng.batch_stats})
    yield jeng, peng
    jeng.close()
    peng.close()


@pytest.fixture(scope="module")
def engine(engines):
    return engines[1]


# ---------------------------------------------------------------------------
# Parity with the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n1,n2", [(10, 26, 22), (11, 30, 18), (12, 64, 40)])
def test_single_requests_match_the_jax_engine(engines, seed, n1, n2):
    jeng, peng = engines
    raw = fresh_raw(seed, n1, n2)
    ref, got = jeng.predict(raw), peng.predict(raw)
    assert got["bucket"] == ref["bucket"] and got["probs"].shape == (n1, n2)
    assert not got["cached"] and got["batch_slots"] == ref["batch_slots"] == 1
    np.testing.assert_allclose(got["probs"], ref["probs"], rtol=0, atol=BAR)


def test_coalesced_group_of_three_matches_the_jax_engine(engines):
    """Three concurrent submits share one dispatch padded to four slots in
    both packages, and every slot holds its own complex's map."""
    jeng, peng = engines
    raws = [fresh_raw(20 + i, 24 + i, 20 + i) for i in range(3)]
    outs = {}
    for name, eng in (("jax", jeng), ("port", peng)):
        outs[name] = [f.result(timeout=120) for f in [eng.submit(r) for r in raws]]
        assert all(r["coalesced"] == 3 and r["batch_slots"] == 4 for r in outs[name])
    for got, ref in zip(outs["port"], outs["jax"]):
        np.testing.assert_allclose(got["probs"], ref["probs"], rtol=0, atol=BAR)
    assert len({r["probs"].tobytes() for r in outs["port"]}) == 3


@pytest.mark.parametrize("n1,n2", [(20, 16), (64, 64), (65, 30), (100, 200), (192, 193),
                                   (256, 256), (300, 40), (600, 300), (257, 257)])
def test_bucket_for_equals_jax_including_the_over_bucket_lift(engines, n1, n2):
    jeng, peng = engines
    assert peng.bucket_for(n1, n2) == jeng.bucket_for(n1, n2)


@pytest.mark.parametrize("max_batch", [1, 4, 8])
def test_batch_slots_equal_jax_policy(max_batch):
    from deepinteract_tpu.serving.fleet import batch_slots as jax_batch_slots

    for n in range(1, 12):
        assert batch_slots(n, max_batch) == jax_batch_slots(n, max_batch)


@pytest.mark.parametrize("spec", [(128, 128, 6), (300, 300, 2), (64, 64, 99), (20, 16, 3),
                                  (600, 450, 1)])
def test_normalize_warmup_equals_jax(engines, spec):
    jeng, peng = engines
    assert peng.normalize_warmup(*spec) == jeng.normalize_warmup(*spec)


@pytest.mark.parametrize("key", [
    (64, 64, (6, 2, 113, 28), (6, 2, 113, 28), 1),
    (768, 512, (20, 2, 113, 28), (20, 2, 113, 28), 4),
    (64, 128, (6, 2, 113, 28), (4, 2, 113, 28), 2)])
def test_inventory_labels_equal_jax(key):
    assert InferenceEngine._key_label(key) == JaxInferenceEngine._key_label(key)


def test_compiled_bucket_labels_equal_jax_after_the_same_warmup(engines):
    jeng, peng = engines
    specs = [(64, 64, 1), (64, 64, 3)]
    jeng.warmup(specs, knn=KNN, geo=2)
    peng.warmup(specs, knn=KNN, geo=2)
    jlabels = set(jeng.stats()["compiled_buckets"])
    plabels = set(peng.stats()["compiled_buckets"])
    assert {"64x64/b1/k6g2", "64x64/b4/k6g2"} <= plabels
    assert plabels == jlabels
    assert peng.warm_bucket_labels() == sorted(plabels)


# ---------------------------------------------------------------------------
# Engine behaviour
# ---------------------------------------------------------------------------


def test_warm_key_makes_no_new_entry(engine):
    engine.predict(fresh_raw(30))
    s1 = engine.stats()
    out = engine.predict(fresh_raw(31))  # other content, same key
    s2 = engine.stats()
    assert out["bucket"] == (64, 64) and not out["cached"]
    assert s2["capture_count"] == s1["capture_count"]
    assert s2["num_compiled_executables"] == s1["num_compiled_executables"]
    assert s2["executed_requests"] == s1["executed_requests"] + 1
    assert np.all(out["probs"] >= 0) and np.all(out["probs"] <= 1)


def test_cache_hit_does_no_device_work_and_gives_an_identical_map(engine):
    raw = fresh_raw(40)
    first = engine.predict(raw)
    executed = engine.stats()["executed_requests"]
    hits = engine.cache.stats()["hits"]
    second = engine.predict(raw)
    assert second["cached"] and not first["cached"]
    np.testing.assert_array_equal(first["probs"], second["probs"])
    assert engine.stats()["executed_requests"] == executed
    assert engine.cache.stats()["hits"] == hits + 1
    with pytest.raises(ValueError):
        second["probs"][0, 0] = 0.5  # read-only: shared with the cache


def test_concurrent_submits_coalesce_into_one_dispatch(engine):
    raws = [fresh_raw(100 + i) for i in range(MAX_BATCH)]
    flushes = engine.stats()["scheduler"]["flushes"]
    results = [f.result(timeout=120) for f in [engine.submit(r) for r in raws]]
    assert all(r["coalesced"] == MAX_BATCH for r in results)
    assert engine.stats()["scheduler"]["flushes"] == flushes + 1
    assert len({r["probs"].tobytes() for r in results}) == MAX_BATCH


def test_shape_signature_covers_both_graphs(engine):
    raw = fresh_raw(600)
    sym = engine._shape_signature(raw)
    assert sym[0] == sym[1] == (KNN, 2, 113, 28)
    asym = copy.deepcopy(raw)
    g2 = asym["graph2"]
    for name in ("nbr_idx", "edge_feats", "src_nbr_eids", "dst_nbr_eids"):
        g2[name] = g2[name][:, : KNN - 2]
    assert engine._shape_signature(asym) != sym
    assert engine._shape_signature(asym)[0] == sym[0]


def test_traced_request_and_cache_hit_decompositions(engine):
    raw = fresh_raw(480)
    first = engine.predict(raw, reqtrace=RequestTrace("/predict"))
    assert not first["trace"]["cached"] and first["trace"]["device_ms"] > 0
    hit = engine.predict(raw, reqtrace=RequestTrace("/predict"))
    assert hit["cached"] and hit["trace"]["cached"] and hit["trace"]["device_ms"] == 0.0
    assert hit["trace"]["trace_id"] != first["trace"]["trace_id"]
    assert "trace" not in engine.predict(fresh_raw(481))


def test_expired_deadline_never_reaches_dispatch(engine):
    expired = port_metrics.counter("di_admission_deadline_expired_total",
                                   labelnames=("where",))
    before = expired.value(where="admission")
    with pytest.raises(DeadlineExceeded, match="admission"):
        engine.submit(fresh_raw(700), deadline=Deadline.after(-0.01))
    assert expired.value(where="admission") == before + 1

    # Expiry while queued: the worker is held at the exec lock with a live
    # request, a short-deadline request queues behind it and expires.
    executed = engine.stats()["executed_requests"]
    before_queue = expired.value(where="queue")
    engine._exec_lock.acquire()
    try:
        f_live = engine.submit(fresh_raw(701))
        wait_until(lambda: engine.scheduler.stats()["queue_depth"] == 0)
        deadline = Deadline.after(0.08)
        f_dead = engine.submit(fresh_raw(702), reqtrace=RequestTrace("/predict"),
                               deadline=deadline)
        wait_until(lambda: deadline.expired)
    finally:
        engine._exec_lock.release()
    assert f_live.result(timeout=120)["probs"].shape == (26, 22)
    with pytest.raises(DeadlineExceeded) as exc:
        f_dead.result(timeout=30)
    trace = exc.value.trace
    assert trace is not None and trace["device_ms"] == 0.0
    assert trace["deadline_ms"] == pytest.approx(80.0) and trace["queue_wait_ms"] > 0
    assert expired.value(where="queue") == before_queue + 1
    assert engine.stats()["executed_requests"] == executed + 1
    ok = engine.predict(fresh_raw(703), reqtrace=RequestTrace("/predict"),
                        deadline=Deadline.after(60.0))
    assert ok["trace"]["deadline_ms"] == pytest.approx(60_000.0)
    assert 0 < ok["trace"]["deadline_remaining_ms"] <= 60_000.0


def test_bounded_queue_raises_overloaded_with_retry_after(engine):
    adm = engine.admission
    saved = adm.max_queue_depth
    accepted, rejects = [], []
    engine._exec_lock.acquire()
    try:
        adm.max_queue_depth = 2
        accepted.append(engine.submit(fresh_raw(710)))
        wait_until(lambda: engine.scheduler.stats()["queue_depth"] == 0)
        for i in range(5):
            try:
                accepted.append(engine.submit(fresh_raw(711 + i)))
            except Overloaded as exc:
                rejects.append(exc)
    finally:
        adm.max_queue_depth = saved
        engine._exec_lock.release()
    assert len(rejects) == 3 and all(r.retry_after_s > 0 for r in rejects)
    for fut in accepted:
        assert fut.result(timeout=120)["probs"].shape == (26, 22)
    wait_until(lambda: engine.stats()["admission"]["inflight"] == 0)
    assert engine.stats()["admission"]["rejected_queue_full"] >= 3


@pytest.mark.parametrize("site,stage", [("serving.dispatch", "dispatch"),
                                        ("serving.assembly", "assembly")])
def test_batch_fault_sites_fail_only_their_batch(engine, site, stage):
    failures = port_metrics.counter("di_serving_batch_failures_total")
    before = failures.value()
    seed = 760 if stage == "dispatch" else 770  # fresh content: no cache hit
    faults.configure({site: [1]})
    try:
        with pytest.raises(BatchExecutionError) as exc:
            engine.predict(fresh_raw(seed))
        assert exc.value.stage == stage
        assert failures.value() == before + 1
        assert engine.predict(fresh_raw(seed + 1))["probs"].shape == (26, 22)
    finally:
        faults.reset()


def test_admission_fault_site_is_a_typed_overloaded(engine):
    faults.configure({"serving.admission": [1]})
    try:
        with pytest.raises(Overloaded) as exc:
            engine.predict(fresh_raw(771))
        assert exc.value.retry_after_s > 0
    finally:
        faults.reset()
    assert engine.predict(fresh_raw(772))["probs"].shape == (26, 22)


def test_weights_signature_names_the_carried_tree(engine):
    sig = engine.weights_signature()
    assert sig.startswith("jax-variables:") and sig == engine.stats()["restored_from"]


def test_engine_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the refusal needs one without")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(port_cfg())


@pytest.mark.parametrize("changes,names", [
    ({"gnn_layer_type": "gcn"}, ("GCN encoder",)),
    ({"interact_module_type": "deeplab"}, ("DeepLab decoder",)),
    ({"gnn_layer_type": "gcn", "interact_module_type": "deeplab"},
     ("GCN encoder", "DeepLab decoder")),
])
def test_engine_refuses_what_does_not_capture_on_cuda(changes, names):
    """Every configuration captures since the GCN and DeepLab forwards stopped
    reading the host (ROADMAP.md F5, closed): on a machine without a GPU
    each gets the flagship's "no CUDA device" refusal, and nothing names F5."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the refusal needs one without")
    cfg = dataclasses.replace(port_cfg(), **changes)
    assert all(name.split()[0].lower() in (cfg.gnn_layer_type, cfg.interact_module_type)
               for name in names)
    with pytest.raises(RuntimeError, match="no CUDA device") as err:
        InferenceEngine(cfg, device="cuda")
    assert "F5" not in str(err.value)


# ---------------------------------------------------------------------------
# The CUDA graph entry (card only)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_graph_entry_replay_equals_the_eager_forward():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs need a card; chip_smoke.py phase 9 holds the entry there")
    from deepinteract_tpu_torch.data.graph import stack_complexes
    from deepinteract_tpu_torch.data.io import to_paired_complex
    from deepinteract_tpu_torch.cli.predict import load_model
    from deepinteract_tpu_torch.serving.graphs import GraphEntry, serve_forward

    model = load_model(port_cfg(), torch.device("cuda"), seed=0)
    batches = [stack_complexes([to_paired_complex(fresh_raw(s), 64, 64)]) for s in (1, 2)]
    entry = GraphEntry(model, (batches[0].graph1, batches[0].graph2),
                       torch.cuda.graph_pool_handle())
    assert (entry.k1_launches, entry.k2_launches, entry.csr_builds) == (4, 0, 2)
    for b in batches:
        got = entry.replay(b.graph1, b.graph2).clone()
        with torch.inference_mode():
            ref = serve_forward(model, b.graph1.to("cuda"), b.graph2.to("cuda"))
        assert torch.equal(got, ref)
    assert entry.replays == 2
