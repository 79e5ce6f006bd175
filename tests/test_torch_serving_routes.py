"""The port's split-phase HTTP routes (``POST /screen``, the indexed screen,
``POST /assembly``) against the JAX server's ``run_screen`` /
``run_assembly`` on the same ``.npz`` files and carried weights; their 400
and 504 cases, the ``/stats`` screening block, the ``/healthz`` fields the
fleet reads; and F6, the seeded ``weights_signature`` that names its
package.

One JAX engine and one port engine for the module (the tiny config of
``torch_port_helpers``, the JAX side with ``depad_stats=False``; the JAX
weights carried into the port, and the JAX engine told the port's
signature, as one checkpoint served by both packages would be). The index
is built by the JAX package and read by the port; the calibration is one
artifact read by both. The port's server listens on port 0."""

import http.client
import json
import os
import types

import numpy as np
import pytest

from deepinteract_tpu.calibration import Calibrator as JaxCalibrator
from deepinteract_tpu.calibration import save_calibration as jax_save_calibration
from deepinteract_tpu.index import build_index as jax_build_index
from deepinteract_tpu.screening import ChainLibrary as JaxChainLibrary
from deepinteract_tpu.screening import EmbeddingCache as JaxEmbeddingCache
from deepinteract_tpu.screening import ScreenConfig as JaxScreenConfig
from deepinteract_tpu.screening import ScreenRunner as JaxScreenRunner
from deepinteract_tpu.screening import pair_summary as jax_pair_summary
from deepinteract_tpu.serving import EngineConfig as JaxEngineConfig
from deepinteract_tpu.serving import InferenceEngine as JaxInferenceEngine
from deepinteract_tpu.serving import ServingServer as JaxServingServer
from deepinteract_tpu_torch.calibration import Calibrator, load_calibration, save_calibration
from deepinteract_tpu_torch.data.io import save_complex_npz
from deepinteract_tpu_torch.data.synthetic import random_raw_complex
from deepinteract_tpu_torch.index import ChainIndex, IndexedQueryRunner
from deepinteract_tpu_torch.robustness import artifacts
from deepinteract_tpu_torch.screening import ChainLibrary, EmbeddingCache, ScreenRunner
from deepinteract_tpu_torch.serving import EngineConfig, InferenceEngine, ServingServer
from torch_port_helpers import jax_cfg, port_cfg

KNN = 6
BAR = 1e-4  # f32 scores: the port's logit bar
RANK_GAP = 2e-4  # neighbouring scores further apart than this rank the same
CAL_BAR = 1e-6  # the two packages' calibration maps on the same inputs
TEMPERATURE = 2.0
LENGTHS = ((24, 30), (36, 22), (28, 40))  # three complexes: six chains, 15 pairs


@pytest.fixture(scope="module")
def engines():
    jeng = JaxInferenceEngine(jax_cfg(), cfg=JaxEngineConfig(max_batch=8, result_cache_size=0))
    peng = InferenceEngine(port_cfg(), cfg=EngineConfig(max_batch=8, result_cache_size=0),
                           device="cpu",
                           weights={"params": jeng.params, "batch_stats": jeng.batch_stats})
    # The same carried weights under one identity in both packages.
    jeng.restored_from = peng.weights_signature()
    yield jeng, peng
    jeng.close()
    peng.close()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("complexes")
    paths = []
    for i, (n1, n2) in enumerate(LENGTHS):
        raw = random_raw_complex(n1, n2, np.random.default_rng(70 + i), knn=KNN)
        path = str(root / f"cx{i}.npz")
        save_complex_npz(path, raw["graph1"], raw["graph2"], raw["examples"], f"cx{i}")
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def calibration(engines, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cal") / "calibration.json")
    save_calibration(path, Calibrator(method="temperature", temperature=TEMPERATURE,
                                      weights_signature=engines[1].weights_signature()))
    return path


@pytest.fixture(scope="module")
def jax_index(engines, files, tmp_path_factory):
    """The library indexed by the JAX package, under the carried signature."""
    index_dir = str(tmp_path_factory.mktemp("jidx") / "index")
    jax_build_index(engines[0], JaxChainLibrary.from_complex_files(files), index_dir,
                    partition_size=4, encode_batch=4, cache=JaxEmbeddingCache())
    return index_dir


@pytest.fixture(scope="module")
def jax_server(engines, calibration, jax_index):
    srv = JaxServingServer(engines[0], port=0, calibration_path=calibration,
                           index_path=jax_index)
    yield srv
    srv.httpd.server_close()


@pytest.fixture(scope="module")
def server(engines, calibration, jax_index):
    srv = ServingServer(engines[1], port=0, calibration_path=calibration,
                        index_path=jax_index)
    srv.serve_background()
    yield srv
    srv.httpd.shutdown()
    srv.httpd.server_close()


def request(srv, method, path, payload=None, headers=None, timeout=120):
    host, port = srv.address
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        body = None if payload is None else json.dumps(payload).encode()
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, (data.decode() if path == "/metrics" else json.loads(data))
    finally:
        conn.close()


def assert_rankings_agree(got, ref, calibrated=False, maps=None):
    """Scores within BAR per pair, and the same order wherever neighbouring
    JAX scores differ by more than RANK_GAP. With ``calibrated``, the
    port's calibrated fields equal the JAX calibration map applied to the
    port's own raw values within CAL_BAR (a screen's rounded top-k
    probabilities, or an assembly's whole ``maps``) and JAX's fields within
    BAR."""
    assert [r["pair_id"] for r in got] and len(got) == len(ref)
    by_id = {r["pair_id"]: r for r in got}
    assert set(by_id) == {r["pair_id"] for r in ref}
    rank = {r["pair_id"]: i for i, r in enumerate(got)}
    for i, want in enumerate(ref):
        rec = by_id[want["pair_id"]]
        assert (rec["chain1"], rec["chain2"]) == (want["chain1"], want["chain2"])
        assert abs(rec["score"] - want["score"]) <= BAR, want["pair_id"]
        for later in ref[i + 1:]:
            if want["score"] - later["score"] > RANK_GAP:
                assert rank[want["pair_id"]] < rank[later["pair_id"]]
    if not calibrated:
        return
    jax_cal = JaxCalibrator(method="temperature", temperature=TEMPERATURE)
    for want in ref:
        rec = by_id[want["pair_id"]]
        if maps is None:
            ps = np.asarray([c["p"] for c in rec["top_contacts"]])
            expect = float(np.mean(jax_cal.apply(ps)))
            for c in rec["top_contacts"]:
                assert abs(c["p_cal"] - float(jax_cal.apply(np.asarray(c["p"])))) <= CAL_BAR
        else:
            expect = jax_pair_summary(jax_cal.apply(np.asarray(maps[rec["pair_id"]])),
                                      rec["top_k"])["score"]
        assert abs(rec["calibrated_score"] - expect) <= CAL_BAR
        assert abs(rec["calibrated_score"] - want["calibrated_score"]) <= BAR


def test_screen_route_matches_the_jax_server(server, jax_server, files, calibration):
    payload = {"npz_paths": files, "top_k": 5}
    status, out = request(server, "POST", "/screen?trace=1", payload)
    ref = jax_server.run_screen(dict(payload))
    assert status == 200, out
    assert out["pairs"] == ref["pairs"] == 15 and out["chains"] == ref["chains"] == 6
    assert out["calibration"] == calibration and out["trace"]["trace_id"] == out["trace_id"]
    assert_rankings_agree(out["ranked"], ref["ranked"], calibrated=True)


def test_screen_route_query_subset(server, jax_server, files):
    chains = ChainLibrary.from_complex_files(files).ids()
    payload = {"npz_paths": files, "query": chains[:2], "top_k": 3}
    status, out = request(server, "POST", "/screen", payload)
    assert status == 200
    ref = jax_server.run_screen(dict(payload))
    assert out["pairs"] == ref["pairs"] < 15
    assert_rankings_agree(out["ranked"], ref["ranked"])


def test_assembly_route_matches_the_jax_server(server, jax_server, files, calibration):
    chains = ChainLibrary.from_complex_files(files).ids()[:4]
    payload = {"npz_paths": files, "chains": chains, "top_k": 5, "maps": True,
               "edge_threshold": 0.0}
    status, out = request(server, "POST", "/assembly", payload)
    ref = jax_server.run_assembly(dict(payload))
    assert status == 200, out
    assert out["pairs_scored"] == ref["pairs_scored"] == 6
    assert out["weights_signature"] == ref["weights_signature"]
    assert out["calibration"] == calibration and out["calibrated"]
    assert_rankings_agree(out["ranked"], ref["ranked"], calibrated=True, maps=out["maps"])
    assert sorted(out["interface"]["nodes"]) == sorted(ref["interface"]["nodes"])
    assert len(out["interface"]["edges"]) == len(ref["interface"]["edges"]) == 6
    for pid, m in ref["maps"].items():
        np.testing.assert_allclose(out["maps"][pid], m, rtol=0, atol=BAR)


def test_indexed_screen_reads_the_jax_index(server, jax_server, files, engines):
    query = ChainLibrary.from_complex_files(files).ids()[0]
    payload = {"indexed": True, "query": query, "top_m": 4, "top_k": 5}
    status, out = request(server, "POST", "/screen", payload)
    ref = jax_server.run_screen(dict(payload))
    assert status == 200, out
    assert out["indexed"] and not out["partial"]
    assert out["candidates"] == ref["candidates"] == 5
    assert out["partitions_served"] == ref["partitions_served"]
    assert out["weights_signature"] == engines[1].weights_signature()
    assert_rankings_agree(out["ranked"], ref["ranked"])
    # The same query through a payload index_path and a list-valued query.
    status, again = request(server, "POST", "/screen",
                            {"index_path": server.index_path, "query": [query], "top_m": 4})
    assert status == 200 and [r["pair_id"] for r in again["ranked"]] == [
        r["pair_id"] for r in out["ranked"]]


def test_oversize_screens_answer_400_indexed_exempt(engines, files, jax_index):
    srv = ServingServer(engines[1], port=0, screen_max_pairs=2, index_path=jax_index)
    srv.serve_background()
    try:
        rejected = srv.screening_stats()["requests_rejected"]
        status, out = request(srv, "POST", "/screen", {"npz_paths": files})
        assert status == 400 and "exceeds the synchronous limit (2)" in out["error"]
        chains = ChainLibrary.from_complex_files(files).ids()[:3]
        status, out = request(srv, "POST", "/assembly", {"npz_paths": files, "chains": chains})
        assert status == 400 and "over the synchronous limit" in out["error"]
        # An indexed screen decodes top_m survivors of any library: exempt.
        status, out = request(srv, "POST", "/screen",
                              {"indexed": True, "query": chains[0], "top_m": 4})
        assert status == 200 and out["pairs_decoded"] == 4
        for bad in ({}, {"npz_paths": "x.npz"}, {"npz_paths": files, "query": ["nope:g9"]},
                    {"indexed": True}, {"index_path": "/nonexistent/index", "query": "q"}):
            assert request(srv, "POST", "/screen", bad)[0] == 400, bad
        assert srv.screening_stats()["requests_rejected"] == rejected + 6
        assert request(srv, "POST", "/assembly", {"npz_paths": []})[0] == 400
    finally:
        srv.httpd.shutdown()
        srv.httpd.server_close()


def test_deadlines_504_and_indexed_partial_flush(server, files, tmp_path):
    # Fresh chains: nothing cached, so the first encode batch checks it.
    paths = []
    for i in range(2):
        raw = random_raw_complex(26, 30, np.random.default_rng(500 + i), knn=KNN)
        paths.append(str(tmp_path / f"d{i}.npz"))
        save_complex_npz(paths[-1], raw["graph1"], raw["graph2"], raw["examples"], f"d{i}")
    hdr = {"X-Request-Deadline-Ms": "0.001"}  # expired at the first batch boundary
    status, out = request(server, "POST", "/screen", {"npz_paths": paths}, headers=hdr)
    assert status == 504 and "deadline" in out["error"] and out["trace_id"]
    status, out = request(server, "POST", "/assembly", {"npz_paths": paths, "deadline_s": 1e-6})
    assert status == 504
    # The indexed screen flushes what it ranked so far instead.
    query = ChainLibrary.from_complex_files(files).ids()[1]
    status, out = request(server, "POST", "/screen",
                          {"indexed": True, "query": query, "top_m": 4}, headers=hdr)
    assert status == 200 and out["partial"] is True
    assert out["pairs_decoded"] < 4
    assert request(server, "POST", "/screen", {"npz_paths": paths},
                   headers={"X-Request-Deadline-Ms": "0"})[0] == 400


def test_stats_screening_block_metrics_and_healthz(server, files):
    status, out = request(server, "POST", "/screen", {"npz_paths": files[:1]})
    assert status == 200
    status, stats = request(server, "GET", "/stats")
    block = stats["screening"]
    assert block["requests"] >= 1 and block["emb_cache_entries"] >= 2
    assert 0.0 < block["emb_cache_hit_rate"] <= 1.0
    status, text = request(server, "GET", "/metrics")
    assert 'di_serving_requests_total{endpoint="/screen",status="200"}' in text
    assert 'di_serving_requests_total{endpoint="/assembly",status="200"}' in text
    assert f"di_serving_screen_emb_cache_entries {block['emb_cache_entries']}" in text
    status, health = request(server, "GET", "/healthz")
    assert health["status"] == "ok" and health["mesh_shape"] == "1x1"
    assert health["inflight"] == 0
    assert health["weights_signature"] == server.engine.weights_signature()


# ---------------------------------------------------------------------------
# F6: the seeded weights_signature names its package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def seeded_engine():
    return InferenceEngine(port_cfg(), cfg=EngineConfig(max_batch=8, result_cache_size=0),
                           device="cpu", seed=42)


def test_seeded_signatures_differ_between_the_packages(seeded_engine):
    jax_sig = JaxInferenceEngine.weights_signature(
        types.SimpleNamespace(restored_from=None, _seed=42))
    assert jax_sig == "init-seed42"
    assert seeded_engine.weights_signature() == "torch-init-seed42" != jax_sig


def test_jax_seeded_calibration_refused_carried_accepted(seeded_engine, engines, tmp_path):
    stale = str(tmp_path / "jax_seeded.json")
    jax_save_calibration(stale, JaxCalibrator(method="temperature", temperature=TEMPERATURE,
                                              weights_signature="init-seed42"))
    with pytest.raises(artifacts.StaleArtifact):
        load_calibration(stale, expect_signature=seeded_engine.weights_signature())
    with pytest.raises(artifacts.StaleArtifact):
        ServingServer(seeded_engine, port=0, calibration_path=stale)
    carried = str(tmp_path / "jax_carried.json")
    jax_save_calibration(carried, JaxCalibrator(
        method="temperature", temperature=TEMPERATURE,
        weights_signature=engines[0].weights_signature()))
    srv = ServingServer(engines[1], port=0, calibration_path=carried)
    srv.httpd.server_close()
    assert srv.calibrator.temperature == TEMPERATURE


def test_jax_seeded_spill_is_a_miss_carried_spill_a_hit(seeded_engine, engines, files,
                                                        tmp_path):
    jeng, peng = engines
    jlib = JaxChainLibrary.from_complex_files(files[:1])
    lib = ChainLibrary.from_complex_files(files[:1])
    seeded_dir, carried_dir = str(tmp_path / "seeded"), str(tmp_path / "carried")
    carried_sig = jeng.restored_from
    jeng.restored_from = None  # the JAX engine's own seeded identity
    try:
        assert jeng.weights_signature() == "init-seed42"
        JaxScreenRunner(jeng, cache=JaxEmbeddingCache(capacity=0, spill_dir=seeded_dir),
                        cfg=JaxScreenConfig(encode_batch=2)).ensure_embeddings(
            jlib, jlib.ids())
    finally:
        jeng.restored_from = carried_sig
    JaxScreenRunner(jeng, cache=JaxEmbeddingCache(capacity=0, spill_dir=carried_dir),
                    cfg=JaxScreenConfig(encode_batch=2)).ensure_embeddings(jlib, jlib.ids())
    assert len(os.listdir(seeded_dir)) == len(os.listdir(carried_dir)) == 4  # 2 + sidecars

    cache = EmbeddingCache(spill_dir=seeded_dir)
    _, executed, _, _ = ScreenRunner(seeded_engine, cache=cache).ensure_embeddings(
        lib, lib.ids())
    assert executed == 2 and cache.stats()["spill_hits"] == 0  # refused: re-encoded
    cache = EmbeddingCache(spill_dir=carried_dir)
    emb, executed, _, _ = ScreenRunner(peng, cache=cache).ensure_embeddings(lib, lib.ids())
    assert executed == 0 and cache.stats()["spill_hits"] == 2
    fresh, _, _, _ = ScreenRunner(peng, cache=EmbeddingCache()).ensure_embeddings(
        lib, lib.ids())
    for cid in lib.ids():
        np.testing.assert_allclose(emb[cid][0], fresh[cid][0], rtol=0, atol=BAR)


def test_jax_seeded_index_refused_as_stale(seeded_engine, engines, files, tmp_path):
    jeng = engines[0]
    index_dir = str(tmp_path / "seeded_index")
    carried_sig = jeng.restored_from
    jeng.restored_from = None  # the JAX engine's own seeded identity
    try:
        jax_build_index(jeng, JaxChainLibrary.from_complex_files(files[:1]), index_dir,
                        partition_size=4, encode_batch=2, cache=JaxEmbeddingCache())
    finally:
        jeng.restored_from = carried_sig
    index = ChainIndex.open(index_dir)
    assert index.weights_signature == "init-seed42"
    with pytest.raises(ValueError, match="stale index"):
        IndexedQueryRunner(seeded_engine, index)
    srv = ServingServer(seeded_engine, port=0)
    srv.httpd.server_close()
    with pytest.raises(ValueError, match="stale index"):
        srv.run_screen({"index_path": index_dir, "query": index.chain_ids()[0]})
