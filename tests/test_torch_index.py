"""The port's proteome index (``deepinteract_tpu_torch.index``) against the
JAX package's, mirroring tests/test_index.py: the format round trip, the
exactly-once build resume, corrupt-shard quarantine, merge, the pre-filter
funnel's agreement with a full screen, and the ``index`` and ``query``
CLIs with their contracts. An index built by either package is read,
verified and queried by the other.

One JAX engine and one port engine for the module (the tiny config of
``torch_port_helpers``, the JAX weights carried into the port); the port
runs on the CPU, eagerly through the plain attention. One shared build of
each package's index; tests that damage shards copy the tree first.
"""

import os
import shutil

import numpy as np
import pytest

from deepinteract_tpu.index import ChainIndex as JaxChainIndex
from deepinteract_tpu.index import build_index as jax_build_index
from deepinteract_tpu.index import pooled_embedding as jax_pooled_embedding
from deepinteract_tpu.index import prefilter as jax_prefilter
from deepinteract_tpu.index import verify_index as jax_verify_index
from deepinteract_tpu.screening import ChainLibrary as JaxChainLibrary
from deepinteract_tpu.screening import EmbeddingCache as JaxEmbeddingCache
from deepinteract_tpu.serving import EngineConfig as JaxEngineConfig
from deepinteract_tpu.serving import InferenceEngine as JaxInferenceEngine
from deepinteract_tpu_torch.index import (ChainIndex, IndexedQueryRunner, QueryConfig,
                                          bilinear_scores, build_index, merge_indexes,
                                          plan_partitions, pooled_embedding, prefilter,
                                          verify_index)
from deepinteract_tpu_torch.index import format as idx_format
from deepinteract_tpu_torch.robustness import artifacts
from deepinteract_tpu_torch.robustness.preemption import PreemptionGuard
from deepinteract_tpu_torch.screening import (ChainLibrary, EmbeddingCache, ScreenConfig,
                                              ScreenRunner, enumerate_pairs)
from deepinteract_tpu_torch.screening.library import ChainEntry
from deepinteract_tpu_torch.serving import EngineConfig, InferenceEngine
from torch_port_helpers import jax_cfg, port_cfg

KNN, GEO = 6, 2
PART = 4  # partition_size used everywhere here: several shards per bucket
TINY_CLI_ARGS = ["--num_gnn_layers", "1", "--num_gnn_hidden_channels", "16",
                 "--num_gnn_attention_heads", "2", "--num_interact_layers", "1",
                 "--num_interact_hidden_channels", "8", "--dropout_rate", "0.0",
                 "--device", "cpu"]


@pytest.fixture(scope="module")
def engines():
    jeng = JaxInferenceEngine(jax_cfg(), cfg=JaxEngineConfig(max_batch=8, result_cache_size=0))
    peng = InferenceEngine(port_cfg(), cfg=EngineConfig(max_batch=8, result_cache_size=0),
                           device="cpu",
                           weights={"params": jeng.params, "batch_stats": jeng.batch_stats})
    yield jeng, peng
    jeng.close()
    peng.close()


@pytest.fixture(scope="module")
def engine(engines):
    return engines[1]


@pytest.fixture(scope="module")
def library():
    return ChainLibrary.synthetic(10, 20, 40, seed=3, knn=KNN, geo_nbrhd_size=GEO)


@pytest.fixture(scope="module")
def built_index(engine, library, tmp_path_factory):
    index_dir = str(tmp_path_factory.mktemp("idx") / "index")
    result = build_index(engine, library, index_dir, partition_size=PART, encode_batch=4,
                         cache=EmbeddingCache())
    return index_dir, result


@pytest.fixture(scope="module")
def jax_built_index(engines, tmp_path_factory):
    """The same library indexed by the JAX package (its weights signature is
    the JAX engine's own)."""
    jlib = JaxChainLibrary.synthetic(10, 20, 40, seed=3, knn=KNN, geo_nbrhd_size=GEO)
    index_dir = str(tmp_path_factory.mktemp("jidx") / "index")
    jax_build_index(engines[0], jlib, index_dir, partition_size=PART, encode_batch=4,
                    cache=JaxEmbeddingCache())
    return index_dir


# ---------------------------------------------------------------------------
# Format + build round trip
# ---------------------------------------------------------------------------


def test_plan_partitions_deterministic_and_bucket_homogeneous(engines, library):
    from deepinteract_tpu.index import plan_partitions as jax_plan_partitions

    jeng, engine = engines
    plan = plan_partitions(engine, library, PART)
    assert plan == plan_partitions(engine, library, PART)
    assert plan == jax_plan_partitions(jeng, library, PART)
    assert sum(len(cids) for _, _, cids in plan) == len(library)
    assert len({pid for pid, _, _ in plan}) == len(plan)
    for pid, bucket, cids in plan:
        assert 1 <= len(cids) <= PART
        assert all(engine.chain_bucket(library[c].n) == bucket for c in cids)
        assert pid == idx_format.partition_id(bucket, int(pid.rsplit("-", 1)[1]))
    with pytest.raises(ValueError, match="partition_size"):
        plan_partitions(engine, library, 0)


def test_build_verify_round_trip(engine, library, built_index):
    index_dir, result = built_index
    plan = plan_partitions(engine, library, PART)
    assert result.partitions_total == result.partitions_built == len(plan)
    assert result.partitions_resumed == 0 and not result.resumed
    assert result.chains == len(library)
    assert result.encodes_executed == len(library)  # one encoder pass per chain
    assert result.weights_signature == engine.weights_signature()
    report = verify_index(index_dir)
    assert report["ok"] and report["corrupt"] == 0 and report["verified"] == len(plan)
    index = ChainIndex.open(index_dir)
    assert index.num_chains == len(library)
    assert index.chain_ids() == sorted(library.ids())
    assert index.partition_ids() == sorted(pid for pid, _, _ in plan)
    # Indexed embeddings ARE the runner's embeddings, byte for byte.
    runner = ScreenRunner(engine, cache=EmbeddingCache(), cfg=ScreenConfig(encode_batch=4))
    cid = library.ids()[0]
    emb, _, _, _ = runner.ensure_embeddings(library, [cid])
    feats, n, bucket = index.chain_feats(cid)
    np.testing.assert_array_equal(feats, emb[cid][0])
    assert (n, bucket) == (emb[cid][1], emb[cid][2])
    np.testing.assert_allclose(pooled_embedding(feats, n), index.load_partition(
        index._chain_loc[cid][0])["pooled"][index._chain_loc[cid][1]], rtol=1e-6)


@pytest.mark.parametrize("builder", ["port", "jax"])
def test_an_index_built_by_one_package_is_read_by_the_other(
        built_index, jax_built_index, builder):
    """Manifest, shards and sidecars are the same format: each package's
    reader opens, verifies and loads the other's index, shard for shard."""
    index_dir = built_index[0] if builder == "port" else jax_built_index
    port, ref = ChainIndex.open(index_dir), JaxChainIndex.open(index_dir)
    assert port.manifest == ref.manifest
    assert verify_index(index_dir)["ok"] and jax_verify_index(index_dir)["ok"]
    for pid in ref.partition_ids():
        a, b = port.load_partition(pid), ref.load_partition(pid)
        assert a["chain_ids"] == b["chain_ids"]
        for key in ("feats", "pooled", "lengths"):
            np.testing.assert_array_equal(a[key], b[key])
    # Same identity fields, and embeddings of one library within 1e-4.
    other = ChainIndex.open(jax_built_index if builder == "port" else built_index[0])
    for key in ("library_signature", "input_indep", "compute_dtype", "feat_dim",
                "partition_size", "num_chains"):
        assert port.manifest[key] == other.manifest[key], key
    for cid in port.chain_ids():
        np.testing.assert_allclose(port.chain_feats(cid)[0], other.chain_feats(cid)[0],
                                   rtol=0, atol=1e-4)


def test_prefilter_scores_and_selection(built_index):
    index = ChainIndex.open(built_index[0])
    cid = index.chain_ids()[0]
    q_feats, nq, _ = index.chain_feats(cid)
    q_vec = pooled_embedding(q_feats, nq)
    survivors, candidates = prefilter(index, q_vec, top_m=4, exclude=(cid,))
    assert candidates == index.num_chains - 1 and len(survivors) == 4
    assert cid not in {s["chain_id"] for s in survivors}
    full = {}
    for pid, cids, lengths, pooled in index.iter_pooled():
        for c, s in zip(cids, bilinear_scores(q_vec, pooled)):
            if c != cid:
                full[c] = float(s)
    want = sorted(full, key=lambda c: (-full[c], c))[:4]
    assert [s["chain_id"] for s in survivors] == want
    everyone, cands = prefilter(index, q_vec, top_m=0, exclude=(cid,))
    assert len(everyone) == cands == len(full)


def test_prefilter_scores_within_1e5_of_jax(built_index, jax_built_index):
    """The port's pre-filter over its index against the JAX pre-filter over
    the JAX package's index of the same library: scores within 1e-5, and
    the same survivors where the scores are further apart than that; on one
    index the two pre-filters agree exactly."""
    port, ref = ChainIndex.open(built_index[0]), JaxChainIndex.open(jax_built_index)
    for cid in port.chain_ids()[:3]:
        qp = pooled_embedding(*port.chain_feats(cid)[:2])
        qj = jax_pooled_embedding(*ref.chain_feats(cid)[:2])
        np.testing.assert_allclose(qp, qj, rtol=0, atol=1e-5)
        got, n_got = prefilter(port, qp, top_m=0, exclude=(cid,))
        want, n_want = jax_prefilter(ref, qj, top_m=0, exclude=(cid,))
        assert n_got == n_want
        by_id = {w["chain_id"]: w["score"] for w in want}
        for g in got:
            assert g["score"] == pytest.approx(by_id[g["chain_id"]], abs=1e-5)
        gaps = np.diff([w["score"] for w in want])
        if len(gaps) and np.all(np.abs(gaps) > 1e-5):
            assert [g["chain_id"] for g in got] == [w["chain_id"] for w in want]
        same_index, _ = jax_prefilter(port, qp, top_m=4, exclude=(cid,))
        assert same_index == prefilter(port, qp, top_m=4, exclude=(cid,))[0]


def test_query_full_funnel_matches_screen_ranking(engine, library, built_index):
    index = ChainIndex.open(built_index[0])
    cid = library.ids()[3]
    runner = IndexedQueryRunner(engine, index,
                                cfg=QueryConfig(top_m=len(library), top_k=5, decode_batch=4),
                                cache=EmbeddingCache())
    result = runner.query_from_index(cid)
    assert result.candidates == len(library) - 1
    assert result.survivors == result.pairs_decoded == len(library) - 1
    assert result.encodes_executed == 0 and not result.partial
    screen = ScreenRunner(engine, cache=EmbeddingCache(),
                          cfg=ScreenConfig(top_k=5, decode_batch=4, encode_batch=4))
    full = screen.screen(library, [p for p in enumerate_pairs(library) if cid in p])
    assert [r["pair_id"] for r in result.records] == [r["pair_id"] for r in full.records]
    for got, want in zip(result.records, full.records):
        assert got["score"] == pytest.approx(want["score"], rel=1e-5)
        assert got["partner"] in (want["chain1"], want["chain2"])


def test_query_decodes_only_prefilter_survivors(engine, built_index):
    from deepinteract_tpu_torch.index.funnel import _DECODE_BATCHES, _DECODED

    index = ChainIndex.open(built_index[0])
    cid = index.chain_ids()[1]
    runner = IndexedQueryRunner(engine, index, cfg=QueryConfig(top_m=3, top_k=5,
                                                               decode_batch=4))
    dispatches = []
    real_decode = engine.decode_executable

    def counting_decode(b1, b2, slots, args):
        dispatches.append((b1, b2, slots))
        return real_decode(b1, b2, slots, args)

    d0, b0 = _DECODED.value(), _DECODE_BATCHES.value()
    engine.decode_executable = counting_decode
    try:
        result = runner.query_from_index(cid)
    finally:
        engine.decode_executable = real_decode
    assert result.survivors == result.pairs_decoded == 3
    assert result.candidates == index.num_chains - 1
    assert _DECODED.value() - d0 == 3
    assert _DECODE_BATCHES.value() - b0 == len(dispatches) == result.decode_batches
    assert sum(s for _, _, s in dispatches) <= 2 * result.survivors
    assert {r["partner"] for r in result.records} == {
        s["chain_id"] for s in result.prefilter_ranked}


def test_stale_index_refused_unless_allow_stale(engine, built_index, jax_built_index):
    index = ChainIndex.open(built_index[0])
    index.manifest = dict(index.manifest, weights_signature="other-w")
    with pytest.raises(ValueError, match="stale index"):
        IndexedQueryRunner(engine, index)
    IndexedQueryRunner(engine, index, allow_stale=True)  # explicit opt-in
    # The JAX package's index names the JAX engine's weights: stale here.
    with pytest.raises(ValueError, match="stale index"):
        IndexedQueryRunner(engine, ChainIndex.open(jax_built_index))


# ---------------------------------------------------------------------------
# Exactly-once resume + corruption recovery
# ---------------------------------------------------------------------------


def test_build_crash_resumes_exactly_once(engine, library, tmp_path):
    index_dir = str(tmp_path / "index")
    plan = plan_partitions(engine, library, PART)

    class Crash(RuntimeError):
        pass

    def crash_after_first(done):
        if done == 1:
            raise Crash

    with pytest.raises(Crash):
        build_index(engine, library, index_dir, partition_size=PART, encode_batch=4,
                    after_partition=crash_after_first)
    assert not os.path.exists(idx_format.manifest_path(index_dir))
    resumed = build_index(engine, library, index_dir, partition_size=PART, encode_batch=4)
    assert resumed.resumed and resumed.partitions_resumed == 1
    assert resumed.partitions_built == len(plan) - 1 and resumed.partitions_rebuilt == 0
    assert resumed.encodes_executed == len(library) - len(plan[0][2])
    assert verify_index(index_dir)["ok"]


def test_build_preemption_stops_at_partition_boundary(engine, library, tmp_path):
    index_dir = str(tmp_path / "index")
    guard = PreemptionGuard(log=lambda m: None)
    guard.request("test preemption")
    result = build_index(engine, library, index_dir, partition_size=PART, guard=guard)
    assert result.preempted and result.partitions_built == 0 and result.encodes_executed == 0
    assert not os.path.exists(idx_format.manifest_path(index_dir))
    done = build_index(engine, library, index_dir, partition_size=PART)
    assert not done.preempted and done.partitions_built == done.partitions_total
    assert verify_index(index_dir)["ok"]


def test_corrupt_shard_quarantined_and_only_it_rebuilds(engine, library, built_index,
                                                        tmp_path):
    index_dir = str(tmp_path / "index")
    shutil.copytree(built_index[0], index_dir)
    index = ChainIndex.open(index_dir)
    victim_pid = index.partition_ids()[0]
    victim = idx_format.shard_path(index_dir, victim_pid)
    blob = bytearray(open(victim, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(victim, "wb") as fh:
        fh.write(blob)
    untouched = {pid: os.path.getmtime(idx_format.shard_path(index_dir, pid))
                 for pid in index.partition_ids() if pid != victim_pid}
    report = verify_index(index_dir)
    assert not report["ok"] and report["corrupt"] == 1 and report["corrupt_paths"] == [victim]
    result = build_index(engine, library, index_dir, partition_size=PART, encode_batch=4)
    assert result.partitions_rebuilt == 1 and result.partitions_built == 1
    assert result.encodes_executed == len(index.partition(victim_pid)["chains"])
    assert any(".corrupt-" in name for name in os.listdir(os.path.dirname(victim)))
    for pid, mtime in untouched.items():
        assert os.path.getmtime(idx_format.shard_path(index_dir, pid)) == mtime
    assert verify_index(index_dir)["ok"]


def test_verify_quarantine_flag_moves_damage_aside(built_index, tmp_path):
    index_dir = str(tmp_path / "index")
    shutil.copytree(built_index[0], index_dir)
    index = ChainIndex.open(index_dir)
    victim = idx_format.shard_path(index_dir, index.partition_ids()[-1])
    with open(victim, "ab") as fh:
        fh.write(b"tail garbage")
    report = verify_index(index_dir, quarantine=True)
    assert report["corrupt"] == 1 and not report["ok"] and not os.path.exists(victim)
    with pytest.raises(artifacts.ArtifactError):
        ChainIndex.open(index_dir).load_partition(index.partition_ids()[-1])


def test_merge_disjoint_indexes_round_trip(engine, tmp_path):
    lib_a = ChainLibrary.synthetic(4, 20, 40, seed=5, knn=KNN, geo_nbrhd_size=GEO)
    lib_b_raw = ChainLibrary.synthetic(4, 20, 40, seed=6, knn=KNN, geo_nbrhd_size=GEO)
    lib_b = ChainLibrary([ChainEntry(f"b_{e.chain_id}", e.raw, e.n) for e in lib_b_raw.chains])
    dir_a, dir_b = str(tmp_path / "a"), str(tmp_path / "b")
    build_index(engine, lib_a, dir_a, partition_size=PART)
    build_index(engine, lib_b, dir_b, partition_size=PART)
    out = str(tmp_path / "merged")
    report = merge_indexes([dir_a, dir_b], out)
    assert report["ok"] and report["chains"] == 8 and verify_index(out)["ok"]
    merged = ChainIndex.open(out)
    assert set(merged.chain_ids()) == set(lib_a.ids()) | set(lib_b.ids())
    cid = lib_b.ids()[0]
    np.testing.assert_array_equal(merged.chain_feats(cid)[0],
                                  ChainIndex.open(dir_b).chain_feats(cid)[0])
    result = IndexedQueryRunner(engine, merged, cfg=QueryConfig(top_m=3, decode_batch=4)
                                ).query_from_index(cid)
    assert result.pairs_decoded == 3 and result.candidates == 7
    # The JAX merge of the same sources writes the same manifest.
    from deepinteract_tpu.index import merge_indexes as jax_merge_indexes

    jax_report = jax_merge_indexes([dir_a, dir_b], str(tmp_path / "jmerged"))
    assert jax_report["library_signature"] == report["library_signature"]
    jm = JaxChainIndex.open(str(tmp_path / "jmerged")).manifest
    assert {k: v for k, v in jm.items() if k != "partitions"} == {
        k: v for k, v in merged.manifest.items() if k != "partitions"}
    with pytest.raises(ValueError, match="at least two"):
        merge_indexes([dir_a], str(tmp_path / "nope"))
    with pytest.raises(ValueError, match="appears in both"):
        merge_indexes([dir_a, dir_a], str(tmp_path / "dup"))


# ---------------------------------------------------------------------------
# CLIs + contracts
# ---------------------------------------------------------------------------


def test_cli_index_build_verify_merge_and_query_contracts(tmp_path, capsys):
    from deepinteract_tpu_torch.cli.index import main as index_main
    from deepinteract_tpu_torch.cli.query import main as query_main
    from tools.check_cli_contract import check_cli_contract_text

    lib = ["--synthetic_chains", "6", "--synthetic_len", "20,40", "--screen_batch", "4"]
    idx = str(tmp_path / "idx")
    assert index_main(["build", *TINY_CLI_ARGS, *lib, "--index_dir", idx,
                       "--partition_size", "2"]) == 0
    rec = check_cli_contract_text(capsys.readouterr().out, "index")
    assert rec["ok"] and rec["action"] == "build" and rec["chains"] == 6
    assert rec["encodes_executed"] == 6 and rec["partitions"] == 3 and not rec["resumed"]
    # Rebuild: fully resumed, nothing encoded.
    assert index_main(["build", *TINY_CLI_ARGS, *lib, "--index_dir", idx,
                       "--partition_size", "2"]) == 0
    rec = check_cli_contract_text(capsys.readouterr().out, "index")
    assert rec["resumed"] and rec["partitions_resumed"] == 3 and rec["encodes_executed"] == 0
    assert index_main(["verify", "--index_dir", idx]) == 0
    rec = check_cli_contract_text(capsys.readouterr().out, "index")
    assert rec["ok"] and rec["corrupt"] == 0 and rec["partitions"] == 3
    assert JaxChainIndex.open(idx).num_chains == 6

    out = str(tmp_path / "q")
    assert query_main([*TINY_CLI_ARGS, "--index_dir", idx, "--query", "syn0002",
                       "--top_m", "3", "--top_k", "5", "--out", out]) == 0
    rec = check_cli_contract_text(capsys.readouterr().out, "query")
    assert rec["ok"] and rec["candidates"] == 5 and rec["survivors"] == 3
    assert rec["pairs_decoded"] == 3 and os.path.exists(rec["ranked_out"])
    # An external query chain (from a library) costs one encode.
    assert query_main([*TINY_CLI_ARGS, *lib, "--index_dir", idx, "--query", "syn0002",
                       "--top_m", "2", "--out", out]) == 0
    rec = check_cli_contract_text(capsys.readouterr().out, "query")
    assert rec["survivors"] == rec["pairs_decoded"] == 2
