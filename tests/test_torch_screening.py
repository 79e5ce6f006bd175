"""The port's bulk screening (``deepinteract_tpu_torch.screening``, the
split phase of ``serving/engine.py``) against the JAX package's, mirroring
tests/test_screening.py.

One JAX engine and one port engine for the module, from the tiny config of
``torch_port_helpers`` (hidden 16, 2 heads, kNN 6, the JAX side with
``depad_stats=False``); the JAX engine's params and batch statistics are
carried into the port (``weights.load_jax_variables``). The port's engine
runs on the CPU, where each split-phase entry runs eagerly through the
plain attention; ``chip_smoke.py`` phase 10 holds the CUDA graphs on the
card. Both packages read each other's manifests and spill files, and hash
chains to the same digests.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from deepinteract_tpu.data.packed import pack_dataset as jax_pack_dataset
from deepinteract_tpu.data.loader import make_bucket_fn
from deepinteract_tpu.data.datasets import DIPSDataset as JaxDIPSDataset
from deepinteract_tpu.robustness.preemption import PreemptionGuard as JaxPreemptionGuard
from deepinteract_tpu.screening import ChainLibrary as JaxChainLibrary
from deepinteract_tpu.screening import EmbeddingCache as JaxEmbeddingCache
from deepinteract_tpu.screening import ScreenConfig as JaxScreenConfig
from deepinteract_tpu.screening import ScreenManifest as JaxScreenManifest
from deepinteract_tpu.screening import ScreenRunner as JaxScreenRunner
from deepinteract_tpu.screening import chain_hash as jax_chain_hash
from deepinteract_tpu.screening import enumerate_pairs as jax_enumerate_pairs
from deepinteract_tpu.screening import pair_summary as jax_pair_summary
from deepinteract_tpu.serving import EngineConfig as JaxEngineConfig
from deepinteract_tpu.serving import InferenceEngine as JaxInferenceEngine
from deepinteract_tpu_torch.data.graph import stack_complexes
from deepinteract_tpu_torch.data.io import save_complex_npz
from deepinteract_tpu_torch.data.synthetic import random_complex, write_tiny_npz_dataset
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.models.vision import DeepLabConfig
from deepinteract_tpu_torch.robustness.preemption import PreemptionGuard
from deepinteract_tpu_torch.screening import (ChainLibrary, EmbeddingCache, ScreenConfig,
                                              ScreenManifest, ScreenRunner, chain_hash,
                                              enumerate_pairs, pair_id, pair_summary)
from deepinteract_tpu_torch.serving import EngineConfig, InferenceEngine
from deepinteract_tpu_torch.serving.graphs import decode_forward, encode_forward
from deepinteract_tpu_torch.weights import init_weights
from torch_port_helpers import jax_cfg, port_cfg

KNN, GEO = 6, 2
BAR = 1e-4  # f32 probabilities: the port's logit bar
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
    return ChainLibrary.synthetic(8, 20, 40, seed=3, knn=KNN, geo_nbrhd_size=GEO)


@pytest.fixture(scope="module")
def jax_library():
    return JaxChainLibrary.synthetic(8, 20, 40, seed=3, knn=KNN, geo_nbrhd_size=GEO)


@pytest.fixture(scope="module")
def jax_screen(engines, jax_library):
    """The JAX ScreenRunner's all-vs-all screen of the library (its encode
    and decode executables are compiled once here)."""
    runner = JaxScreenRunner(engines[0], cache=JaxEmbeddingCache(),
                             cfg=JaxScreenConfig(top_k=5, decode_batch=4))
    return runner.screen(jax_library, jax_enumerate_pairs(jax_library))


# ---------------------------------------------------------------------------
# Split-phase parity: decode(encode, encode) == the monolithic forward
# ---------------------------------------------------------------------------


def _split_vs_monolithic(cfg, atol=0.0, seed=0):
    """The port's forward against encode + decode on one padded and masked
    batch, the embeddings crossing the split as float32 host arrays (what
    the embedding cache stores and the decode entry is fed)."""
    model = DeepInteract(cfg)
    init_weights(model, seed)
    model.eval()
    cx = stack_complexes([
        random_complex(20, 16, np.random.default_rng(seed), n_pad1=32, n_pad2=32, knn=KNN),
        random_complex(26, 22, np.random.default_rng(seed + 1), n_pad1=32, n_pad2=32,
                       knn=KNN)])
    with torch.inference_mode():
        mono = model(cx.graph1, cx.graph2)
        f1 = encode_forward(model, cx.graph1).numpy()
        f2 = encode_forward(model, cx.graph2).numpy()
        assert f1.dtype == f2.dtype == np.float32
        split = model.decode(torch.from_numpy(f1), torch.from_numpy(f2),
                             cx.graph1.node_mask, cx.graph2.node_mask)
        probs = decode_forward(model, torch.from_numpy(f1), torch.from_numpy(f2),
                               cx.graph1.node_mask, cx.graph2.node_mask)
    if atol == 0.0:
        assert torch.equal(split, mono)
        assert torch.equal(probs, torch.softmax(mono, dim=-1)[..., 1])
    else:
        torch.testing.assert_close(split.float(), mono.float(), rtol=0, atol=atol)


def test_split_parity_dilated_byte_exact():
    _split_vs_monolithic(port_cfg())


def test_split_parity_materialized_stem():
    _split_vs_monolithic(port_cfg(interaction_stem="materialized"))


def test_split_parity_deeplab():
    _split_vs_monolithic(port_cfg(
        interact_module_type="deeplab",
        deeplab=DeepLabConfig(stem_channels=4, stage_channels=(4, 8, 8, 8),
                              stage_blocks=(1, 1, 1, 1), aspp_rates=(2, 4, 6),
                              decoder_channels=8, high_res_channels=4, dropout_rate=0.0)))


def test_split_parity_bf16_within_tolerance():
    # bf16 -> f32 -> bf16 is exact, so the split matches; the JAX test's
    # tolerance guards the seam.
    _split_vs_monolithic(port_cfg(compute_dtype="bfloat16"), atol=1e-2)


def test_split_phase_matches_the_jax_split_phase(engines, library, jax_library, jax_screen):
    """Encode features within 1e-4 of the JAX engine's encode executable,
    and the decode entry within 1e-4 of the JAX decode executable on the
    same (JAX-encoded) features; the inventory labels are the JAX ones."""
    jeng, peng = engines
    ids = library.ids()
    jemb = JaxScreenRunner(jeng, cache=JaxEmbeddingCache()).ensure_embeddings(
        jax_library, ids)[0]
    pemb = ScreenRunner(peng, cache=EmbeddingCache()).ensure_embeddings(library, ids)[0]
    for cid in ids:
        assert pemb[cid][1:] == jemb[cid][1:]
        assert pemb[cid][0].dtype == np.float32
        np.testing.assert_allclose(pemb[cid][0], jemb[cid][0], rtol=0, atol=BAR)
    b = jemb[ids[0]][2]
    rows = [(ids[0], ids[1]), (ids[2], ids[3]), (ids[4], ids[5]), (ids[6], ids[7])]
    args = (np.stack([jemb[a][0] for a, _ in rows]), np.stack([jemb[c][0] for _, c in rows]),
            np.stack([np.arange(b) < jemb[a][1] for a, _ in rows]),
            np.stack([np.arange(b) < jemb[c][1] for _, c in rows]))
    ref = np.asarray(jeng.decode_executable(b, b, 4, args)(jeng.params, jeng.batch_stats, *args))
    got = peng.replay_to_host(peng.decode_executable(b, b, 4, args), *args)
    assert got.shape == ref.shape == (4, b, b) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=BAR)
    assert {"enc:64/b8/k6g2", "dec:64x64/b4"} <= set(peng.warm_bucket_labels())
    assert {"enc:64/b8/k6g2", "dec:64x64/b4"} <= set(jeng.warm_bucket_labels())


# ---------------------------------------------------------------------------
# Embedding cache
# ---------------------------------------------------------------------------


def test_chain_hash_sensitivity(library):
    a, b = library.chains[0], library.chains[1]
    assert chain_hash(a.raw) == chain_hash(a.raw)
    assert chain_hash(a.raw) != chain_hash(b.raw)
    tweaked = dict(a.raw, node_feats=a.raw["node_feats"] + 1.0)
    assert chain_hash(a.raw) != chain_hash(tweaked)
    assert chain_hash(a.raw, extra=(64,)) != chain_hash(a.raw, extra=(128,))


def test_chain_hash_and_runner_key_equal_the_jax_digests(engines, library, jax_library):
    jeng, peng = engines
    for entry, jentry in zip(library.chains, jax_library.chains):
        extra = ("emb", 64, "init-seed42", False, "float32")
        assert chain_hash(entry.raw, extra) == jax_chain_hash(jentry.raw, extra)
    key = ScreenRunner(peng)._chain_key(library.chains[0], 64)
    sig = peng.weights_signature()
    # The runner's extras print as the JAX ones: the dtype is "float32".
    assert key == jax_chain_hash(jax_library.chains[0].raw,
                                 ("emb", 64, sig, False, "float32"))


def test_embedding_cache_lru_and_stats():
    cache = EmbeddingCache(capacity=2)
    f = np.zeros((8, 4), np.float32)
    cache.put("a", f, 5)
    cache.put("b", f + 1, 6)
    got = cache.get("a")  # refresh: b becomes LRU
    assert got is not None and got[1] == 5
    cache.put("c", f + 2, 7)
    assert cache.get("b") is None  # evicted, no spill dir
    s = cache.stats()
    assert s["size"] == 2 and s["hits"] == 1 and s["misses"] == 1
    with pytest.raises(ValueError):
        cache.get("a")[0][0, 0] = 9.0  # cached arrays are read-only


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_embedding_cache_spills_and_reloads(tmp_path, writer):
    """A spill written by either package reloads in the other (and in
    itself): the files and their integrity sidecars are the same."""
    spill = str(tmp_path / "spill")
    cls_w, cls_r = ((EmbeddingCache, JaxEmbeddingCache) if writer == "port"
                    else (JaxEmbeddingCache, EmbeddingCache))
    cache = cls_w(capacity=1, spill_dir=spill)
    f1 = np.arange(12, dtype=np.float32).reshape(4, 3)
    cache.put("k1", f1, 4)
    cache.put("k2", f1 + 10, 3)  # evicts k1 -> disk
    assert cache.stats()["spills"] == 1
    for reader in (cache, cls_r(capacity=1, spill_dir=spill)):
        got = reader.get("k1")
        assert got is not None and got[1] == 4
        np.testing.assert_array_equal(got[0], f1)
    assert cache.stats()["spill_hits"] == 1


# ---------------------------------------------------------------------------
# Library + pair enumeration + scoring
# ---------------------------------------------------------------------------


def test_enumerate_pairs_modes(library, jax_library):
    ids = library.ids()
    pairs = enumerate_pairs(library)
    assert len(pairs) == 8 * 7 // 2
    assert len({frozenset(p) for p in pairs}) == len(pairs)
    assert len(enumerate_pairs(library, include_self=True)) == len(pairs) + 8
    q = enumerate_pairs(library, queries=[ids[0], ids[1]])
    assert len(q) == 7 + 6 and all(ids[0] in p or ids[1] in p for p in q)
    assert enumerate_pairs(library, max_pairs=7) == pairs[:7]
    with pytest.raises(KeyError):
        enumerate_pairs(library, queries=["nope"])
    for kw in ({}, {"include_self": True}, {"queries": [ids[3]]}, {"max_pairs": 5}):
        assert enumerate_pairs(library, **kw) == jax_enumerate_pairs(jax_library, **kw)


def test_library_signature_tracks_content(library, jax_library):
    """Same seed, same chains: bitwise equal to the JAX library's, and the
    same signature string."""
    assert library.ids() == jax_library.ids()
    for entry, jentry in zip(library.chains, jax_library.chains):
        assert entry.n == jentry.n
        for key, value in jentry.raw.items():
            np.testing.assert_array_equal(entry.raw[key], value)
            assert entry.raw[key].dtype == value.dtype
    assert library.signature() == jax_library.signature()
    lib2 = ChainLibrary.synthetic(8, 20, 40, seed=3, knn=KNN, geo_nbrhd_size=GEO)
    assert library.signature() == lib2.signature()
    lib3 = ChainLibrary.synthetic(8, 20, 40, seed=4, knn=KNN, geo_nbrhd_size=GEO)
    assert library.signature() != lib3.signature()


def test_library_from_npz_dir_and_files(tmp_path, library):
    for i in range(2):
        save_complex_npz(str(tmp_path / f"cx{i}.npz"), library.chains[2 * i].raw,
                         library.chains[2 * i + 1].raw, np.zeros((0, 3), np.int32), f"cx{i}")
    lib = ChainLibrary.from_npz_dir(str(tmp_path))
    assert sorted(lib.ids()) == ["cx0:g1", "cx0:g2", "cx1:g1", "cx1:g2"]
    assert lib["cx0:g1"].n == library.chains[0].n
    assert lib.signature() == JaxChainLibrary.from_npz_dir(str(tmp_path)).signature()


def test_library_from_pack_reads_the_jax_pack_and_packs_the_same_bytes(tmp_path):
    """``from_pack`` over a pack the JAX package wrote gives the JAX
    library's chains; the port's ``pack_dataset`` writes the same files."""
    from deepinteract_tpu_torch.data.datasets import DIPSDataset
    from deepinteract_tpu_torch.data.packed import PackedDataset, pack_dataset

    root = str(tmp_path / "data")
    write_tiny_npz_dataset(root, n_complexes=3, knn=KNN)
    bucket_fn = make_bucket_fn(False, False)
    jax_pack_dataset(JaxDIPSDataset(root, "train"), str(tmp_path / "jpack"), bucket_fn)
    pack_dataset(DIPSDataset(root, "train"), str(tmp_path / "ppack"), bucket_fn)
    for name in sorted(os.listdir(tmp_path / "jpack")):
        if name.endswith(".npy"):
            assert (tmp_path / "jpack" / name).read_bytes() == \
                (tmp_path / "ppack" / name).read_bytes(), name
    lib = ChainLibrary.from_pack(str(tmp_path / "jpack"))
    jlib = JaxChainLibrary.from_pack(str(tmp_path / "jpack"))
    assert lib.ids() == jlib.ids() and len(lib) == 6
    assert lib.signature() == jlib.signature()
    # The port's batch of a pack equals to_paired_complex + stack_complexes.
    ds = PackedDataset(str(tmp_path / "ppack"))
    plain = DIPSDataset(root, "train")
    from deepinteract_tpu_torch.data.io import to_paired_complex
    bucket = ds.bucket_of(0)
    got = ds.padded_batch([0], bucket)
    want = stack_complexes([to_paired_complex(plain[0], *bucket)])
    for g, w in ((got.graph1, want.graph1), (got.graph2, want.graph2)):
        for f in dataclasses.fields(g):
            assert torch.equal(getattr(g, f.name), getattr(w, f.name)), f.name
    assert torch.equal(got.contact_map, want.contact_map)


def test_pair_summary_topk_and_transpose_invariance():
    probs = np.zeros((4, 5), np.float32)
    probs[1, 2] = 0.9
    probs[3, 0] = 0.7
    probs[0, 4] = 0.5
    s = pair_summary(probs, top_k=2)
    assert s["top_contacts"][0] == {"i": 1, "j": 2, "p": 0.9}
    assert s["top_contacts"][1]["p"] == pytest.approx(0.7)
    assert s["score"] == pytest.approx(0.8) and s["max_prob"] == pytest.approx(0.9)
    assert pair_summary(probs.T, top_k=2)["score"] == pytest.approx(s["score"])
    assert pair_summary(probs, top_k=999)["top_k"] == 20  # clamped
    rand = np.random.default_rng(0).random((30, 17)).astype(np.float32)
    assert pair_summary(rand, 7) == jax_pair_summary(rand, 7)


# ---------------------------------------------------------------------------
# Manifest
# ---------------------------------------------------------------------------


def test_manifest_roundtrip_resume_and_stale(tmp_path):
    path = str(tmp_path / "m.json")
    m, resumed = ScreenManifest.load_or_create(path, "sigA", 3)
    assert not resumed
    m.mark_done("a|b", {"pair_id": "a|b", "score": 0.5})
    m.flush()
    m2, resumed = ScreenManifest.load_or_create(path, "sigA", 3)
    assert resumed and "a|b" in m2.completed
    assert m2.remaining([("a", "b"), ("a", "c")]) == [("a", "c")]
    # The JAX package reads the same file.
    assert JaxScreenManifest.load_or_create(path, "sigA", 3)[0].completed == m2.completed
    m3, resumed = ScreenManifest.load_or_create(path, "sigB", 3)
    assert not resumed and not m3.completed
    assert os.path.exists(path + ".stale")
    assert pair_id("a", "b") == "a|b"


@pytest.mark.parametrize("first", ["jax", "port"])
def test_manifest_written_by_one_package_resumes_in_the_other(
        engines, library, jax_library, tmp_path, first):
    """A screen preempted in one package resumes in the other against the
    same manifest file: the two runs partition the pairs (exactly once),
    and the second run's records cover the whole screen."""
    jeng, peng = engines
    path = str(tmp_path / "manifest.json")
    pairs = enumerate_pairs(library)
    make = {
        "jax": lambda: (JaxScreenRunner(jeng, cache=JaxEmbeddingCache(),
                                        cfg=JaxScreenConfig(top_k=5, decode_batch=4)),
                        JaxScreenManifest, jax_library, JaxPreemptionGuard),
        "port": lambda: (ScreenRunner(peng, cache=EmbeddingCache(),
                                      cfg=ScreenConfig(top_k=5, decode_batch=4)),
                         ScreenManifest, library, PreemptionGuard)}
    second = "port" if first == "jax" else "jax"
    runner, manifest_cls, lib, guard_cls = make[first]()
    m1, resumed = manifest_cls.load_or_create(path, lib.signature(), len(pairs))
    guard = guard_cls(log=lambda m: None)
    r1 = runner.screen(lib, pairs, manifest=m1, guard=guard,
                       after_batch=lambda n: guard.request("preempt") if n == 2 else None)
    assert not resumed and r1.preempted and r1.pairs_scored == 8
    runner, manifest_cls, lib, guard_cls = make[second]()
    m2, resumed = manifest_cls.load_or_create(path, lib.signature(), len(pairs))
    assert resumed and set(m2.completed) == set(m1.completed)
    r2 = runner.screen(lib, pairs, manifest=m2, guard=guard_cls(log=lambda m: None))
    assert not r2.preempted and r2.pairs_resumed == 8
    assert r1.pairs_scored + r2.pairs_scored == len(pairs)
    assert set(m2.completed) == {pair_id(*p) for p in pairs}
    assert len(r2.records) == len(pairs)


# ---------------------------------------------------------------------------
# Runner over the shared engine
# ---------------------------------------------------------------------------


def test_screen_matches_the_jax_screen(engine, library, jax_screen):
    """The same library through both ScreenRunners: the same pairs in the
    same orientation and buckets, scores and top-contact probabilities
    within 1e-4; contact indices agree wherever adjacent probabilities are
    further apart than the bar (closer ones may swap places)."""
    result = ScreenRunner(engine, cache=EmbeddingCache(),
                          cfg=ScreenConfig(top_k=5, decode_batch=4)).screen(
        library, enumerate_pairs(library))
    assert (result.pairs_scored, result.encodes_executed, result.decode_batches) == (
        jax_screen.pairs_scored, jax_screen.encodes_executed, jax_screen.decode_batches)
    want = {r["pair_id"]: r for r in jax_screen.records}
    assert set(want) == {r["pair_id"] for r in result.records}
    for rec in result.records:
        ref = want[rec["pair_id"]]
        for key in ("chain1", "chain2", "n1", "n2", "bucket", "top_k"):
            assert rec[key] == ref[key], key
        assert rec["score"] == pytest.approx(ref["score"], abs=BAR)
        assert rec["max_prob"] == pytest.approx(ref["max_prob"], abs=BAR)
        ps = [c["p"] for c in ref["top_contacts"]]
        for i, (got, exp) in enumerate(zip(rec["top_contacts"], ref["top_contacts"])):
            assert got["p"] == pytest.approx(exp["p"], abs=BAR)
            gaps = [abs(ps[i] - ps[j]) for j in (i - 1, i + 1) if 0 <= j < len(ps)]
            if min(gaps) > BAR:
                assert (got["i"], got["j"]) == (exp["i"], exp["j"])


def test_screen_matches_monolithic_predict(engine, library):
    """The split-phase screen's scores equal the monolithic predict path's
    for the same chains and weights."""
    pairs = enumerate_pairs(library, max_pairs=6)
    result = ScreenRunner(engine, cache=EmbeddingCache(),
                          cfg=ScreenConfig(top_k=5, decode_batch=4)).screen(library, pairs)
    assert result.pairs_scored == 6
    by_id = {r["pair_id"]: r for r in result.records}
    for c1, c2 in pairs[:3]:
        raw = {"graph1": library[c1].raw, "graph2": library[c2].raw,
               "examples": np.zeros((0, 3), np.int32)}
        mono = pair_summary(engine.predict(raw)["probs"], 5)
        rec = by_id[pair_id(c1, c2)]
        assert rec["score"] == pytest.approx(mono["score"], abs=1e-5)
        assert rec["max_prob"] == pytest.approx(mono["max_prob"], abs=1e-5)


def test_screen_encodes_each_chain_once_and_warm_repeat(engine, library):
    pairs = enumerate_pairs(library)
    runner = ScreenRunner(engine, cache=EmbeddingCache(),
                          cfg=ScreenConfig(top_k=5, decode_batch=4))
    r1 = runner.screen(library, pairs)
    assert r1.pairs_scored == len(pairs) == 28
    assert r1.encodes_executed == 8  # one encoder pass per chain
    assert r1.encode_reuse_ratio == pytest.approx(2 * 28 / 8)
    scores = [r["score"] for r in r1.records]
    assert scores == sorted(scores, reverse=True)
    captures = engine.capture_count
    r2 = runner.screen(library, pairs)
    # Warm repeat: no encoder pass (cache hits) and no new entry.
    assert r2.encodes_executed == 0 and r2.encode_cache_hits == 8
    assert engine.capture_count == captures
    for a, b in zip(r1.records, r2.records):
        assert a["pair_id"] == b["pair_id"] and a["score"] == b["score"]


def test_chaos_preempted_screen_resumes_exactly_once(engine, library, tmp_path):
    pairs = enumerate_pairs(library)
    path = str(tmp_path / "chaos_manifest.json")
    sig = library.signature()
    guard = PreemptionGuard(log=lambda m: None)
    m1, resumed = ScreenManifest.load_or_create(path, sig, len(pairs))
    assert not resumed
    runner = ScreenRunner(engine, cache=EmbeddingCache(),
                          cfg=ScreenConfig(top_k=5, decode_batch=4))
    r1 = runner.screen(library, pairs, manifest=m1, guard=guard,
                       after_batch=lambda n: guard.request("chaos SIGTERM") if n == 3
                       else None)
    assert r1.preempted and 0 < r1.pairs_scored < len(pairs)
    first_run_ids = set(m1.completed)
    assert len(first_run_ids) == r1.pairs_scored  # durable before exit
    m2, resumed = ScreenManifest.load_or_create(path, sig, len(pairs))
    assert resumed and set(m2.completed) == first_run_ids
    r2 = ScreenRunner(engine, cache=EmbeddingCache(),
                      cfg=ScreenConfig(top_k=5, decode_batch=4)).screen(
        library, pairs, manifest=m2, guard=PreemptionGuard(log=lambda m: None))
    assert not r2.preempted
    assert r1.pairs_scored + r2.pairs_scored == len(pairs)
    assert r2.pairs_resumed == r1.pairs_scored
    assert set(m2.completed) == {pair_id(*p) for p in pairs}
    assert len(r2.records) == len(pairs)


# ---------------------------------------------------------------------------
# CLI end to end + contract line
# ---------------------------------------------------------------------------


def test_cli_screen_end_to_end_and_contract(tmp_path, capsys):
    from deepinteract_tpu_torch.cli.screen import main
    from tools.check_cli_contract import check_cli_contract_text

    out = str(tmp_path / "screen" / "run1")
    argv = TINY_CLI_ARGS + ["--synthetic_chains", "12", "--synthetic_len", "20,40",
                            "--screen_batch", "4", "--top_k", "5", "--out", out]
    assert main(argv) == 0
    record = check_cli_contract_text(capsys.readouterr().out, "screen")
    assert record["pairs_total"] == 66 and record["pairs_scored"] == 66
    assert record["chains"] == 12 and not record["preempted"]
    assert record["encode_reuse_ratio"] == pytest.approx(11.0)
    with open(record["ranked_out"]) as fh:
        rows = [json.loads(ln) for ln in fh]
    assert [r["rank"] for r in rows] == list(range(1, 67))
    scores = [r["score"] for r in rows]
    assert scores == sorted(scores, reverse=True)
    assert rows[0]["pair_id"] == record["top_pair"]["pair_id"]
    assert os.path.exists(record["csv_out"])
    # Rerun: full resume, no device work, the same ranking.
    assert main(argv) == 0
    record2 = check_cli_contract_text(capsys.readouterr().out, "screen")
    assert record2["resumed"] and record2["pairs_resumed"] == 66
    assert record2["pairs_scored"] == 0 and record2["top_pair"] == record["top_pair"]


def test_cli_screen_without_a_gpu_refuses(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the refusal needs one without")
    from deepinteract_tpu_torch.cli.screen import main

    argv = [a for a in TINY_CLI_ARGS if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit) as exc:
        main(argv + ["--synthetic_chains", "3", "--out", str(tmp_path / "s")])
    assert exc.value.code == 2 and "no CUDA device" in capsys.readouterr().err
