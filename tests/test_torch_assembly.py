"""The port's assembly and calibration (``deepinteract_tpu_torch.assembly``,
``deepinteract_tpu_torch.calibration``) against the JAX package's,
mirroring tests/test_assembly.py: the calibration numerics within 1e-6 of
JAX on the same numpy inputs, calibration artifacts read across the
packages (stale and corrupt refused), assembly records byte-identical to a
screen's, encode-once counters, the interface graph, the control and the
calibration, and the ``assemble`` and ``calibrate`` CLIs and ``predict
--top_k --calibration`` with their contracts.

One JAX engine and one port engine for the module (the tiny config of
``torch_port_helpers``, the JAX weights carried into the port); the port
runs on the CPU.
"""

import json
import os

import numpy as np
import pytest

from deepinteract_tpu.assembly import AssemblyConfig as JaxAssemblyConfig
from deepinteract_tpu.assembly import AssemblyRunner as JaxAssemblyRunner
from deepinteract_tpu.calibration import Calibrator as JaxCalibrator
from deepinteract_tpu.calibration import calibrator as jax_cal
from deepinteract_tpu.calibration import load_calibration as jax_load_calibration
from deepinteract_tpu.calibration import save_calibration as jax_save_calibration
from deepinteract_tpu.screening import ChainLibrary as JaxChainLibrary
from deepinteract_tpu.screening import EmbeddingCache as JaxEmbeddingCache
from deepinteract_tpu.serving import EngineConfig as JaxEngineConfig
from deepinteract_tpu.serving import InferenceEngine as JaxInferenceEngine
from deepinteract_tpu_torch.assembly import AssemblyConfig, AssemblyRunner
from deepinteract_tpu_torch.assembly import runner as assembly_runner
from deepinteract_tpu_torch.calibration import (Calibrator, expected_calibration_error,
                                                load_calibration, miscalibrated_labels,
                                                save_calibration)
from deepinteract_tpu_torch.calibration import calibrator as port_cal
from deepinteract_tpu_torch.calibration.calibrator import (annotate_records, fit_calibrator,
                                                          fit_temperature)
from deepinteract_tpu_torch.data.io import save_complex_npz
from deepinteract_tpu_torch.data.synthetic import random_raw_complex
from deepinteract_tpu_torch.robustness.artifacts import CorruptArtifact, StaleArtifact
from deepinteract_tpu_torch.screening import (ChainLibrary, EmbeddingCache, ScreenConfig,
                                              ScreenRunner, pair_summary)
from deepinteract_tpu_torch.screening.library import ChainEntry
from deepinteract_tpu_torch.serving import EngineConfig, InferenceEngine
from torch_port_helpers import jax_cfg, port_cfg

KNN, GEO = 6, 2
BAR = 1e-4
TINY_CLI_ARGS = ["--num_gnn_layers", "1", "--num_gnn_hidden_channels", "16",
                 "--num_gnn_attention_heads", "2", "--num_interact_layers", "1",
                 "--num_interact_hidden_channels", "8", "--dropout_rate", "0.0",
                 "--device", "cpu"]


def all_pairs(ids):
    return [(ids[i], ids[j]) for i in range(len(ids)) for j in range(i + 1, len(ids))]


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
    return ChainLibrary.synthetic(6, 20, 40, seed=3, knn=KNN, geo_nbrhd_size=GEO)


# ---------------------------------------------------------------------------
# Calibration numerics (no engine), against the JAX package's
# ---------------------------------------------------------------------------


def test_temperature_fit_recovers_truth_and_ece_improves():
    rng = np.random.default_rng(0)
    probs = rng.beta(2.0, 5.0, size=4000)
    labels = miscalibrated_labels(probs, true_temperature=2.5, seed=1)
    np.testing.assert_array_equal(labels, jax_cal.miscalibrated_labels(probs, 2.5, seed=1))
    fit_p, fit_y, ev_p, ev_y = probs[::2], labels[::2], probs[1::2], labels[1::2]
    t = fit_temperature(fit_p, fit_y)
    assert 1.8 < t < 3.4
    assert t == pytest.approx(jax_cal.fit_temperature(fit_p, fit_y), abs=1e-6)
    ece_raw = expected_calibration_error(ev_p, ev_y)
    assert ece_raw > 0.02
    assert ece_raw == pytest.approx(jax_cal.expected_calibration_error(ev_p, ev_y), abs=1e-6)
    assert port_cal.nll(ev_p, ev_y) == pytest.approx(jax_cal.nll(ev_p, ev_y), abs=1e-6)
    for method in ("temperature", "isotonic"):
        cal = fit_calibrator(fit_p, fit_y, method=method, weights_signature="sig")
        ref = jax_cal.fit_calibrator(fit_p, fit_y, method=method, weights_signature="sig")
        assert (cal.method, cal.weights_signature) == (ref.method, ref.weights_signature)
        assert cal.temperature == pytest.approx(ref.temperature, abs=1e-6)
        np.testing.assert_allclose(cal.iso_x, ref.iso_x, rtol=0, atol=1e-6)
        np.testing.assert_allclose(cal.iso_y, ref.iso_y, rtol=0, atol=1e-6)
        np.testing.assert_allclose(cal.apply(ev_p), ref.apply(ev_p), rtol=0, atol=1e-6)
        ece_cal = expected_calibration_error(cal.apply(ev_p), ev_y)
        assert ece_cal < ece_raw, (method, ece_raw, ece_cal)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_calibrator_artifact_roundtrip_stale_and_corrupt(tmp_path, writer):
    """An artifact saved by either package loads in both, a signature
    mismatch is a typed refusal (``allow_stale`` skips only that check),
    and a byte-level tamper is caught by the sidecar."""
    path = str(tmp_path / "calibration.json")
    if writer == "port":
        save_calibration(path, Calibrator(method="temperature", temperature=2.25,
                                          weights_signature="sigA"))
    else:
        jax_save_calibration(path, JaxCalibrator(method="temperature", temperature=2.25,
                                                 weights_signature="sigA"))
    loaded = load_calibration(path, expect_signature="sigA")
    assert loaded == Calibrator(method="temperature", temperature=2.25,
                                weights_signature="sigA")
    assert jax_load_calibration(path, expect_signature="sigA").to_json() == loaded.to_json()
    with pytest.raises(StaleArtifact):
        load_calibration(path, expect_signature="sigB")
    assert load_calibration(path, expect_signature="sigB", allow_stale=True) == loaded
    with open(path, "a", encoding="utf-8") as fh:
        fh.write(" ")
    with pytest.raises(CorruptArtifact):
        load_calibration(path, expect_signature="sigA", allow_stale=True)


def test_annotate_records_puts_calibrated_fields_next_to_raw():
    probs = np.random.default_rng(2).random((12, 9)).astype(np.float32)
    cal = Calibrator(method="temperature", temperature=2.0)
    records = [dict(pair_summary(probs, 4), pair_id="a|b")]
    raw_score = records[0]["score"]
    annotate_records(records, cal)
    ref = [dict(pair_summary(probs, 4), pair_id="a|b")]
    jax_cal.annotate_records(ref, JaxCalibrator(method="temperature", temperature=2.0))
    assert records == ref and records[0]["score"] == raw_score
    assert all("p_cal" in c for c in records[0]["top_contacts"])


# ---------------------------------------------------------------------------
# AssemblyRunner: parity, encode-once counters, interface graph
# ---------------------------------------------------------------------------


def test_assembly_records_byte_identical_to_screen(engine, library):
    pairs = all_pairs(library.ids())
    screened = {r["pair_id"]: r for r in ScreenRunner(
        engine, cache=EmbeddingCache(),
        cfg=ScreenConfig(top_k=10, decode_batch=8, encode_batch=8)).screen(
        library, pairs).records}
    result = AssemblyRunner(engine, cache=EmbeddingCache(),
                            cfg=AssemblyConfig(control=False)).assemble(library)
    assert result.pairs_total == result.pairs_scored == len(pairs) == 15
    for rec in result.records:
        ref = screened[rec["pair_id"]]
        for key in ("chain1", "chain2", "n1", "n2", "bucket", "score", "max_prob", "top_k",
                    "top_contacts"):
            assert rec[key] == ref[key], (rec["pair_id"], key)
    order = [(-r["score"], r["pair_id"]) for r in result.records]
    assert order == sorted(order)
    for rec in result.records:
        assert result.maps[rec["pair_id"]].shape == (rec["n1"], rec["n2"])


def test_assembly_matches_the_jax_assembly(engines, library):
    """The same six chains through both AssemblyRunners (control pass on):
    the same pairs and orientation, scores, control scores and the
    complex-level numbers within 1e-4."""
    jeng, peng = engines
    jlib = JaxChainLibrary.synthetic(6, 20, 40, seed=3, knn=KNN, geo_nbrhd_size=GEO)
    ref = JaxAssemblyRunner(jeng, cache=JaxEmbeddingCache(),
                            cfg=JaxAssemblyConfig(decode_batch=4)).assemble(jlib)
    got = AssemblyRunner(peng, cache=EmbeddingCache(),
                         cfg=AssemblyConfig(decode_batch=4)).assemble(library)
    assert (got.unique_encodes, got.decode_batches) == (ref.unique_encodes, ref.decode_batches)
    want = {r["pair_id"]: r for r in ref.records}
    for rec in got.records:
        exp = want[rec["pair_id"]]
        assert (rec["chain1"], rec["chain2"], rec["bucket"]) == (
            exp["chain1"], exp["chain2"], exp["bucket"])
        for key in ("score", "max_prob", "control_score"):
            assert rec[key] == pytest.approx(exp[key], abs=BAR), key
        np.testing.assert_allclose(got.maps[rec["pair_id"]], ref.maps[rec["pair_id"]],
                                   rtol=0, atol=BAR)
    assert got.control_score == pytest.approx(ref.control_score, abs=BAR)
    assert got.interactability == pytest.approx(ref.interactability, abs=BAR)


def test_assembly_encode_once_counters(engine, library):
    cache = EmbeddingCache()
    asm = AssemblyRunner(engine, cache=cache,
                         cfg=AssemblyConfig(control=False, keep_maps=False))
    counters = (assembly_runner._ENCODES, assembly_runner._ENCODE_HITS,
                assembly_runner._PAIRS, assembly_runner._RUNS)
    before = [c.value() for c in counters]
    cold = asm.assemble(library)
    after = [c.value() for c in counters]
    assert cold.unique_encodes == cold.chains == 6 and cold.encode_cache_hits == 0
    assert [a - b for a, b in zip(after, before)] == [6, 0, 15, 1]
    warm = asm.assemble(library)
    assert warm.unique_encodes == 0 and warm.encode_cache_hits == 6
    assert assembly_runner._ENCODES.value() == after[0]
    assert warm.maps == {}


def test_assembly_with_a_repeated_chain_encodes_it_once(engine, library):
    """Four chains, two of them the same chain under two ids: three
    encodes (one per unique content), six pairs, and the twins' pairs with
    a third chain score alike."""
    a, b, c = library.chains[:3]
    lib = ChainLibrary([ChainEntry("twin_of_a", a.raw, a.n), a, b, c])
    result = AssemblyRunner(engine, cache=EmbeddingCache(),
                            cfg=AssemblyConfig(control=True)).assemble(lib)
    assert result.chains == 4 and result.pairs_scored == 6
    assert result.unique_encodes == 3 and result.control_score is not None
    by_pid = {r["pair_id"]: r for r in result.records}
    for other in (b, c):  # the same orientation: the twin first, as a is
        assert by_pid[f"twin_of_a|{other.chain_id}"]["score"] == pytest.approx(
            by_pid[f"{a.chain_id}|{other.chain_id}"]["score"], abs=1e-6)


def test_assembly_interface_graph_control_and_calibration(engine, library):
    raw_result = AssemblyRunner(engine, cache=EmbeddingCache(),
                                cfg=AssemblyConfig(control=False)).assemble(library)
    cal = Calibrator(method="temperature", temperature=2.0,
                     weights_signature=engine.weights_signature())
    result = AssemblyRunner(engine, cache=EmbeddingCache(),
                            cfg=AssemblyConfig(edge_threshold=0.0),
                            calibrator=cal).assemble(library)
    assert result.calibrated
    raw_by_pid = {r["pair_id"]: r for r in raw_result.records}
    for rec in result.records:
        assert rec["score"] == raw_by_pid[rec["pair_id"]]["score"]
        expect = pair_summary(cal.apply(result.maps[rec["pair_id"]]), 10)
        assert rec["calibrated_score"] == expect["score"]
        assert rec["calibrated_max_prob"] == expect["max_prob"]
        for contact in rec["top_contacts"]:
            assert contact["p_cal"] == round(float(cal.apply(np.asarray(contact["p"]))), 6)
        assert 0.0 <= rec["control_score"] <= 1.0
    assert result.control_score == pytest.approx(
        np.mean([r["control_score"] for r in result.records]), abs=1e-6)
    assert len(result.interface["edges"]) == 15
    assert result.interface["nodes"] == result.chain_ids
    assert result.interactability == pytest.approx(
        np.mean([r["calibrated_score"] for r in result.records]), abs=1e-9)
    with pytest.raises(ValueError):
        AssemblyRunner(engine).assemble(library, chain_ids=["only-one"])
    dup = library.ids()[0]
    with pytest.raises(ValueError):
        AssemblyRunner(engine).assemble(library, chain_ids=[dup, dup])


# ---------------------------------------------------------------------------
# CLIs + contracts
# ---------------------------------------------------------------------------


def test_cli_assemble_and_calibrate_contracts(tmp_path, capsys):
    from deepinteract_tpu.assembly import ASSEMBLY_BUNDLE_KIND as JAX_BUNDLE_KIND
    from deepinteract_tpu.robustness import artifacts as jax_artifacts
    from deepinteract_tpu_torch.cli.assemble import main as assemble_main
    from deepinteract_tpu_torch.cli.calibrate import main as calibrate_main
    from tools.check_cli_contract import check_cli_contract_text

    lib = ["--synthetic_chains", "6", "--synthetic_len", "20,40", "--screen_batch", "4"]
    cal_path = str(tmp_path / "calibration.json")
    assert calibrate_main([*TINY_CLI_ARGS, *lib, "--calibration_out", cal_path]) == 0
    rec = check_cli_contract_text(capsys.readouterr().out, "calibrate")
    assert rec["ok"] and rec["improved"] and rec["ece_calibrated"] < rec["ece_raw"]
    assert rec["pairs"] == 15 and rec["weights_signature"] == "torch-init-seed42"
    assert load_calibration(cal_path, expect_signature="torch-init-seed42").method == "temperature"

    out = str(tmp_path / "asm")
    assert assemble_main([*TINY_CLI_ARGS, *lib, "--out", out, "--calibration", cal_path]) == 0
    rec = check_cli_contract_text(capsys.readouterr().out, "assemble")
    assert rec["ok"] and rec["calibrated"] and rec["chains"] == 6
    assert rec["pairs_scored"] == 15 and rec["unique_encodes"] == 6
    assert rec["control_score"] is not None
    # The bundle and the maps are durable artifacts the JAX package verifies.
    bundle = jax_artifacts.verify_json(rec["bundle_out"], kind=JAX_BUNDLE_KIND)
    assert bundle["schema"] == "assembly-bundle/v1" and bundle["calibration"] == cal_path
    jax_artifacts.verify_file(rec["maps_out"], kind="assembly-maps")
    with np.load(rec["maps_out"]) as maps:
        assert len(maps.files) == 15
    with open(rec["ranked_out"]) as fh:
        rows = [json.loads(ln) for ln in fh]
    assert len(rows) == 15 and all("calibrated_score" in r for r in rows)


def test_cli_predict_top_k_and_calibration_contract(tmp_path, capsys):
    from deepinteract_tpu_torch.cli.predict import main as predict_main
    from tools.check_cli_contract import check_cli_contract_text

    raw = random_raw_complex(30, 24, np.random.default_rng(5))
    npz = str(tmp_path / "c.npz")
    save_complex_npz(npz, raw["graph1"], raw["graph2"], raw["examples"])
    cal_path = str(tmp_path / "cal.json")
    save_calibration(cal_path, Calibrator(method="temperature", temperature=2.0,
                                          weights_signature="torch-init-seed42"))
    out = str(tmp_path / "pred")
    argv = [*TINY_CLI_ARGS, "--input_npz", npz, "--output_dir", out, "--top_k", "7"]
    assert predict_main(argv + ["--calibration", cal_path]) == 0
    rec = check_cli_contract_text(capsys.readouterr().out, "predict_topk")
    probs = np.load(os.path.join(out, "contact_prob_map.npy"))
    want = pair_summary(probs, 7)
    assert rec["top_k"] == 7 and rec["value"] == round(want["score"], 6)
    assert (rec["n1"], rec["n2"]) == (30, 24) and "calibrated_score" in rec
    with open(rec["top_contacts_out"]) as fh:
        summary = json.load(fh)
    assert [(c["i"], c["j"]) for c in summary["top_contacts"]] == [
        (c["i"], c["j"]) for c in want["top_contacts"]]
    assert all("p_cal" in c for c in summary["top_contacts"])
    # A calibration fitted for other weights is refused before any forward.
    with pytest.raises(StaleArtifact):
        predict_main(argv + ["--calibration", cal_path, "--seed", "7"])
