"""The port's front-end CLIs against the JAX package's: ``cli.build_dataset``
and ``cli.analyze`` over PDB pairs written here, ``cli.predict`` from two
PDB files (``--left_pdb/--right_pdb/--save_npz``) on the CPU with carried
weights, and a ``{"left_pdb", "right_pdb"}`` request to the port's
server. The tree the builder writes is read by the port's loader."""

import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from deepinteract_tpu.cli import analyze as jax_analyze
from deepinteract_tpu.cli import build_dataset as jax_build
from deepinteract_tpu.data.graph import stack_complexes as jax_stack
from deepinteract_tpu.data.io import load_complex_npz as jax_load, to_paired_complex
from deepinteract_tpu.models.model import DeepInteract as JaxDeepInteract
from deepinteract_tpu.pipeline.pair import convert_pdb_pair_to_complex as jax_convert_pair
from deepinteract_tpu.serving import server as jax_server
from deepinteract_tpu_torch import constants
from deepinteract_tpu_torch.cli import analyze, build_dataset
from deepinteract_tpu_torch.cli import predict as port_predict
from deepinteract_tpu_torch.cli.predict import predict_complex
from deepinteract_tpu_torch.data.datasets import DIPSDataset
from deepinteract_tpu_torch.data.loader import BucketedLoader
from deepinteract_tpu_torch.pipeline.pair import convert_pdb_pair_to_complex
from deepinteract_tpu_torch.robustness.preemption import PreemptionGuard
from deepinteract_tpu_torch.serving import EngineConfig, InferenceEngine, ServingServer
from deepinteract_tpu_torch.serving import server as port_server
from deepinteract_tpu_torch.weights import save_npz, seeded_signature
from test_torch_pipeline import assert_npz_equal
from torch_port_helpers import (CHUNKS, HEADS, HIDDEN, http_post, jax_cfg, port_cfg,
                                random_variables, wait_until, write_bound_pdb, write_helix_pdb,
                                write_mixed_pdb)

SMALL = ["--num_gnn_hidden_channels", str(HIDDEN), "--num_gnn_attention_heads", str(HEADS),
         "--num_interact_layers", str(CHUNKS), "--num_interact_hidden_channels", str(HIDDEN)]
PAIRS = (("aaaa", 24, 22), ("bbbb", 30, 21), ("cccc", 22, 26), ("dddd", 27, 23), ("eeee", 21, 25))
SPLITS = ("train", "val", "test")


def write_pair(d, stem, n1, n2, first=0):
    write_mixed_pdb(os.path.join(d, f"{stem}_l_u.pdb"), n1, first=first)
    write_mixed_pdb(os.path.join(d, f"{stem}_r_u.pdb"), n2, chain="B", x0=11.0,
                    first=first + 5)


def split_files(root):
    out = {}
    for mode in SPLITS:
        with open(os.path.join(root, f"pairs-postprocessed-{mode}.txt")) as f:
            out[mode] = f.read()
    return out


def processed(root):
    out = []
    for dirpath, _, names in os.walk(os.path.join(root, "processed")):
        out += [os.path.relpath(os.path.join(dirpath, n), root) for n in names]
    return sorted(out)


def build_both(tmp_path, src, *flags):
    """The JAX builder and the port's over one input tree: (JAX root, port
    root), after checking they wrote the same names, the same split files
    and equal npz arrays."""
    roots = str(tmp_path / "jax_ds"), str(tmp_path / "port_ds")
    for main, root in zip((jax_build.main, build_dataset.main), roots):
        assert main(["--input_dir", str(src), "--output_dir", root, *flags]) == 0
    assert processed(roots[1]) == processed(roots[0])
    assert split_files(roots[1]) == split_files(roots[0])
    for rel in processed(roots[0]):
        assert_npz_equal(os.path.join(roots[1], rel), os.path.join(roots[0], rel))
    return roots


@pytest.fixture(scope="module")
def pair_tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("build")
    src = tmp / "raw"
    os.makedirs(src)
    for i, (stem, n1, n2) in enumerate(PAIRS):
        write_pair(str(src), stem, n1, n2, first=i)
    return tmp, src, build_both(tmp, src, "--knn", "6", "--geo_nbrhd_size", "2")


def test_build_dataset_matches_jax_and_feeds_the_loader(pair_tree):
    _, src, (jax_root, root) = pair_tree
    assert processed(root) == [f"processed/{stem}.npz" for stem, _, _ in PAIRS]
    splits = {mode: text.split() for mode, text in split_files(root).items()}
    assert sorted(sum(splits.values(), [])) == [f"{stem}.npz" for stem, _, _ in PAIRS]
    assert (len(splits["test"]), len(splits["val"])) == (1, 1)  # 20% of 5, 25% of 4
    items = list(DIPSDataset(root, "train"))
    assert len(items) == 3 and items[0]["graph1"]["node_feats"].shape[1] == 113
    batches = list(BucketedLoader(DIPSDataset(root, "train")))
    assert sum(int(b.graph1.num_nodes.shape[0]) for b in batches) == 3
    # A rerun keeps the files it finds and writes the same splits.
    assert build_dataset.main(["--input_dir", str(src), "--output_dir", root,
                               "--knn", "6", "--geo_nbrhd_size", "2"]) == 0
    assert split_files(root) == split_files(jax_root)


@pytest.mark.parametrize("layout", ["dirs", "dotted"])
def test_build_dataset_names_stay_distinct(tmp_path, layout):
    src = tmp_path / "raw"
    if layout == "dirs":
        for sub in ("setA", "setB"):
            os.makedirs(src / sub)
            write_pair(str(src / sub), "1abc", 21, 22)
        want = ["processed/setA__1abc.npz", "processed/setB__1abc.npz"]
    else:
        os.makedirs(src)
        for i, stem in enumerate(("1abc.pdb1", "1abc.pdb2")):
            write_pair(str(src), stem, 21, 22, first=i)
        want = ["processed/1abc.pdb1.npz", "processed/1abc.pdb2.npz"]
    _, root = build_both(tmp_path, src, "--knn", "4", "--geo_nbrhd_size", "2")
    assert processed(root) == want


def test_build_dataset_bound_and_size_filter(tmp_path):
    src = tmp_path / "raw"
    os.makedirs(src / "sub")
    write_bound_pdb(str(src / "c1.pdb"), 24, 22)
    write_bound_pdb(str(src / "sub" / "c2.pdb"), 21, 23, x0=10.0)
    _, root = build_both(tmp_path, src, "--bound", "--chain1", "B", "--chain2", "A",
                         "--knn", "4", "--geo_nbrhd_size", "2")
    assert processed(root) == ["processed/c1.npz", "processed/sub__c2.npz"]
    with np.load(os.path.join(root, "processed", "c1.npz")) as z:
        assert z["g1_node_feats"].shape[0] == 22 and z["examples"][:, 2].sum() > 0
    # Over the residue limit: written, kept out of the splits, unless asked.
    big = tmp_path / "big"
    os.makedirs(big)
    write_helix_pdb(str(big / "big_l_u.pdb"), n_res=constants.RESIDUE_COUNT_LIMIT + 8)
    write_helix_pdb(str(big / "big_r_u.pdb"), n_res=21)
    for flags, want in (((), ""), (("--no_size_filter",), "big.npz\n")):
        _, root = build_both(tmp_path / f"big{len(flags)}", big, "--knn", "4",
                             "--geo_nbrhd_size", "2", *flags)
        assert "".join(split_files(root).values()) == want
    assert build_dataset.main(["--input_dir", str(tmp_path / "empty_nothing"),
                               "--output_dir", str(tmp_path / "o")]) == 1


@pytest.mark.parametrize("cmd", ["stats", "partition", "leakage", "lengths"])
def test_analyze_prints_the_jax_output(pair_tree, cmd, capsys):
    tmp, _, (jax_root, root) = pair_tree
    outputs = []
    for main, r in ((jax_analyze.main, jax_root), (analyze.main, root)):
        argv = [cmd, "--root", r]
        if cmd == "stats":
            argv += ["--csv_out", os.path.join(r, "stats.csv")]
        rc = main(argv)
        extra = (open(os.path.join(r, "stats.csv")).read() if cmd == "stats"
                 else split_files(r) if cmd == "partition" else None)
        outputs.append((rc, capsys.readouterr().out, extra))
    assert outputs[1] == outputs[0]
    if cmd == "leakage":  # the helices share their residue cycle: leaks, rc 1
        assert outputs[1][0] == 1 and "LEAK" in outputs[1][1]
    else:
        assert outputs[1][0] == 0 and json.loads(outputs[1][1].splitlines()[-1])


# ---------------------------------------------------------------------------
# cli.predict from two PDB files


@pytest.fixture(scope="module")
def pdb_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("predict")
    left = write_mixed_pdb(str(d / "l.pdb"), 30)
    right = write_mixed_pdb(str(d / "r.pdb"), 26, chain="B", x0=11.0, first=7)
    return d, left, right


def test_predict_cli_from_pdb_files_matches_jax(pdb_pair, tmp_path):
    """The JAX CLI's PDB path (``convert_pdb_pair_to_complex(...,
    with_labels=False)``, default bucketing, softmax) against the port's
    ``cli.predict --left_pdb --right_pdb --save_npz --weights`` on the same
    weights: the map within 1e-4, the saved npz equal to the JAX one."""
    _, left, right = pdb_pair
    jax_raw = jax_convert_pair(left, right, output_npz=str(tmp_path / "jax.npz"),
                               with_labels=False)
    batch = jax_stack([to_paired_complex(jax_raw)])
    jcfg = jax_cfg(limit=constants.NODE_COUNT_LIMIT)
    variables = random_variables(jcfg, batch, seed=14)
    logits = JaxDeepInteract(jcfg).apply(variables, batch.graph1, batch.graph2, train=False)
    ref = np.asarray(jax.nn.softmax(logits, axis=-1))[0, :30, :26, 1]

    save_npz(str(tmp_path / "w.npz"), variables)
    out = tmp_path / "out"
    assert port_predict.main(["--left_pdb", left, "--right_pdb", right,
                              "--save_npz", str(tmp_path / "port.npz"),
                              "--output_dir", str(out), "--weights", str(tmp_path / "w.npz"),
                              "--device", "cpu", *SMALL]) == 0
    probs = np.load(out / "contact_prob_map.npy")
    assert probs.shape == (30, 26)
    np.testing.assert_allclose(probs, ref, rtol=1e-4, atol=1e-4)
    assert_npz_equal(tmp_path / "port.npz", tmp_path / "jax.npz")
    np.testing.assert_array_equal(jax_load(str(tmp_path / "port.npz"))["examples"][:, 2], 0)


def test_predict_topk_and_calibration_on_a_pdb_pair(pdb_pair, tmp_path, capsys):
    """``--top_k`` and ``--calibration`` on a PDB pair give what they give
    on the npz the pair featurizes to."""
    from deepinteract_tpu_torch.calibration.calibrator import fit_calibrator, save_calibration

    _, left, right = pdb_pair
    rng = np.random.default_rng(0)
    cal = fit_calibrator(rng.random(400), (rng.random(400) < 0.3).astype(np.float64),
                         weights_signature=seeded_signature(42))
    save_calibration(str(tmp_path / "cal.json"), cal)
    common = ["--top_k", "5", "--calibration", str(tmp_path / "cal.json"), "--device", "cpu",
              *SMALL]
    assert port_predict.main(["--left_pdb", left, "--right_pdb", right, "--save_npz",
                              str(tmp_path / "c.npz"), "--output_dir", str(tmp_path / "a"),
                              *common]) == 0
    line_pdb = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert port_predict.main(["--input_npz", str(tmp_path / "c.npz"), "--output_dir",
                              str(tmp_path / "b"), *common]) == 0
    line_npz = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line_pdb["n1"] == 30 and "calibrated_score" in line_pdb
    assert {k: v for k, v in line_pdb.items() if not k.endswith("_out")} == \
        {k: v for k, v in line_npz.items() if not k.endswith("_out")}
    for name in ("contact_prob_map.npy", "graph1_node_feats.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "a" / name),
                                      np.load(tmp_path / "b" / name))
    assert (json.loads((tmp_path / "a" / "top_contacts.json").read_text())
            == json.loads((tmp_path / "b" / "top_contacts.json").read_text()))


def test_predict_needs_an_input_and_refuses_without_gpu(pdb_pair, tmp_path, capsys):
    _, left, right = pdb_pair
    with pytest.raises(SystemExit):
        port_predict.main(["--left_pdb", left, "--output_dir", str(tmp_path)])
    assert "provide --input_npz or both --left_pdb and --right_pdb" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the refusal needs one without")
    assert port_predict.main(["--left_pdb", left, "--right_pdb", right,
                              "--output_dir", str(tmp_path)]) != 0
    assert "--device cpu" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Serving a PDB pair


def test_raw_from_json_matches_jax(pdb_pair):
    _, left, right = pdb_pair
    for bad in ({}, {"left_pdb": left}):
        errors = []
        for mod in (jax_server, port_server):
            with pytest.raises(ValueError) as info:
                mod.raw_from_json(bad)
            errors.append(str(info.value))
        assert errors[0] == errors[1]
    got = port_server.raw_from_json({"left_pdb": left, "right_pdb": right})
    want = jax_server.raw_from_json({"left_pdb": left, "right_pdb": right})
    for g in ("graph1", "graph2"):
        for key, value in want[g].items():
            np.testing.assert_array_equal(got[g][key], value, err_msg=key)
    np.testing.assert_array_equal(got["examples"], want["examples"])


def test_server_answers_a_pdb_pair_as_predict_complex(pdb_pair):
    _, left, right = pdb_pair
    engine = InferenceEngine(port_cfg(), cfg=EngineConfig(max_batch=1, result_cache_size=0),
                             device="cpu", seed=3)
    srv = ServingServer(engine, port=0)
    guard = PreemptionGuard(log=lambda s: None)
    rc = {}
    thread = threading.Thread(target=lambda: rc.setdefault("rc", srv.run(guard=guard)),
                              daemon=True)
    thread.start()
    try:
        wait_until(lambda: srv._serve_thread is not None)
        host, port = srv.address
        status, body, _ = http_post(host, port, body=json.dumps(
            {"left_pdb": left, "right_pdb": right}).encode(), timeout=60)
        out = json.loads(body)
        assert status == 200, out
        probs = np.asarray(out["contact_probs"])
        ref = predict_complex(convert_pdb_pair_to_complex(left, right, with_labels=False),
                              engine.model, "cpu")["contact_prob_map"]
        assert probs.shape == (30, 26) and (out["n1"], out["n2"]) == (30, 26)
        np.testing.assert_allclose(probs, ref, rtol=0, atol=1e-6)
        status, body, _ = http_post(host, port, body=json.dumps(
            {"left_pdb": left, "right_pdb": "/no/such.pdb"}).encode())
        assert status == 400 and json.loads(body)["error"]
    finally:
        guard.request("test teardown")
        thread.join(timeout=30)
    assert not thread.is_alive() and rc.get("rc") == 0
