"""The port's ``cli/fsck.py`` over the port's artifacts, against the JAX
package's fsck.

* Trees written by the port's own writers (checkpoint steps, the
  ``trainer_state.json`` cursor, heartbeats, supervisor and fleet state
  with agreement ledgers, an index manifest and shard, a calibration, an
  assembly bundle with its maps, embedding spills, a screen manifest,
  tmp strays, an orphan sidecar), clean and with the same faults
  injected, go through both fscks: their ``fsck/v1`` records agree,
  report-only and with ``--quarantine``.
* The JAX package's fsck tests (``tests/test_fleet.py``'s stale
  heartbeat, ``tests/test_elastic.py``'s fleet records,
  ``tests/test_artifacts.py``'s injected corruptions) run against the
  port.
* The final line passes ``tools/check_cli_contract.py fsck``.
"""

import contextlib
import io
import json
import os
import shutil
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from deepinteract_tpu.cli import fsck as jax_fsck
from deepinteract_tpu_torch.calibration.calibrator import Calibrator, save_calibration
from deepinteract_tpu_torch.cli import fsck
from deepinteract_tpu_torch.cli.assemble import write_bundle
from deepinteract_tpu_torch.index import format as index_format
from deepinteract_tpu_torch.obs.heartbeat import Heartbeat
from deepinteract_tpu_torch.robustness import artifacts
from deepinteract_tpu_torch.screening.embcache import EmbeddingCache
from deepinteract_tpu_torch.screening.manifest import ScreenManifest
from deepinteract_tpu_torch.training import loop
from deepinteract_tpu_torch.training.checkpoint import CheckpointConfig, Checkpointer

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from tools.check_cli_contract import check_cli_contract_text  # noqa: E402


def run(main, root, *flags):
    """(rc, fsck/v1 record, stdout) of one fsck run."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([str(root), *flags])
    out = buf.getvalue()
    return rc, check_cli_contract_text(out, "fsck"), out


def _mk_ckpt(root):
    return Checkpointer(CheckpointConfig(directory=str(root / "ckpt")))


def _save_steps(ck, n=2):
    for step in range(1, n + 1):
        ck.save(step, {"w": torch.full((4,), float(step))}, {"val_ce": 1.0 / step})
    ck.wait()


def _flip_byte(path, at=None):
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2 if at is None else at] ^= 0x08
    open(path, "wb").write(bytes(raw))


def _spill_one(cache, key="k1"):
    feats = np.random.default_rng(3).normal(size=(16, 4)).astype(np.float32)
    cache.put(key, feats, 7)
    cache.put("evictor", feats, 7)  # capacity 1: evicts key -> spill


def write_port_tree(root):
    """Every kind of artifact the port writes, through its own writers;
    the fleet serves sigA and the index is frozen at sigB."""
    ck = _mk_ckpt(root)
    _save_steps(ck)
    ck.save_midepoch(2, 5, {"w": torch.zeros(4)})
    ck.wait()
    ck.close()
    loop.write_sidecar(str(root / "ckpt"), {
        "epoch": 2, "stopper_best": 0.5,
        "cursor": {"epoch": 2, "batch_index": 5, "opt_step": 9, "skips_used": 0,
                   "skipped_steps": 0, "loss_ledger": [0.5, 0.4]}})
    hb = Heartbeat(str(root / "ckpt" / "obs" / "heartbeat_p0.json"), interval_s=60.0)
    hb.progress(step=3)
    hb.write_now()
    artifacts.atomic_write(str(root / "heartbeat_w1.json"),
                           json.dumps({"host": "w1", "written_ts": time.time() - 9999.0}),
                           fsync=False)
    artifacts.atomic_write(str(root / "ckpt" / "train_supervisor_state.json"),
                           json.dumps({"restarts": 1}), fsync=False)
    fleet = root / "fleet"
    fleet.mkdir()
    artifacts.atomic_write(str(fleet / "fleet_state.json"), json.dumps({
        "updated_ts": 1.0, "restarts_total": 0,
        "workers": {"w1": {"state": "healthy", "health": {"weights_signature": "sigA"}}},
        "autoscale": {"target_workers": 1, "scale_ups": 0, "scale_downs": 0},
        "versions": {"weights": {"sigA": 1.0}, "promotions": 0}}), fsync=False)
    (fleet / "agreement_sigZ.jsonl").write_text('{"outcome": "agree"}\n')
    idx = str(root / "index")
    pid = index_format.partition_id(64, 0)
    index_format.write_partition(idx, pid, 64, ["a", "b"], [30, 40],
                                 np.zeros((2, 64, 8), np.float32),
                                 np.zeros((2, 8), np.float32), "sigB")
    index_format.write_manifest(idx, {
        "format_version": 1, "weights_signature": "sigB", "library_signature": "lib",
        "input_indep": False, "compute_dtype": "float32", "feat_dim": 8,
        "partition_size": 2, "num_chains": 2,
        "partitions": [{"partition_id": pid, "file": f"partitions/{pid}.npz", "bucket": 64,
                        "chains": ["a", "b"], "lengths": [30, 40]}]})
    save_calibration(str(root / "calibration.json"),
                     Calibrator(method="temperature", temperature=2.0,
                                weights_signature="sigA"))
    (root / "asm").mkdir()
    result = types.SimpleNamespace(
        records=[{"pair_id": "a|b", "score": 0.5}],
        maps={"a|b": np.zeros((3, 4), np.float32)}, pairs_total=1,
        interface={"nodes": ["a", "b"], "edges": [["a", "b"]]},
        summary=lambda: {"pairs_total": 1})
    write_bundle(str(root / "asm" / "out"), result, "sigA", None)
    cache = EmbeddingCache(capacity=1, spill_dir=str(root / "sp"))
    _spill_one(cache)
    m, _ = ScreenManifest.load_or_create(str(root / "m.json"), "sig", 2)
    m.mark_done("a|b", {"pair_id": "a|b"})
    m.flush()
    (root / "m.json.777.tmp").write_text("torn")
    artifacts.atomic_write_artifact(str(root / "gone.json"), "{}", "demo")
    os.unlink(root / "gone.json")
    return cache


def inject_faults(root):
    """A bit flip in a checkpoint payload, a torn step, a truncated
    manifest, a flipped byte in the cursor, a truncated sidecar, a
    flipped spill, a torn heartbeat, a damaged fleet record."""
    _flip_byte(str(root / "ckpt" / "last" / "2" / "state.pt"))
    os.unlink(root / "ckpt" / "best" / "1" / "_CHECKPOINT_METADATA")
    raw = open(root / "m.json", "rb").read()
    open(root / "m.json", "wb").write(raw[: len(raw) // 2])
    _flip_byte(str(root / "ckpt" / "trainer_state.json"), at=3)
    sc = artifacts.sidecar_path(str(root / "calibration.json"))
    open(sc, "w").write(open(sc).read()[:19])
    _flip_byte(str(root / "sp" / "emb_k1.npz"))
    open(root / "ckpt" / "obs" / "heartbeat_p0.json", "w").write('{"torn": ')
    state = root / "fleet" / "fleet_state.json"
    state.write_text(state.read_text().replace('"target_workers": 1', '"target_workers": -1'))


def test_fsck_agrees_with_jax_on_the_ports_trees(tmp_path):
    clean = tmp_path / "clean"
    clean.mkdir()
    write_port_tree(clean)
    rc_j, want, _ = run(jax_fsck.main, clean)
    rc_p, got, out = run(fsck.main, clean)
    assert (rc_p, got) == (rc_j, want)
    assert rc_p == 0 and got["ok"] and got["corrupt"] == 0
    # verified: 2 best + 1 last + 1 mid steps, the cursor, the shard and its
    # manifest, the calibration, the bundle and its maps, the spill, the
    # screen manifest.
    assert got["verified"] == 12
    assert got["unverified"] == 4  # heartbeats, supervisor and fleet state
    assert got["resume_cursor"] == {"epoch": 2, "batch_index": 5, "opt_step": 9,
                                    "skips_used": 0}
    assert got["fleet_versions"]["workers_by_version"] == {"sigA": 1}
    assert got["stale_version_ledgers"] == [str(clean / "fleet" / "agreement_sigZ.jsonl")]
    assert got["stale_index_partitions"] == [str(clean / "index" / "index_manifest.json")]
    assert got["index_partitions"] == 1 and got["calibrations"] == 1
    assert got["assembly_bundles"] == 1 and got["stale_calibrations"] == []
    assert got["stale_heartbeats"] == 1 and got["stale_heartbeat_hosts"] == ["w1"]
    assert got["tmp_files"] == 1 and got["orphan_sidecars"] == 1
    assert "stale heartbeat" in out and "orphan tmp" in out

    faulted = {}
    for name in ("jax", "port"):
        faulted[name] = tmp_path / name
        shutil.copytree(clean, faulted[name])
        inject_faults(faulted[name])
    rc_j, want, _ = run(jax_fsck.main, faulted["jax"])
    rc_p, got, _ = run(fsck.main, faulted["port"])

    def same(rec, root):
        return json.loads(json.dumps(rec).replace(str(root), "ROOT"))

    assert rc_p == rc_j == 1
    assert same(got, faulted["port"]) == same(want, faulted["jax"])
    assert got["corrupt"] == 8 and not got["ok"]
    assert got["fleet_versions"] is None and got["resume_cursor"] is None
    for name, main in (("jax", jax_fsck.main), ("port", fsck.main)):
        rc, rec, _ = run(main, faulted[name], "--quarantine")
        assert rc == 0 and rec["quarantined"] == rec["corrupt"] == 8 and rec["recovered"]
        rc, rec, _ = run(main, faulted[name])
        assert rc == 0 and rec["corrupt"] == 0 and rec["tmp_files"] == 0
        assert rec["orphan_sidecars"] == 0
        faulted[name] = rec
    assert same(faulted["port"], tmp_path / "port") == same(faulted["jax"], tmp_path / "jax")


def test_fsck_bad_invocation_exits_2(tmp_path, capsys):
    assert fsck.main([str(tmp_path / "missing")]) == 2
    assert "is not a directory" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The JAX package's fsck tests, against the port
# ---------------------------------------------------------------------------


def test_fsck_reports_stale_heartbeat(tmp_path):
    """tests/test_fleet.py::test_fsck_reports_stale_heartbeat."""
    stale = {"host": "x", "written_ts": time.time() - 9999.0}
    artifacts.atomic_write(str(tmp_path / "heartbeat_w1.json"), json.dumps(stale), fsync=False)
    fresh = {"host": "y", "written_ts": time.time()}
    artifacts.atomic_write(str(tmp_path / "heartbeat_w2.json"), json.dumps(fresh), fsync=False)
    rc, record, out = run(fsck.main, tmp_path)
    assert rc == 0  # staleness is informational, never corruption
    assert record["stale_heartbeats"] == 1
    assert "stale heartbeat" in out


def write_fleet_state(tmp_path, payload):
    path = tmp_path / "fleet_state.json"
    artifacts.atomic_write(str(path), json.dumps(payload), fsync=False)
    return path


def test_fsck_reports_fleet_versions_and_stale_ledgers(tmp_path):
    """tests/test_elastic.py::test_fsck_reports_fleet_versions_and_stale_ledgers."""
    write_fleet_state(tmp_path, {
        "updated_ts": 1.0, "restarts_total": 0, "preemptions": 1,
        "workers": {
            "w1": {"state": "healthy", "health": {"weights_signature": "v1"}},
            "w2": {"state": "healthy", "health": {"weights_signature": "v2"}},
            "w3": {"state": "retired", "health": {"weights_signature": "v0"}},
        },
        "autoscale": {"target_workers": 2, "scale_ups": 1, "scale_downs": 0, "errors": 0},
        "versions": {"weights": {"v1": 3.0, "v2": 1.0},
                     "shadow": {"candidate": "v3", "fraction": 0.5}, "promotions": 1},
    })
    for name in ("agreement_v3.jsonl", "agreement_v9.jsonl"):
        (tmp_path / name).write_text('{"outcome": "agree"}\n')
    rc, record, out = run(fsck.main, tmp_path)
    assert rc == 0
    fleet = record["fleet_versions"]
    assert fleet["workers_by_version"] == {"v1": 1, "v2": 1}
    assert fleet["autoscale_target"] == 2
    assert fleet["version_weights"] == {"v1": 3.0, "v2": 1.0}
    # v3 is the live shadow candidate; only v9's ledger is stale.
    assert record["stale_version_ledgers"] == [str(tmp_path / "agreement_v9.jsonl")]
    assert "stale version ledger" in out


def test_fsck_quarantines_malformed_fleet_records(tmp_path):
    """tests/test_elastic.py::test_fsck_quarantines_malformed_fleet_records."""
    path = write_fleet_state(tmp_path, {
        "updated_ts": 1.0, "restarts_total": 0, "workers": {},
        "autoscale": {"target_workers": "three"},
        "versions": {"weights": {"v1": -2}, "shadow": {"fraction": 1.0}, "promotions": True},
    })
    rc, record, _ = run(fsck.main, tmp_path)
    assert rc == 1
    assert record["ok"] is False
    assert record["corrupt_paths"] == [str(path)]
    assert record["fleet_versions"] is None
    rc, record, _ = run(fsck.main, tmp_path, "--quarantine")
    assert rc == 0  # recovered: the damage was moved aside
    assert record["quarantined"] == 1
    assert not path.exists()


def test_fsck_detects_every_injected_corruption_and_recovers(tmp_path):
    """tests/test_artifacts.py::test_fsck_detects_every_injected_corruption_
    and_recovers, over the port's writers: a calibration's truncated
    sidecar takes the place of the JAX test's torn tuning store, which
    the port does not write."""
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    # 1+2) checkpoints: two steps, then bit-flip last/2 and tear best/1.
    ck = _mk_ckpt(run_dir)
    _save_steps(ck, n=2)
    ck.close()
    _flip_byte(str(run_dir / "ckpt" / "last" / "2" / "state.pt"))
    os.unlink(str(run_dir / "ckpt" / "best" / "1" / "_CHECKPOINT_METADATA"))
    # 3) screen manifest: truncated payload.
    m, _ = ScreenManifest.load_or_create(str(run_dir / "m.json"), "sig", 2)
    m.mark_done("a|b", {"pair_id": "a|b"})
    m.flush()
    raw = open(run_dir / "m.json", "rb").read()
    open(run_dir / "m.json", "wb").write(raw[: len(raw) // 2])
    # 4) calibration: truncated SIDECAR.
    cal_path = str(run_dir / "calibration.json")
    save_calibration(cal_path, Calibrator(method="temperature", temperature=2.0,
                                          weights_signature="sig"))
    sc = artifacts.sidecar_path(cal_path)
    open(sc, "w").write(open(sc).read()[:19])
    # 5) embedding spill: bit-flipped npz.
    cache = EmbeddingCache(capacity=1, spill_dir=str(run_dir / "sp"))
    _spill_one(cache)
    spill = cache._spill_path("k1")
    _flip_byte(spill)
    # 6) torn per-process heartbeat (the training loop's naming).
    (run_dir / "obs").mkdir()
    open(run_dir / "obs" / "heartbeat_p0.json", "w").write('{"torn": ')
    # Healthy neighbors that must NOT be flagged: a verified sidecar file,
    # a legacy heartbeat, and an orphaned tmp from a killed write.
    artifacts.atomic_write_artifact(str(run_dir / "good.json"), "{}", "demo")
    open(run_dir / "heartbeat.json", "w").write('{"step": 3}')
    open(run_dir / "m.json.777.tmp", "w").write("torn")

    rc, rec, _ = run(fsck.main, run_dir)
    assert rc == 1
    assert rec["schema"] == "fsck/v1"
    assert rec["corrupt"] == 6, rec["corrupt_paths"]
    assert rec["ok"] is False and rec["quarantined"] == 0
    assert rec["tmp_files"] == 1
    flagged = set(rec["corrupt_paths"])
    assert str(run_dir / "ckpt" / "last" / "2") in flagged
    assert str(run_dir / "ckpt" / "best" / "1") in flagged
    assert str(run_dir / "m.json") in flagged
    assert cal_path in flagged
    assert spill in flagged
    assert str(run_dir / "obs" / "heartbeat_p0.json") in flagged
    assert str(run_dir / "good.json") not in flagged
    assert str(run_dir / "heartbeat.json") not in flagged

    # --quarantine: everything corrupt moves aside, exit 0 (recovered),
    # and a second pass is clean.
    rc, rec, _ = run(fsck.main, run_dir, "--quarantine")
    assert rc == 0
    assert rec["quarantined"] == rec["corrupt"] == 6
    assert rec["recovered"] is True and rec["tmp_swept"] == 1
    rc, rec, _ = run(fsck.main, run_dir)
    assert rc == 0
    assert rec["ok"] is True and rec["corrupt"] == 0
    # The subsystems recover from the quarantined state: the checkpoint
    # restore walks to a verified step, the manifest starts fresh, the
    # calibration is gone, the spill re-encodes.
    ck2 = _mk_ckpt(run_dir)
    out = ck2.restore(None, which="last")
    assert float(out["w"][0]) in (1.0, 2.0)
    ck2.close()
    _, resumed = ScreenManifest.load_or_create(str(run_dir / "m.json"), "sig", 2)
    assert not resumed
    assert not os.path.exists(cal_path)
    assert cache.get("k1") is None


@pytest.mark.parametrize("flag", ["--sweep_tmp", "--quarantine"])
def test_fsck_sweeps_tmp_strays_and_orphan_sidecars(tmp_path, flag):
    (tmp_path / "a.json.1.tmp").write_text("torn")
    artifacts.atomic_write_artifact(str(tmp_path / "b.json"), "{}", "demo")
    os.unlink(tmp_path / "b.json")
    rc, rec, out = run(fsck.main, tmp_path)
    assert rc == 0 and rec["tmp_files"] == 1 and rec["orphan_sidecars"] == 1
    assert "orphan sidecar" in out and "(swept)" not in out
    rc, rec, out = run(fsck.main, tmp_path, flag)
    assert rc == 0 and rec["tmp_swept"] == 1 and "(swept)" in out
    assert sorted(os.listdir(tmp_path)) == []
