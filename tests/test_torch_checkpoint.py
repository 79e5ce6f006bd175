"""The port's durable artifacts and checkpointer against the JAX package's
(robustness/artifacts.py, training/checkpoint.py): sidecars that each
package verifies for the other, the corruption fuzz, the storage fault
sites, and a ``Checkpointer`` that keeps, ranks and walks back to the same
steps as the orbax one on the same saves and corruptions."""

import json
import os

import numpy as np
import pytest
import torch

from deepinteract_tpu.robustness import artifacts as jax_artifacts
from deepinteract_tpu.robustness import faults as jax_faults
from deepinteract_tpu.training import checkpoint as jax_checkpoint
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.robustness import artifacts, faults
from deepinteract_tpu_torch.training import checkpoint
from deepinteract_tpu_torch.training.checkpoint import CheckpointConfig, Checkpointer
from deepinteract_tpu_torch.training.loop import host_snapshot
from deepinteract_tpu_torch.training.steps import create_train_state
from torch_port_helpers import port_cfg

PACKAGES = {"port": artifacts, "jax": jax_artifacts}


@pytest.fixture(autouse=True)
def _clean_fault_state(monkeypatch):
    monkeypatch.delenv("DI_FAULTS", raising=False)
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


def _flip(path, pos=0):
    data = bytearray(open(path, "rb").read())
    data[pos] ^= 0x10
    with open(path, "wb") as f:
        f.write(bytes(data))


def _truncate(path):
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[: len(data) // 2])


def _write(pkg, tmp_path, tree: bool) -> str:
    if not tree:
        path = str(tmp_path / "a.json")
        pkg.atomic_write_artifact(path, json.dumps({"k": list(range(50))}), "demo",
                                  version=2, extra={"weights_signature": "s"})
        return path
    path = str(tmp_path / "step")
    os.makedirs(os.path.join(path, "sub"))
    for rel, text in (("payload.bin", "x" * 300), ("sub/meta.json", '{"a": 1}')):
        with open(os.path.join(path, rel), "w") as f:
            f.write(text)
    pkg.write_tree_sidecar(path, pkg.CHECKPOINT_KIND, extra={"step": 3})
    return path


@pytest.mark.parametrize("tree", [False, True], ids=["file", "tree"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sidecars_verify_across_packages(tmp_path, writer, tree):
    """One package writes, both verify; the manifests agree field for
    field; a bit flip and a truncation are caught by both."""
    path = _write(PACKAGES[writer], tmp_path, tree)
    os.makedirs(tmp_path / "twin")
    twin = _write(PACKAGES["jax" if writer == "port" else "port"], tmp_path / "twin", tree)
    manifests = []
    for pkg in PACKAGES.values():
        if tree:
            manifests.append(pkg.verify_tree(path, kind=pkg.CHECKPOINT_KIND))
        else:
            manifests.append(pkg.verify_file(path, kind="demo",
                                             expect={"weights_signature": "s"}))
            assert pkg.verify_json(path, kind="demo") == {"k": list(range(50))}
    other = jax_artifacts.read_sidecar(twin)
    for m in (*manifests, other):
        m.pop("written_at")
    assert manifests[0] == manifests[1] == other
    victim = os.path.join(path, "payload.bin") if tree else path
    for corrupt, reason in ((_flip, "sha256"), (_truncate, "truncated")):
        original = open(victim, "rb").read()
        corrupt(victim)
        for pkg in PACKAGES.values():
            with pytest.raises(pkg.CorruptArtifact, match=reason):
                if tree:
                    pkg.verify_tree(path, kind=pkg.CHECKPOINT_KIND)
                else:
                    pkg.verify_file(path, kind="demo")
        with open(victim, "wb") as f:
            f.write(original)


def test_constants_match_jax():
    for name in ("SCHEMA", "SIDECAR_SUFFIX", "TMP_SUFFIX", "CHECKPOINT_KIND"):
        assert getattr(artifacts, name) == getattr(jax_artifacts, name)
    assert checkpoint.CHECKPOINT_KIND == jax_checkpoint.CHECKPOINT_KIND
    assert checkpoint.MIDEPOCH_STRIDE == jax_checkpoint.MIDEPOCH_STRIDE


def test_bitflip_and_truncation_fuzz_every_position_class(tmp_path):
    """Port of the JAX fuzz: every flip and truncation is a CorruptArtifact
    before anything deserializes, and the intact bytes verify again."""
    payload = json.dumps({"entries": {f"k{i}": i for i in range(40)}})
    p = str(tmp_path / "a.json")
    artifacts.atomic_write_artifact(p, payload, "fuzz")
    data = bytearray(payload.encode())
    for pos in range(0, len(data), max(1, len(data) // 9)):
        flipped = bytearray(data)
        flipped[pos] ^= 0x10
        with open(p, "wb") as f:
            f.write(bytes(flipped))
        with pytest.raises(artifacts.CorruptArtifact, match="sha256"):
            artifacts.verify_read(p, kind="fuzz")
    for cut in (0, 1, len(data) // 2, len(data) - 1):
        with open(p, "wb") as f:
            f.write(bytes(data[:cut]))
        with pytest.raises(artifacts.CorruptArtifact, match="truncated"):
            artifacts.verify_read(p, kind="fuzz")
    with open(p, "wb") as f:
        f.write(bytes(data))
    assert artifacts.verify_read(p, kind="fuzz") == bytes(data)


def test_truncated_or_garbage_sidecar_is_corrupt_and_kind_is_stale(tmp_path):
    p = str(tmp_path / "a.json")
    artifacts.atomic_write_artifact(p, '{"v": 1}', "k")
    with pytest.raises(artifacts.StaleArtifact, match="kind"):
        artifacts.verify_file(p, kind="other")
    sc = artifacts.sidecar_path(p)
    full = open(sc, "rb").read()
    for cut in (1, len(full) // 2, len(full) - 2):
        with open(sc, "wb") as f:
            f.write(full[:cut])
        with pytest.raises(artifacts.CorruptArtifact):
            artifacts.verify_file(p, kind="k")
    with open(sc, "w") as f:
        f.write('{"schema": "something-else/v9"}')
    with pytest.raises(artifacts.CorruptArtifact, match="schema"):
        artifacts.verify_file(p, kind="k")


@pytest.mark.parametrize("site", ["storage.write", "storage.fsync", "storage.replace"])
def test_storage_write_faults_leave_the_old_destination(tmp_path, site):
    p = str(tmp_path / "x.json")
    artifacts.atomic_write_artifact(p, "old", "k")
    faults.configure({site: 1})
    with pytest.raises(OSError, match=site):
        artifacts.atomic_write_artifact(p, "new", "k")
    faults.reset()
    assert artifacts.verify_read(p, kind="k") == b"old"
    orphans = artifacts.sweep_tmp(str(tmp_path))
    assert len(orphans) == (0 if site == "storage.write" else 1)


def test_storage_read_fault_and_quarantine(tmp_path):
    p = str(tmp_path / "x.json")
    artifacts.atomic_write_artifact(p, "data", "k")
    faults.configure({"storage.read": 1})
    with pytest.raises(artifacts.CorruptArtifact, match="injected"):
        artifacts.verify_read(p, kind="k")
    assert artifacts.verify_read(p, kind="k") == b"data"
    dest = artifacts.quarantine(p, "k", "unit test")
    assert os.path.exists(dest) and os.path.exists(artifacts.sidecar_path(dest))
    assert not os.path.exists(p)
    artifacts.atomic_write_artifact(p, "data", "k")
    assert artifacts.quarantine(p, "k", "again") not in (None, dest)


def _pair(tmp_path, metric, top_k):
    jax_ck = jax_checkpoint.Checkpointer(jax_checkpoint.CheckpointConfig(
        directory=str(tmp_path / "jax"), metric_to_track=metric, save_top_k=top_k))
    port_ck = Checkpointer(CheckpointConfig(directory=str(tmp_path / "port"),
                                            metric_to_track=metric, save_top_k=top_k))
    return jax_ck, port_ck


def _jax_steps(ck, name):
    return sorted(int(s) for s in getattr(ck, name).all_steps())


NAN, INF = float("nan"), float("inf")
SEQUENCES = {
    "val_ce": [0.5, NAN, -INF, 0.4, 0.6, 0.4, INF, 0.3, 0.35],
    "val_auroc": [0.7, INF, NAN, 0.7, 0.2, -INF, 0.9, 0.1],
}


@pytest.mark.parametrize("top_k", [1, 2, 3])
@pytest.mark.parametrize("metric", list(SEQUENCES))
def test_checkpointer_keeps_and_ranks_like_jax(tmp_path, metric, top_k):
    """Saves with NaN and +-inf metrics, a repeated step (skipped by both)
    and mid-epoch saves: the same best_step, latest_step, retained steps of
    every root and mid/ walk order, after every save and after a reopen."""
    jax_ck, port_ck = _pair(tmp_path, metric, top_k)
    tree = {"w": np.arange(3, dtype=np.float32)}
    calls = [(i + 1, v) for i, v in enumerate(SEQUENCES[metric])]
    calls.insert(4, (2, 0.0))  # an old step again: orbax skips it
    for step, value in calls:
        jax_ck.save(step, tree, {metric: value, "epoch": step})
        port_ck.save(step, {"w": torch.arange(3.0)}, {metric: value, "epoch": step})
        if step % 3 == 0:
            jax_ck.save_midepoch(step, 2, tree)
            port_ck.save_midepoch(step, 2, {"w": torch.arange(3.0)})
        jax_ck.wait()
        assert port_ck.best_step() == jax_ck.best_step(), (step, value)
        assert port_ck.latest_step() == jax_ck.latest_step()
        for name in ("best", "last", "mid"):
            assert port_ck.steps(name) == _jax_steps(jax_ck, name), name
    walk = [(name, s) for _, name, s in jax_ck._restore_candidates("mid")]
    assert port_ck._restore_candidates("mid") == walk
    jax_ck.close()
    reopened = Checkpointer(CheckpointConfig(directory=str(tmp_path / "port"),
                                             metric_to_track=metric, save_top_k=top_k))
    assert reopened.best_step() == jax_ck.best_step()
    assert reopened.has_restorable()


@pytest.mark.parametrize("which", ["last", "best", "mid"])
def test_corrupt_newest_step_walks_back_like_jax(tmp_path, which):
    """A bit flip in the newest candidate's payload: both quarantine it and
    restore the same (root, step); an explicit request for a corrupt step
    raises in both."""
    jax_ck, port_ck = _pair(tmp_path, "val_ce", 2)
    tree = {"w": np.zeros(3, np.float32)}
    for step, ce in ((1, 0.5), (2, 0.4), (3, 0.6)):
        jax_ck.save(step, tree, {"val_ce": ce})
        port_ck.save(step, {"w": torch.zeros(3)}, {"val_ce": ce})
    jax_ck.save_midepoch(3, 1, tree)
    port_ck.save_midepoch(3, 1, {"w": torch.zeros(3)})
    jax_ck.wait()
    (_, name, step), = jax_ck._restore_candidates(which)[:1]
    assert port_ck._restore_candidates(which)[0] == (name, step)
    for root in (str(tmp_path / "jax"), str(tmp_path / "port")):
        step_dir = os.path.join(root, name, str(step))
        files = [os.path.join(d, f) for d, _, fs in os.walk(step_dir) for f in fs
                 if f != "_CHECKPOINT_METADATA"]
        _flip(max(files, key=os.path.getsize), pos=-1)
    jax_ck.restore(tree, which=which)
    port_ck.restore(None, which=which)
    assert (port_ck.last_restored_which, port_ck.last_restored_step) == (
        jax_ck.last_restored_which, jax_ck.last_restored_step)
    assert (port_ck.last_restored_which, port_ck.last_restored_step) != (name, step)
    assert port_ck.steps(name) == _jax_steps(jax_ck, name)
    # An explicit corrupt step: no walk, a typed error, quarantined.
    explicit = jax_ck.best_step()
    for root in (str(tmp_path / "jax"), str(tmp_path / "port")):
        os.unlink(os.path.join(root, "best", str(explicit), "_CHECKPOINT_METADATA"))
    with pytest.raises(jax_artifacts.CorruptArtifact, match="requested step"):
        jax_ck.restore(tree, step=explicit, which="best")
    with pytest.raises(artifacts.CorruptArtifact, match="requested step"):
        port_ck.restore(None, step=explicit, which="best")
    jax_ck.close()
    assert port_ck.steps("best") == [s for s in _jax_steps(jax_ck, "best")]


def test_position_codec_and_metric_mode_match_jax():
    for epoch in (0, 1, 7, 123):
        for batch in (0, 1, 99, 10 ** 8 - 1):
            step = checkpoint.encode_midepoch_step(epoch, batch)
            assert step == jax_checkpoint.encode_midepoch_step(epoch, batch)
            for which in ("mid", "last", "best", None):
                assert checkpoint.decode_position(which, step) == \
                    jax_checkpoint.decode_position(which, step)
    for bad in (-1, 10 ** 8):
        with pytest.raises(ValueError):
            checkpoint.encode_midepoch_step(0, bad)
    for name in ("val_ce", "test_ce", "val_auroc", "med_val_top_10_prec", "val_acc"):
        assert checkpoint.metric_mode(name) == jax_checkpoint.metric_mode(name)


def test_train_state_round_trip_and_fine_tune_refusal(tmp_path):
    """A whole train state restores bitwise into a fresh one (optimizer
    moments, schedule, step); into a fine-tune state (decoder frozen, so
    another parameter list) only the model may be restored; a torn save
    (no commit marker) is quarantined on the walk."""
    cfg = port_cfg()
    model = DeepInteract(cfg)
    state = create_train_state(model, seed=3)
    with torch.no_grad():
        for p in model.parameters():
            p.grad = torch.ones_like(p)
    state.optimizer.update()
    state.step, state.bad_steps = 1, 2
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    ck.save(1, host_snapshot(state), {"val_ce": 0.5})
    fresh = create_train_state(DeepInteract(cfg), seed=0)
    ck.restore(fresh, which="last")
    assert (fresh.step, fresh.bad_steps, fresh.seed) == (1, 2, 3)
    for a, b in zip(model.state_dict().values(), fresh.model.state_dict().values()):
        assert torch.equal(a, b)
    mu_a = state.optimizer.adamw.state[state.optimizer.params[0]]["mu"]
    mu_b = fresh.optimizer.adamw.state[fresh.optimizer.params[0]]["mu"]
    assert all(torch.equal(a, b) for a, b in zip(mu_a, mu_b))
    assert fresh.optimizer.schedule.last_epoch == state.optimizer.schedule.last_epoch == 1
    tune = create_train_state(DeepInteract(cfg), seed=0, frozen_prefixes=("decoder",))
    with pytest.raises(ValueError, match="frozen prefixes"):
        ck.restore(tune, which="best")
    ck.restore(tune, which="best", partial=True)
    assert torch.equal(tune.model.decoder.phase2_conv.weight,
                       model.decoder.phase2_conv.weight)
    ck.save(2, host_snapshot(state), {"val_ce": 0.1})
    for which in ("best", "last"):
        os.unlink(os.path.join(ck.step_dir(which, 2), checkpoint.COMMIT_MARKER))
    ck.restore(None, which="last")
    assert (ck.last_restored_which, ck.last_restored_step) == ("best", 1)
    assert ck.steps("best") == [1] and ck.steps("last") == []
    for which in ("best", "last"):
        assert any(n.startswith("2.corrupt-") for n in os.listdir(tmp_path / which))
