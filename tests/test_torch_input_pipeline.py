"""The port's input path (data/loader.py, data/pipeline.py, the placement
stage of training/loop.py, cli.train --packed_cache_dir) on the CPU.

* F7: the loader's epoch plan equals the JAX loader's at ``dispatch_run``
  1, 4 and 8 (runs of same-bucket batches shuffled as a whole), and
  ``cli.train`` builds its train loader with ``max(1,
  --steps_per_dispatch)`` as the JAX CLI does.
* Mirrors of ``tests/test_input_pipeline.py``: prefetch on and off give
  bitwise equal training per-step and with runs, depth-bounded placement,
  a placement thread that stops when its consumer leaves, ``data.place``
  as a typed ``PlacementError`` inline and on the thread, the h2d
  counters; the wedged placement thread (``data.place_hang``) in process:
  the heartbeat keeps beating while its progress stamp stops.
* Packs: a JAX-built pack is read by the port's ``--packed_cache_dir``
  without a rebuild and a port-built one by the JAX package, and training
  from packs equals training from the npz tree bitwise.
"""

import dataclasses
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from deepinteract_tpu.data import datasets as jax_datasets
from deepinteract_tpu.data.loader import BucketedLoader as JaxBucketedLoader
from deepinteract_tpu.data.loader import make_bucket_fn as jax_make_bucket_fn
from deepinteract_tpu.data.packed import PackedDataset as JaxPackedDataset
from deepinteract_tpu.data.packed import pack_dataset as jax_pack_dataset
from deepinteract_tpu_torch.cli import train as train_cli
from deepinteract_tpu_torch.data import datasets
from deepinteract_tpu_torch.data import pipeline as pipeline_mod
from deepinteract_tpu_torch.data.loader import BucketedLoader
from deepinteract_tpu_torch.data.packed import PackedDataset
from deepinteract_tpu_torch.data.pipeline import (BatchPlacement, PlacementError, is_placed,
                                                   placed_runs)
from deepinteract_tpu_torch.data.synthetic import write_tiny_npz_dataset
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.obs import heartbeat
from deepinteract_tpu_torch.robustness import faults
from deepinteract_tpu_torch.training.loop import LoopConfig, Trainer
from deepinteract_tpu_torch.training.optim import OptimConfig
from deepinteract_tpu_torch.weights import init_weights
from torch_port_helpers import port_cfg

# Two buckets: 64x64 (4 complexes) and 128x64 (3).
SIZES = [(26, 22)] * 4 + [(70, 22)] * 3
LIMIT = 128


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("DI_FAULTS", raising=False)
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipeline_tree"))
    write_tiny_npz_dataset(root, sizes=SIZES, seed=9)
    return root


def _loader(tree, **kw):
    kw.setdefault("shuffle", True)
    return BucketedLoader(datasets.DIPSDataset(tree, "train"), seed=3, **kw)


def _trainer(k=1, logs=None, **loop):
    cfg = port_cfg(limit=LIMIT)
    cfg = dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn, num_layers=1),
                              decoder=dataclasses.replace(cfg.decoder, num_chunks=1))
    model = DeepInteract(cfg)
    init_weights(model, 4)
    loop.setdefault("log_every", 0)
    return Trainer(model, LoopConfig(seed=5, steps_per_dispatch=k, **loop),
                   OptimConfig(lr=1e-2, steps_per_epoch=len(SIZES), num_epochs=2),
                   log_fn=(logs.append if logs is not None else lambda s: None))


# ---------------------------------------------------------------------------
# F7: the epoch plan at dispatch_run K


class _Lengths:
    """A dataset of lengths only: enough for both loaders' planning."""

    def __init__(self, lengths):
        self._lengths = lengths

    def lengths(self):
        return list(self._lengths)

    def target_of(self, idx):
        return f"c{idx}"


PLAN_LENGTHS = [(30, 40)] * 25 + [(100, 60)] * 20 + [(200, 180)] * 15  # 3 buckets, 60 items


@pytest.mark.parametrize("dispatch_run", [1, 4, 8])
@pytest.mark.parametrize("seed", [42, 7])
def test_epoch_plan_matches_jax_at_dispatch_run(dispatch_run, seed):
    """The port's plan equals ``deepinteract_tpu.data.loader.BucketedLoader
    ._epoch_plan`` over 3 buckets and 2 epochs, and with dispatch_run > 1
    the same-bucket runs stay whole (F7: the parent's loader shuffled
    batch by batch whatever the run length)."""
    kw = dict(batch_size=1, shuffle=True, drop_remainder=True, seed=seed,
              dispatch_run=dispatch_run)
    ours = BucketedLoader(_Lengths(PLAN_LENGTHS), **kw)
    ref = JaxBucketedLoader(_Lengths(PLAN_LENGTHS), prefetch=0, **kw)
    assert ours.num_batches() == ref.num_batches() == len(PLAN_LENGTHS)
    for epoch in (0, 1):
        plan = ours.epoch_plan(epoch)
        assert plan == ref._epoch_plan(epoch)
        if dispatch_run > 1:
            # Whole runs: the bucket changes at most between two cut runs.
            changes = sum(plan[i][0] != plan[i - 1][0] for i in range(1, len(plan)))
            assert changes < sum(-(-n // dispatch_run) for n in (25, 20, 15))


class _Stop(Exception):
    pass


@pytest.mark.parametrize("flags,dispatch_run", [((), 8), (("--steps_per_dispatch", "4"), 4),
                                                (("--steps_per_dispatch", "1"), 1),
                                                (("--steps_per_dispatch", "0"), 1)])
def test_train_cli_loader_takes_dispatch_run_from_steps_per_dispatch(tree, monkeypatch, flags,
                                                                     dispatch_run):
    seen = {}

    def loader(dataset, **kw):
        seen.update(kw)
        raise _Stop

    monkeypatch.setattr(train_cli, "BucketedLoader", loader)
    args = train_cli.parse_args(["--dips_root", tree, "--device", "cpu", *flags])
    with pytest.raises(_Stop):
        train_cli.run(args)
    assert seen["dispatch_run"] == dispatch_run and seen["shuffle"] and seen["drop_remainder"]


# ---------------------------------------------------------------------------
# the placement stage: inline and on the placement thread


def _params(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def _fit(tree, k, prefetch, epochs=2):
    logs = []
    trainer = _trainer(k, logs, num_epochs=epochs, device_prefetch=prefetch)
    state, history = trainer.fit(trainer.init_state(), _loader(tree, dispatch_run=k))
    return _params(state), history, logs


@pytest.mark.parametrize("k", [1, 3])
def test_prefetch_parity_matrix(tree, k):
    """--device_prefetch on and off: bitwise equal weights and statistics,
    equal epoch metrics (timings aside), and the adopted mode logged once
    at fit start."""
    p_off, h_off, logs_off = _fit(tree, k, False)
    p_on, h_on, logs_on = _fit(tree, k, True)
    assert p_off.keys() == p_on.keys()
    for name in p_off:
        assert torch.equal(p_off[name], p_on[name]), name
    for a, b in zip(h_off, h_on):
        keys = [key for key in a if not key.endswith("seconds") and not key.startswith("tele_")]
        assert [a[key] for key in keys] == [b[key] for key in keys]
    mode = "single/" + ("scanned" if k > 1 else "per-step")
    assert any(f"placement mode {mode}, double-buffered" in m for m in logs_on), logs_on
    assert any(f"placement mode {mode}, inline (device_prefetch off)" in m for m in logs_off)


def test_prefetch_honors_disabled_loader_readahead(tree):
    """A loader with prefetch=0 keeps placement inline (with a log line)."""
    logs = []
    trainer = _trainer(1, logs, num_epochs=1, device_prefetch=True)
    loader = _loader(tree, prefetch=0)
    _, history = trainer.fit(trainer.init_state(), loader)
    assert trainer._prefetch_depth == 0 and len(history) == 1
    assert any("placement stays inline" in m for m in logs), logs


def test_placement_stage_pins_at_most_depth_dispatches():
    class Spy:
        placed = 0

        def place_run(self, run):
            Spy.placed += 1
            return run

    spy, depth = Spy(), 2
    spy.device = torch.device("cpu")
    consumed = max_ahead = 0
    for _ in placed_runs(iter([[i] for i in range(10)]), spy, depth=depth):
        time.sleep(0.05)  # every chance to run ahead, if it could
        consumed += 1
        max_ahead = max(max_ahead, Spy.placed - consumed)
    assert consumed == 10
    assert max_ahead <= depth, f"placement ran {max_ahead} dispatches ahead (bound {depth})"


def _wait_gone(name, before):
    deadline = time.time() + 5.0
    while time.time() < deadline:
        if not [t for t in threading.enumerate()
                if t.name == name and t not in before and t.is_alive()]:
            return
        time.sleep(0.05)
    pytest.fail(f"a {name} thread outlived its abandoned consumer")


def test_placement_stage_stops_on_abandonment(tree):
    before = set(threading.enumerate())
    batch = next(iter(_loader(tree, prefetch=0)))
    gen = placed_runs(iter([[batch]] * 100), BatchPlacement("cpu", transfer=True), depth=1)
    next(gen)
    gen.close()
    _wait_gone("di-placement", before)


def test_loader_read_ahead_equals_inline_and_stops_on_abandonment(tree):
    """The loader's prefetch thread yields the inline batches in order, and
    ends when its consumer leaves after one batch (a viz pull)."""
    inline = list(_loader(tree, prefetch=0, dispatch_run=3).iter_epoch(1))
    ahead = list(_loader(tree, prefetch=2, dispatch_run=3).iter_epoch(1))
    assert len(inline) == len(ahead) == len(SIZES)
    for a, b in zip(inline, ahead):
        assert all(torch.equal(x, y) for x, y in zip(pipeline_mod.tensors(a),
                                                     pipeline_mod.tensors(b)))
    before = set(threading.enumerate())
    it = _loader(tree, prefetch=2)(0)
    next(it)
    it.close()
    _wait_gone("di-loader", before)


@pytest.mark.parametrize("prefetch", [False, True])
def test_data_place_fault_surfaces_typed_error(tree, prefetch):
    """A placement failure, inline or on the placement thread, reaches the
    trainer as a PlacementError at the next dispatch, never a hang."""
    faults.configure("data.place=1")
    trainer = _trainer(2, num_epochs=1, device_prefetch=prefetch)
    with pytest.raises(PlacementError, match="data.place"):
        trainer.fit(trainer.init_state(), _loader(tree, dispatch_run=2))


def test_data_place_fault_counts_injection(tree):
    faults.configure("data.place=1")
    batch = next(iter(_loader(tree, prefetch=0)))
    with pytest.raises(PlacementError):
        BatchPlacement("cpu", transfer=True).place_batch(batch)
    assert faults.call_count("data.place") == 1


def test_h2d_metrics_count_placements(tree):
    """Placements add to di_data_h2d_seconds/bytes_total and the per-mode
    dispatch counter; a placed batch is recognized (no second copy)."""
    batch = next(iter(_loader(tree, prefetch=0)))
    before_b = pipeline_mod._H2D_BYTES.value()
    before_s = pipeline_mod._H2D_SECONDS.value()
    before_d = pipeline_mod._PLACED_DISPATCHES.value(mode="single/per-step")
    placed = BatchPlacement("cpu", transfer=True).place_batch(batch)
    assert pipeline_mod._H2D_BYTES.value() == before_b + pipeline_mod.batch_nbytes(batch)
    assert pipeline_mod._H2D_SECONDS.value() >= before_s
    assert pipeline_mod._PLACED_DISPATCHES.value(mode="single/per-step") == before_d + 1
    assert is_placed(placed, "cpu") and not is_placed(placed, "meta")


def test_wedged_placement_thread_keeps_the_heartbeat_beating(tree, tmp_path, monkeypatch):
    """``data.place_hang`` freezes the placement thread: the heartbeat file
    stays fresh while its progress stamp stops, the signature on which the
    supervisor's watchdog kills a run. The frozen thread is released by
    the test through the module's clock, and the fit ends with its error."""
    release = threading.Event()

    def sleep(seconds):
        if release.is_set():
            raise RuntimeError("released by the test")
        time.sleep(min(seconds, 0.05))

    monkeypatch.setattr(pipeline_mod, "time", types.SimpleNamespace(
        perf_counter=time.perf_counter, sleep=sleep))
    faults.configure({"data.place_hang": [3]})
    trainer = _trainer(1, num_epochs=1, device_prefetch=True, ckpt_dir=str(tmp_path),
                       heartbeat_seconds=0.05)
    errors = []
    fit = threading.Thread(target=lambda: errors.append(pytest.raises(
        RuntimeError, trainer.fit, trainer.init_state(), _loader(tree))), daemon=True)
    fit.start()
    path = str(tmp_path / "obs" / "heartbeat_p0.json")
    deadline = time.time() + 60
    while time.time() < deadline:  # the two placed batches are stepped, then it waits
        if os.path.exists(path) and heartbeat.read(path).get("step") == 2:
            break
        time.sleep(0.05)
    first = heartbeat.read(path)
    time.sleep(0.5)
    later = heartbeat.read(path)
    release.set()
    fit.join(timeout=30)
    assert (first["step"], later["step"]) == (2, 2)
    assert later["last_progress_ts"] == first["last_progress_ts"]  # progress stopped
    assert later["written_ts"] > first["written_ts"]  # the process still breathes
    assert not fit.is_alive() and errors and "released" in str(errors[0].value)


# ---------------------------------------------------------------------------
# --packed_cache_dir


def _index_stamp(pack_dir):
    st = os.stat(os.path.join(pack_dir, "pack_index.json"))
    return st.st_ino, st.st_mtime_ns


def _split_args(tree, cache):
    return train_cli.parse_args(["--dips_root", tree, "--packed_cache_dir", cache,
                                 "--device", "cpu"])


def test_packs_are_shared_with_the_jax_package(tree, tmp_path):
    """Packs written by the JAX CLI's signatures are reused by the port's
    --packed_cache_dir (no rewrite) and give the port's direct batches; a
    port-written pack is reused by the JAX package's pack_dataset and
    reads back as its own batches."""
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    args = _split_args(tree, jax_dir)
    sigs = {"train": "pad_max=False,diag=False,indep=False", "val": "eval,indep=False",
            "test": "eval,indep=False"}
    for split, sig in sigs.items():
        jax_pack_dataset(jax_datasets.DIPSDataset(tree, split), os.path.join(jax_dir, split),
                         jax_make_bucket_fn(False, False), signature=sig)
    stamps = {s: _index_stamp(os.path.join(jax_dir, s)) for s in sigs}
    dm = [datasets.DIPSDataset(tree, s) for s in sigs]
    packs = train_cli.packed_splits(args, *dm)
    assert {s: _index_stamp(os.path.join(jax_dir, s)) for s in sigs} == stamps
    direct = list(BucketedLoader(dm[0], prefetch=0))
    for a, b in zip(BucketedLoader(packs[0], prefetch=0), direct):
        assert all(torch.equal(x, y) for x, y in zip(pipeline_mod.tensors(a),
                                                     pipeline_mod.tensors(b)))

    train_cli.packed_splits(_split_args(tree, port_dir), *dm)
    stamp = _index_stamp(os.path.join(port_dir, "train"))
    jax_pack_dataset(jax_datasets.DIPSDataset(tree, "train"), os.path.join(port_dir, "train"),
                     jax_make_bucket_fn(False, False), signature=sigs["train"])
    assert _index_stamp(os.path.join(port_dir, "train")) == stamp
    jax_pack = JaxPackedDataset(os.path.join(port_dir, "train"))
    ref = JaxBucketedLoader(jax_datasets.DIPSDataset(tree, "train"), prefetch=0)
    for (bucket, chunk), jb in zip(ref._epoch_plan(0), ref):
        got = jax_pack.padded_batch(chunk, bucket)
        for x, y in zip(_jax_leaves(got), _jax_leaves(jb)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _jax_leaves(tree):
    import jax

    return jax.tree_util.tree_leaves(tree)


def test_packed_training_equals_direct_training(tree, tmp_path):
    """Runs of 3 read from packs train bitwise as runs read from the npz
    tree (the port's counterpart of the JAX packed-dispatch check)."""
    packs = train_cli.packed_splits(_split_args(tree, str(tmp_path / "packs")),
                                    *[datasets.DIPSDataset(tree, s)
                                      for s in ("train", "val", "test")])
    results = []
    for dataset in (datasets.DIPSDataset(tree, "train"), packs[0]):
        trainer = _trainer(3, num_epochs=1)
        loader = BucketedLoader(dataset, shuffle=True, seed=3, dispatch_run=3)
        state, history = trainer.fit(trainer.init_state(), loader)
        results.append((_params(state), history[0]["train_loss"]))
    assert results[0][1] == results[1][1]
    for name, value in results[0][0].items():
        assert torch.equal(value, results[1][0][name]), name
    assert isinstance(packs[0], PackedDataset)
