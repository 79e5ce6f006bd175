"""Resume exactness of the port's trainer (training/loop.py) on the CPU: a
run preempted through the ``train.sigterm`` fault site and resumed equals
the uninterrupted run bitwise (parameters, batch statistics, AdamW
moments, schedule step, accumulator, history, best and latest steps) at an
epoch boundary, in mid-epoch (with and without the cursor sidecar) and
between two accumulation micro-steps; and the loader's resume cursor and
skip ledger against the JAX loader's."""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from deepinteract_tpu.data import datasets as jax_datasets
from deepinteract_tpu.data.loader import BucketedLoader as JaxBucketedLoader
from deepinteract_tpu_torch.data import datasets
from deepinteract_tpu_torch.data.graph import stack_complexes
from deepinteract_tpu_torch.data.loader import BucketedLoader
from deepinteract_tpu_torch.data.synthetic import random_complex, write_tiny_npz_dataset
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.robustness import faults
from deepinteract_tpu_torch.robustness.preemption import TrainingPreempted
from deepinteract_tpu_torch.training.checkpoint import CheckpointConfig, Checkpointer
from deepinteract_tpu_torch.training.loop import LoopConfig, Trainer, read_sidecar
from deepinteract_tpu_torch.training.optim import OptimConfig
from deepinteract_tpu_torch.weights import init_weights
from torch_port_helpers import KNN, N1, N2, PAD, port_cfg

BATCHES = 3  # train batches per epoch


@pytest.fixture(autouse=True)
def _clean_fault_state(monkeypatch):
    monkeypatch.delenv("DI_FAULTS", raising=False)
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    batches = [stack_complexes([random_complex(N1, N2, rng, n_pad1=PAD, n_pad2=PAD, knn=KNN)])
               for _ in range(BATCHES)]
    return batches, batches[:1]


def _trainer(ckpt_dir, epochs=3, accumulate=1, **loop):
    cfg = port_cfg()
    cfg = dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn, num_layers=1),
                              decoder=dataclasses.replace(cfg.decoder, num_chunks=1))
    model = DeepInteract(cfg)
    init_weights(model, 4)
    loop.setdefault("log_every", 0)
    loop.setdefault("patience", 50)
    return Trainer(model, LoopConfig(num_epochs=epochs, ckpt_dir=str(ckpt_dir), seed=9, **loop),
                   OptimConfig(lr=1e-2, steps_per_epoch=BATCHES, num_epochs=epochs, t0_epochs=2,
                               accumulate_steps=accumulate),
                   log_fn=lambda s: None)


def _fit(ckpt_dir, train, val, resume=False, **kw):
    trainer = _trainer(ckpt_dir, **kw)
    state, history = trainer.fit(trainer.init_state(), train, val_data=val, resume=resume)
    return trainer, state, history


def _preempted(ckpt_dir, train, val, at, **kw):
    faults.configure({"train.sigterm": [at]})
    with pytest.raises(TrainingPreempted):
        _fit(ckpt_dir, train, val, **kw)
    faults.reset()


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def _same_state(a, b):
    """The whole train state bitwise: parameters, batch statistics, AdamW
    (moments, count, rate), the schedule, the accumulator, step counters."""
    sa, sb = a.state_dict(), b.state_dict()
    assert _equal(sa["model"], sb["model"])
    assert _equal(sa["optimizer"], sb["optimizer"])
    assert (sa["step"], sa["bad_steps"], sa["seed"]) == (sb["step"], sb["bad_steps"], sb["seed"])


def _same_history(got, ref):
    """Equal epoch metrics, wall-clock timings (``*seconds``, the
    ``tele_*`` decomposition) aside."""
    keys = [k for k in ref[0] if not k.endswith("seconds") and not k.startswith("tele_")]
    for g, r in zip(got, ref):
        for k in keys:
            assert g[k] == r[k] or (math.isnan(g[k]) and math.isnan(r[k])), k


def _same_bookkeeping(dir_a, dir_b):
    ck_a, ck_b = (Checkpointer(CheckpointConfig(directory=str(d))) for d in (dir_a, dir_b))
    assert ck_a.best_step() == ck_b.best_step()
    assert ck_a.latest_step() == ck_b.latest_step()
    assert ck_a.steps("best") == ck_b.steps("best")
    side_a, side_b = read_sidecar(str(dir_a)), read_sidecar(str(dir_b))
    assert {k: side_a[k] for k in ("epoch", "stopper_best", "stopper_stale")} == \
        {k: side_b[k] for k in ("epoch", "stopper_best", "stopper_stale")}


@pytest.fixture(scope="module")
def reference(data, tmp_path_factory):
    """The uninterrupted 3-epoch run, with a mid-epoch save after every
    step (saves do not change training)."""
    ckpt_dir = tmp_path_factory.mktemp("reference")
    _, state, history = _fit(ckpt_dir, *data, save_every_steps=1)
    assert [h["epoch"] for h in history] == [0, 1, 2]
    return ckpt_dir, state, history


def test_preempted_at_an_epoch_start_resumes_bitwise(data, reference, tmp_path):
    """SIGTERM at the first batch of epoch 2: epochs 0 and 1 are
    checkpointed; the resumed run runs epoch 2 only and ends equal to the
    uninterrupted one."""
    ref_dir, ref_state, ref_history = reference
    _preempted(tmp_path, *data, at=2 * BATCHES + 1)
    assert Checkpointer(CheckpointConfig(directory=str(tmp_path))).latest_step() == 2
    trainer, state, history = _fit(tmp_path, *data, resume=True)
    assert [h["epoch"] for h in history] == [2]
    assert trainer.steps_run == BATCHES
    _same_state(state, ref_state)
    assert state.step == 3 * BATCHES
    assert state.optimizer.schedule.last_epoch == 3 * BATCHES
    _same_history(history, ref_history[2:])
    _same_bookkeeping(ref_dir, tmp_path)


@pytest.mark.parametrize("cursor", [True, False], ids=["cursor", "no_cursor_sidecar"])
def test_preempted_in_mid_epoch_resumes_on_the_next_batch(data, reference, tmp_path, cursor):
    """SIGTERM before epoch 1's second batch with a save after every step:
    the resume lands on that batch, runs only what is left, and equals the
    uninterrupted run. Without the sidecar (killed between the save and
    its write) the position still comes from the step number: the weights
    stay exact, and only the interrupted epoch's train_loss covers fewer
    batches."""
    ref_dir, ref_state, ref_history = reference
    _preempted(tmp_path, *data, at=BATCHES + 2, save_every_steps=1)
    cur = read_sidecar(str(tmp_path))["cursor"]
    assert (cur["epoch"], cur["batch_index"], cur["opt_step"]) == (1, 1, BATCHES + 1)
    assert len(cur["loss_ledger"]) == 1
    if not cursor:
        os.unlink(tmp_path / "trainer_state.json")
    trainer, state, history = _fit(tmp_path, *data, resume=True, save_every_steps=1)
    assert [h["epoch"] for h in history] == [1, 2]
    assert trainer.steps_run == 2 * BATCHES - 1
    _same_state(state, ref_state)
    if cursor:
        _same_history(history, ref_history[1:])
        _same_bookkeeping(ref_dir, tmp_path)
    else:
        assert history[0]["train_steps"] == BATCHES - 1
        _same_history(history[1:], ref_history[2:])


def test_preempted_between_accumulation_micro_steps_resumes_bitwise(data, tmp_path):
    """accumulate_steps=2 over 3 batches an epoch: the save after batch 2
    of epoch 1 (micro-step 5) holds one micro-step in the accumulator (its
    mean and count), and the resumed run ends equal to the uninterrupted
    one."""
    _, ref_state, ref_history = _fit(tmp_path / "a", *data, epochs=2, accumulate=2)
    _preempted(tmp_path / "b", *data, at=BATCHES + 3, epochs=2, accumulate=2,
               save_every_steps=1)
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path / "b")))
    saved = ck.restore(None, which="mid")
    assert (ck.last_restored_which, ck.last_restored_step) == ("mid", 10 ** 8 + 2)
    assert saved["optimizer"]["micro"] == 1 and saved["optimizer"]["acc"] is not None
    assert saved["optimizer"]["schedule"]["last_epoch"] == 2
    _, state, history = _fit(tmp_path / "b", *data, resume=True, epochs=2, accumulate=2,
                             save_every_steps=1)
    _same_state(state, ref_state)
    assert state.optimizer._micro == ref_state.optimizer._micro == 0
    assert state.optimizer.schedule.last_epoch == BATCHES  # 6 micro-steps, 3 updates
    _same_history(history, ref_history[1:])


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tiny"))
    write_tiny_npz_dataset(root, n_complexes=6, n1=10, n2=8, knn=4)
    return root


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        for name in ("graph1", "graph2"):
            for field in dataclasses.fields(getattr(a, name)):
                np.testing.assert_array_equal(getattr(getattr(a, name), field.name).numpy(),
                                              np.asarray(getattr(getattr(b, name), field.name)))
        for field in ("examples", "example_mask", "contact_map"):
            np.testing.assert_array_equal(getattr(a, field).numpy(),
                                          np.asarray(getattr(b, field)))


def test_loader_cursor_restarts_on_the_exact_next_batch(tiny_tree):
    """iter_epoch(start_batch=k) yields the uninterrupted epoch's batches
    k.. without loading the first k, and the JAX loader's from the same
    cursor."""
    kw = dict(batch_size=1, shuffle=True, seed=3)
    loader = BucketedLoader(datasets.DIPSDataset(tiny_tree, "train"), **kw)
    full = list(loader.iter_epoch(1))
    faults.configure({"loader.batch": []})  # count the loads
    part = list(loader.iter_epoch(1, start_batch=2))
    assert faults.call_count("loader.batch") == len(full) - 2
    _assert_batches_equal(part, full[2:])
    jax_loader = JaxBucketedLoader(jax_datasets.DIPSDataset(tiny_tree, "train"), prefetch=0,
                                   **kw)
    _assert_batches_equal(part, list(jax_loader.iter_epoch(1, start_batch=2)))


def test_loader_skip_ledger_and_resume_after_skip(tiny_tree):
    """A corrupt batch within the budget is dropped and logged in the
    ledger; a resume that carries skips_used lands on the same batches and
    has that much less budget."""
    loader = BucketedLoader(datasets.DIPSDataset(tiny_tree, "train"), batch_size=1,
                            skip_budget=2)
    faults.configure({"loader.batch": [2]})
    got = list(loader.iter_epoch(0))
    assert len(got) == 5
    assert loader.skips_before(1) == 0 and loader.skips_before(3) == 1
    faults.reset()
    resumed = list(loader.iter_epoch(0, start_batch=1, skips_used=1))
    _assert_batches_equal(resumed, got[1:])
    faults.configure({"loader.batch": [1, 2]})
    with pytest.raises(ValueError, match="injected corrupt complex"):
        list(loader.iter_epoch(0, start_batch=0, skips_used=1))
    faults.configure({"loader.batch": [1]})
    with pytest.raises(ValueError, match="injected corrupt complex"):
        list(BucketedLoader(datasets.DIPSDataset(tiny_tree, "train")).iter_epoch(0))


def test_nan_batch_fault_is_skipped_by_the_guard(data, tmp_path):
    """The ``train.nan_batch`` site poisons the second batch's float
    tensors: the guard skips that update, training goes on, and the epoch
    mean leaves the NaN loss out."""
    faults.configure({"train.nan_batch": [2]})
    _, state, history = _fit(tmp_path, *data, epochs=1)
    assert (state.step, state.bad_steps) == (BATCHES - 1, 0)
    assert history[0]["train_skipped_steps"] == 1.0
    assert math.isfinite(history[0]["train_loss"])
