"""The port's training dispatch loop (training/loop.py) against the JAX
package's: one epoch of the JAX ``Trainer`` and of the port's from one
random variables tree, with 4 train steps and 4 eval batches per
dispatch, over an on-disk tree of two buckets with remainders read by
each package's loader (runs of 4 shuffled as a whole, F7). Per-step
losses within 1e-5, val metrics within 1e-4, the same mid-epoch save
positions under ``save_every_steps=3``, and parameters within 1e-4 plus
four times their float32 rounding spread (ROADMAP queue 3: AdamW's
normalized update turns rounding-level gradient differences of
near-zero-gradient parameters into moves of up to the learning rate).
The JAX run's checkpoint storage is stubbed: only its save positions are
compared, and its orbax saves would triple the JAX side's time."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinteract_tpu.data import datasets as jax_datasets
from deepinteract_tpu.data.loader import BucketedLoader as JaxBucketedLoader
from deepinteract_tpu.models.model import DeepInteract as JaxDeepInteract
from deepinteract_tpu.training.loop import LoopConfig as JaxLoopConfig
from deepinteract_tpu.training.loop import Trainer as JaxTrainer
from deepinteract_tpu.training.optim import OptimConfig as JaxOptimConfig
from deepinteract_tpu.training.optim import make_optimizer
from deepinteract_tpu.training.steps import TrainState as JaxTrainState
from deepinteract_tpu_torch.data import datasets
from deepinteract_tpu_torch.data.graph import stack_complexes
from deepinteract_tpu_torch.data.loader import BucketedLoader
from deepinteract_tpu_torch.data.synthetic import random_complex, write_tiny_npz_dataset
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.training.loop import LoopConfig, Trainer
from deepinteract_tpu_torch.training.optim import OptimConfig
from deepinteract_tpu_torch.weights import init_weights, load_jax_variables
from torch_port_helpers import KNN, complexes, jax_cfg, port_cfg, random_variables

# Two buckets: 64x64 (6 complexes: a run of 4 and a remainder of 2) and
# 128x64 (5: a run of 4 and a remainder of 1).
TRAIN = [(26, 22)] * 6 + [(70, 22)] * 5
VAL = 4  # the first four (64x64): one eval run of 4
K = 4
LIMIT = 128  # the node-position rows of the 128-bucket chains
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def _shallow(cfg):
    return dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn, num_layers=1),
                               decoder=dataclasses.replace(cfg.decoder, num_chunks=1))


def _record(monkeypatch, cls, epoch_fn, losses_pos, saves):
    """Wrap ``cls``'s train-epoch method to keep each epoch's loss ledger
    and its midsave factory to record every save position."""
    ledgers = []
    real_epoch, real_midsave = getattr(cls, epoch_fn), cls._make_midsave

    def epoch(self, *args, **kw):
        ledgers.append(args[losses_pos])
        return real_epoch(self, *args, **kw)

    def make_midsave(self, *args, **kw):
        save = real_midsave(self, *args, **kw)

        def recorded(state, batches_done):
            saves.append(int(batches_done))
            return save(state, batches_done)
        return recorded

    monkeypatch.setattr(cls, epoch_fn, epoch)
    monkeypatch.setattr(cls, "_make_midsave", make_midsave)
    return ledgers


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dispatch_tree"))
    write_tiny_npz_dataset(root, sizes=TRAIN, seed=5)
    names = [f"c{i}.npz" for i in range(len(TRAIN))]
    with open(os.path.join(root, "pairs-postprocessed-val.txt"), "w") as f:
        f.write("\n".join(names[:VAL]) + "\n")
    return root


class _PositionsOnly:
    """The JAX loop's Checkpointer, keeping nothing: the loop decides when
    and at which position it saves; these tests read only that."""

    def __init__(self, cfg):
        pass

    def has_restorable(self):
        return False

    def save(self, *args, **kw):
        pass

    save_midepoch = save

    def wait(self):
        pass

    close = wait


def _perturbed(variables, seed):
    """The variables with every parameter scaled by (1 + 1e-7 * noise)."""
    rng = np.random.default_rng(seed)
    return {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1 + 1e-7 * rng.standard_normal(a.shape)).astype(np.float32),
        variables["params"])}


def test_dispatch_loop_matches_the_jax_trainer(tree, tmp_path, monkeypatch):
    jcfg = _shallow(jax_cfg(norm_type="layer", limit=LIMIT))
    variables = random_variables(jcfg, complexes(seed=41)[0], seed=41)
    optim = dict(lr=1e-3, steps_per_epoch=len(TRAIN), num_epochs=1)
    # No guard: a finite step's math is the same, and the JAX step compiles
    # without its second optimizer branch.
    loop = dict(num_epochs=1, log_every=0, steps_per_dispatch=K,
                eval_batches_per_dispatch=K, save_every_steps=3, nonfinite_guard=False)
    loader = dict(batch_size=1, shuffle=True, drop_remainder=True, seed=7, dispatch_run=K)

    jax_saves, saves = [], []
    jax_ledgers = _record(monkeypatch, JaxTrainer, "_run_train_epoch", 3, jax_saves)
    from deepinteract_tpu.training import loop as jax_loop
    monkeypatch.setattr(jax_loop, "Checkpointer", _PositionsOnly)
    monkeypatch.setattr(jax_loop, "state_to_tree", lambda state: None)
    jax_model = JaxDeepInteract(jcfg)
    jax_trainer = JaxTrainer(jax_model, JaxLoopConfig(ckpt_dir=str(tmp_path / "jax"),
                                                      span_log=False, async_checkpoint=False,
                                                      **loop),
                             JaxOptimConfig(**optim), log_fn=lambda s: None)

    tx = make_optimizer(JaxOptimConfig(**optim))  # one object: the steps compile once

    def jax_fit(weights):
        state = JaxTrainState.create(apply_fn=jax_model.apply, params=weights["params"],
                                     tx=tx, batch_stats={}, dropout_rng=jax.random.PRNGKey(0),
                                     bad_steps=jnp.zeros((), jnp.int32))
        state, history = jax_trainer.fit(
            state, JaxBucketedLoader(jax_datasets.DIPSDataset(tree, "train"), prefetch=0,
                                     **loader),
            val_data=JaxBucketedLoader(jax_datasets.DIPSDataset(tree, "val"), prefetch=0))
        params = jax.tree_util.tree_map(np.asarray, state.params)
        ref = DeepInteract(cfg)
        load_jax_variables(ref, {"params": params})
        return state, history, dict(ref.named_parameters())

    cfg = _shallow(port_cfg(norm_type="layer", limit=LIMIT))
    cfg = dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn, dropout_rate=0.0))
    jstate, jax_history, ref_params = jax_fit(variables)

    ledgers = _record(monkeypatch, Trainer, "_train_epoch", 3, saves)
    model = DeepInteract(cfg)
    load_jax_variables(model, variables)
    trainer = Trainer(model, LoopConfig(ckpt_dir=str(tmp_path / "port"), **loop),
                      OptimConfig(**optim), log_fn=lambda s: None)
    state, history = trainer.fit(
        trainer.init_state(), BucketedLoader(datasets.DIPSDataset(tree, "train"), **loader),
        val_data=BucketedLoader(datasets.DIPSDataset(tree, "val")))
    assert len(ledgers[0]) == len(jax_ledgers[0]) == len(TRAIN)
    np.testing.assert_allclose(ledgers[0], jax_ledgers[0], **LOSS_TOL)
    assert saves == jax_saves and len(saves) >= 2  # dispatch boundaries, 3+ steps apart
    assert state.step == int(jstate.step) == len(TRAIN)
    for key in ("train_loss", "val_ce", "med_val_auroc"):
        np.testing.assert_allclose(history[0][key], jax_history[0][key], err_msg=key, **TOL)

    # The reference's own spread: its compiled steps rerun from weights
    # moved by 1e-7 relative.
    spread = dict.fromkeys(ref_params, 0.0)
    for seed in (1, 2):
        moved = jax_fit(_perturbed(variables, seed))[2]
        for name in spread:
            spread[name] = max(spread[name], (moved[name] - ref_params[name]).abs().max().item())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref_params[name].detach().numpy(),
                                   err_msg=name, rtol=TOL["rtol"],
                                   atol=TOL["atol"] + 4 * spread[name])


# ---------------------------------------------------------------------------
# Mirrors of the JAX loop's dispatch, eval, viz, fault and telemetry tests
# (tests/test_training_loop.py, test_fault_tolerance.py, test_obs.py) on
# the port alone, on same-shape batches.


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(13)
    return [stack_complexes([random_complex(20, 16, rng, n_pad1=32, n_pad2=32, knn=KNN)])
            for _ in range(4)]


def _toy_trainer(epochs=1, logs=None, writer=None, **loop):
    cfg = _shallow(port_cfg())
    model = DeepInteract(cfg)
    init_weights(model, 6)
    loop.setdefault("log_every", 0)
    loop.setdefault("patience", 50)
    return Trainer(model, LoopConfig(num_epochs=epochs, seed=3, **loop),
                   OptimConfig(lr=1e-2, steps_per_epoch=4, num_epochs=max(epochs, 2)),
                   log_fn=(logs.append if logs is not None else lambda s: None),
                   metric_writer=writer)


def test_grouped_eval_equals_per_batch_eval(batches):
    """Five same-shape batches at 3 per dispatch (a run of 3, then two
    batch by batch) give exactly the per-batch metrics."""
    val = batches + batches[:1]
    grouped = _toy_trainer(eval_batches_per_dispatch=3)
    single = _toy_trainer(eval_batches_per_dispatch=1)
    state = grouped.init_state()
    m_grouped = grouped.evaluate(state, val[:5], stage="val")
    m_single = single.evaluate(state, val[:5], stage="val")
    assert m_grouped.keys() == m_single.keys() and "val_ce" in m_single
    for key, value in m_single.items():
        assert m_grouped[key] == value or (np.isnan(value) and np.isnan(m_grouped[key])), key


def test_steps_per_dispatch_equals_per_step_training(batches):
    """Runs of 2 (two dispatches) train bitwise as four per-step dispatches."""
    results = []
    for k in (1, 2):
        trainer = _toy_trainer(steps_per_dispatch=k)
        state, history = trainer.fit(trainer.init_state(), batches)
        results.append((state, history[0]["train_loss"], trainer._dispatch_count))
    assert results[0][0].step == results[1][0].step == len(batches)
    assert results[0][1] == results[1][1]
    assert (results[0][2], results[1][2]) == (4, 2)
    for (name, a), b in zip(results[0][0].model.state_dict().items(),
                            results[1][0].model.state_dict().values()):
        assert torch.equal(a, b), name


class _FakeWriter:
    def __init__(self):
        self.scalars, self.images = [], []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def add_image(self, tag, img, step, dataformats="HWC"):
        self.images.append((tag, img.shape, step, dataformats, img.dtype))


def test_viz_images_and_epoch_scalars_are_written(batches):
    writer = _FakeWriter()
    trainer = _toy_trainer(writer=writer, viz_every_n_epochs=1)
    _, history = trainer.fit(trainer.init_state(), batches, val_data=batches[:1])
    tags = [t for t, *_ in writer.images]
    assert tags == ["val_predicted_contact_probs", "val_true_contacts"]
    assert all(shape == (20, 16, 1) and fmt == "HWC" and dtype == np.uint8
               for _, shape, _, fmt, dtype in writer.images)  # unpadded [n1, n2, 1]
    scalars = {tag: value for tag, value, step in writer.scalars if step == 0}
    assert scalars["train_loss"] == history[0]["train_loss"]
    assert scalars["val_ce"] == history[0]["val_ce"]
    from deepinteract_tpu_torch.obs import metrics as obs_metrics
    gauge = obs_metrics.get_registry().gauge("di_train_metric", labelnames=("metric",))
    assert gauge.value(metric="val_ce") == history[0]["val_ce"]


def test_nan_batch_skipped_inside_a_run(batches, monkeypatch):
    """The third batch poisoned inside runs of 2: its update is skipped,
    training goes on, the epoch mean stays finite."""
    from deepinteract_tpu_torch.obs import metrics as obs_metrics
    from deepinteract_tpu_torch.robustness import faults

    monkeypatch.delenv("DI_FAULTS", raising=False)
    skipped = obs_metrics.get_registry().counter("di_train_skipped_steps_total")
    before = skipped.value()
    faults.configure({"train.nan_batch": [3]})
    try:
        trainer = _toy_trainer(steps_per_dispatch=2)
        state, history = trainer.fit(trainer.init_state(), batches)
    finally:
        faults.reset()
    assert (state.step, state.bad_steps) == (3, 0)
    assert history[0]["train_skipped_steps"] == 1.0 and np.isfinite(history[0]["train_loss"])
    assert skipped.value() == before + 1


def test_telemetry_sidecar_and_span_log(batches, tmp_path):
    from deepinteract_tpu_torch.obs import heartbeat
    from deepinteract_tpu_torch.obs import metrics as obs_metrics
    from deepinteract_tpu_torch.obs import spans
    from deepinteract_tpu_torch.training.loop import read_sidecar

    steps = obs_metrics.get_registry().counter("di_train_steps_total")
    epochs = obs_metrics.get_registry().counter("di_train_epochs_total")
    before = steps.value(), epochs.value()
    trainer = _toy_trainer(2, ckpt_dir=str(tmp_path), heartbeat_seconds=0.05,
                           steps_per_dispatch=2, eval_batches_per_dispatch=1)
    _, history = trainer.fit(trainer.init_state(), batches[:3], val_data=batches[:1])
    for metrics in history:
        for key in ("tele_data_wait_frac", "tele_h2d_frac", "tele_device_frac",
                    "tele_checkpoint_frac", "tele_eval_frac", "tele_data_wait_s",
                    "tele_h2d_s", "tele_device_s"):
            assert key in metrics, key
        assert 0.0 < metrics["tele_device_frac"] <= 1.0
        assert 0.0 <= metrics["tele_data_wait_frac"] <= 1.0
    tele = read_sidecar(str(tmp_path))["telemetry"]
    assert tele == {k: v for k, v in history[-1].items() if k.startswith("tele_")}
    events = spans.read_events(str(tmp_path / "obs" / "events.jsonl"))
    paths = {e["path"] for e in events}
    assert {"epoch", "epoch/step", "epoch/step/device_step", "epoch/step/h2d",
            "epoch/data_wait", "epoch/eval", "epoch/checkpoint"} <= paths
    assert sorted(e["epoch"] for e in events if e["name"] == "epoch") == [0, 1]
    # Runs of 2 over 3 batches: a dispatch of 2, then one of 1, per epoch.
    assert [(e["step_num"], e["n"]) for e in events if e["name"] == "step"] == \
        [(0, 2), (1, 1), (2, 2), (3, 1)]
    beat = heartbeat.read(str(tmp_path / "obs" / "heartbeat_p0.json"))
    assert (beat["step"], beat["epoch"]) == (3, 1)
    assert (steps.value(), epochs.value()) == (before[0] + 6, before[1] + 2)
    assert not spans.configured()  # the fit closed the sink it opened


def _trace_steps(path):
    import json

    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    return sorted(int(n.split("#")[1]) for n in names if n.startswith("step#")), names


def test_profile_window_covers_dispatches_one_to_n(batches, tmp_path):
    """--profile_dir: a CPU torch.profiler window over train dispatches
    [1, 1 + profile_steps), read back from the spans' profiler ranges;
    closed by fit's finally on a short run; counted across epochs; and a
    run without a second dispatch says nothing was captured."""
    from deepinteract_tpu_torch.obs import spans

    trainer = _toy_trainer(profile_dir=str(tmp_path / "p"), profile_steps=2)
    trainer.fit(trainer.init_state(), batches)
    found, names = _trace_steps(str(tmp_path / "p" / "trace.json"))
    assert found == [1, 2] and "device_step" in names and "h2d" in names
    assert not spans.annotations_enabled()

    trainer = _toy_trainer(profile_dir=str(tmp_path / "short"), profile_steps=99)
    trainer.fit(trainer.init_state(), batches)  # the window outlasts the run
    assert _trace_steps(str(tmp_path / "short" / "trace.json"))[0] == [1, 2, 3]

    trainer = _toy_trainer(2, profile_dir=str(tmp_path / "epochs"), profile_steps=1)
    trainer.fit(trainer.init_state(), batches[:1])  # one dispatch per epoch
    assert _trace_steps(str(tmp_path / "epochs" / "trace.json"))[0] == [1]

    logs = []
    trainer = _toy_trainer(logs=logs, profile_dir=str(tmp_path / "none"))
    trainer.fit(trainer.init_state(), batches[:1])
    assert not os.path.exists(tmp_path / "none")
    assert any("nothing was captured" in m for m in logs)
