"""The port's trainer lifecycle against the JAX package: a 2-epoch fit with
checkpoints on carried weights (per-epoch metrics, best/latest steps and
the ``trainer_state.json`` bookkeeping), the fine-tune warm start, SWA,
and the LR range test."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinteract_tpu.models.model import DeepInteract as JaxDeepInteract
from deepinteract_tpu.training.checkpoint import CheckpointConfig as JaxCheckpointConfig
from deepinteract_tpu.training.checkpoint import Checkpointer as JaxCheckpointer
from deepinteract_tpu.training.loop import LoopConfig as JaxLoopConfig
from deepinteract_tpu.training.loop import Trainer as JaxTrainer
from deepinteract_tpu.training.loop import _read_sidecar as jax_read_sidecar
from deepinteract_tpu.training.lr_finder import suggest_lr as jax_suggest_lr
from deepinteract_tpu.training.optim import OptimConfig as JaxOptimConfig
from deepinteract_tpu.training.optim import make_optimizer
from deepinteract_tpu.training.steps import TrainState as JaxTrainState
from deepinteract_tpu_torch.data.graph import stack_complexes
from deepinteract_tpu_torch.data.synthetic import random_complex
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.training.checkpoint import CheckpointConfig, Checkpointer
from deepinteract_tpu_torch.training.loop import LoopConfig, Trainer, read_sidecar
from deepinteract_tpu_torch.training.lr_finder import lr_find, suggest_lr
from deepinteract_tpu_torch.training.optim import OptimConfig
from deepinteract_tpu_torch.weights import init_weights, load_jax_variables
from torch_port_helpers import KNN, N1, N2, PAD, complexes, jax_cfg, port_cfg, random_variables

TOL = 1e-4


def _shallow(cfg):
    """One GT layer and one decoder chunk (either package's config)."""
    return dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn, num_layers=1),
                               decoder=dataclasses.replace(cfg.decoder, num_chunks=1))


def test_fit_with_checkpoints_matches_jax_trainer(tmp_path):
    """Two epochs of JAX ``Trainer.fit`` and the port's, layer norm, no
    dropout, from one random variables tree: per-epoch train_loss and
    val_ce within 1e-4, the same best and latest steps, and the same
    trainer_state.json (stopper_best within 1e-4)."""
    pairs = [complexes(seed=s) for s in (31, 32, 33)]
    train_j, train_p = [p[0] for p in pairs[:2]], [p[1] for p in pairs[:2]]
    val_j, val_p = [pairs[2][0]], [pairs[2][1]]
    jcfg = _shallow(jax_cfg(norm_type="layer"))
    variables = random_variables(jcfg, train_j[0], seed=31)
    optim = dict(lr=1e-3, steps_per_epoch=2, num_epochs=2, t0_epochs=1)

    jax_model = JaxDeepInteract(jcfg)
    jax_trainer = JaxTrainer(
        jax_model, JaxLoopConfig(num_epochs=2, ckpt_dir=str(tmp_path / "jax"), log_every=0,
                                 eval_batches_per_dispatch=1, span_log=False),
        JaxOptimConfig(**optim), log_fn=lambda s: None)
    # The state around the carried weights, without the trainer's jitted init.
    jstate = JaxTrainState.create(apply_fn=jax_model.apply, params=variables["params"],
                                  tx=make_optimizer(JaxOptimConfig(**optim)), batch_stats={},
                                  dropout_rng=jax.random.PRNGKey(0),
                                  bad_steps=jnp.zeros((), jnp.int32))
    _, jax_history = jax_trainer.fit(jstate, train_j, val_data=val_j)

    cfg = _shallow(port_cfg(norm_type="layer"))
    model = DeepInteract(dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn,
                                                                          dropout_rate=0.0)))
    load_jax_variables(model, variables)
    trainer = Trainer(model, LoopConfig(num_epochs=2, ckpt_dir=str(tmp_path / "port"),
                                        log_every=0), OptimConfig(**optim),
                      log_fn=lambda s: None)
    _, history = trainer.fit(trainer.init_state(), train_p, val_data=val_p)

    for got, ref in zip(history, jax_history):
        for key in ("train_loss", "val_ce"):
            np.testing.assert_allclose(got[key], ref[key], rtol=TOL, atol=TOL, err_msg=key)
    jck = JaxCheckpointer(JaxCheckpointConfig(directory=str(tmp_path / "jax")))
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path / "port")))
    assert (ck.best_step(), ck.latest_step()) == (jck.best_step(), jck.latest_step())
    jck.close()
    side, jax_side = read_sidecar(str(tmp_path / "port")), jax_read_sidecar(str(tmp_path / "jax"))
    assert (side["epoch"], side["stopper_stale"]) == (jax_side["epoch"],
                                                      jax_side["stopper_stale"])
    np.testing.assert_allclose(side["stopper_best"], jax_side["stopper_best"], rtol=TOL,
                               atol=TOL)


def _model(seed=4):
    model = DeepInteract(_shallow(port_cfg()))
    init_weights(model, seed)
    return model


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(8)
    return [stack_complexes([random_complex(N1, N2, rng, n_pad1=PAD, n_pad2=PAD, knn=KNN)])
            for _ in range(2)]


def _trainer(model, epochs, **loop):
    return Trainer(model, LoopConfig(num_epochs=epochs, log_every=0, seed=5, **loop),
                   OptimConfig(lr=1e-2, steps_per_epoch=2, num_epochs=4),
                   log_fn=lambda s: None)


def test_fine_tune_restores_best_and_freezes_the_decoder(batches, tmp_path):
    """init_state(fine_tune_from=DIR) loads best/'s model; training then
    moves the encoder and leaves every decoder parameter bitwise as
    restored."""
    source = _trainer(_model(), 1, ckpt_dir=str(tmp_path))
    source.fit(source.init_state(), batches, val_data=batches[:1])
    saved = Checkpointer(CheckpointConfig(directory=str(tmp_path))).restore(None)["model"]
    trainer = _trainer(_model(seed=99), 1)
    state = trainer.init_state(fine_tune_from=str(tmp_path))
    assert state.optimizer.frozen_prefixes == ("decoder",)
    for name, value in state.model.state_dict().items():
        assert torch.equal(value, saved[name]), name
    trainer.fit(state, batches)
    assert state.step == 2
    for name, p in state.model.named_parameters():
        moved = not torch.equal(p.detach(), saved[name])
        assert moved != name.startswith("decoder."), name


def test_swa_averages_epoch_snapshots_and_refreshes_batch_stats(batches, tmp_path):
    """swa_epoch_start 0.5 of 4 epochs: the final params are the running
    mean of the params after epochs 2 and 3, the batch statistics are one
    train-mode pass of those params, and the result is saved as step 5."""
    snaps = []
    for epochs in (3, 4):
        trainer = _trainer(_model(), epochs)
        state, _ = trainer.fit(trainer.init_state(), batches)
        snaps.append(state)
    trainer = _trainer(_model(), 4, swa=True, swa_epoch_start=0.5, ckpt_dir=str(tmp_path))
    state, _ = trainer.fit(trainer.init_state(), batches)
    ref = snaps[1]
    with torch.no_grad():
        for p, p2, p3 in zip(ref.model.parameters(), snaps[0].model.parameters(),
                             snaps[1].model.parameters()):
            avg = p2.detach().clone()
            avg.add_((p3.detach() - avg) / 2)
            p.copy_(avg)
    before = {k: v.clone() for k, v in ref.model.named_buffers()}
    trainer.refresh_batch_stats(ref, batches)
    assert any(not torch.equal(v, before[k]) for k, v in ref.model.named_buffers())
    for (name, a), b in zip(state.model.state_dict().items(), ref.model.state_dict().values()):
        assert torch.equal(a, b), name
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    assert ck.latest_step() == 5
    restored = ck.restore(None, which="last")["model"]
    assert all(torch.equal(restored[k], v) for k, v in state.model.state_dict().items())


HISTORIES = [
    [(10 ** (-6 + 0.25 * i), 1.0 - 0.03 * i + 0.02 * math.sin(i)) for i in range(24)],
    [(1e-5 * 2 ** i, v) for i, v in enumerate([2.0, 1.9, float("nan"), 1.5, 1.2, 1.1, 3.0])],
    [(1e-4, 1.0), (1e-3, 0.9), (1e-2, 0.5)],
    [(1e-4, float("nan"))] * 6,
    [],
]


@pytest.mark.parametrize("history", HISTORIES, ids=["smooth", "nan", "short", "all_nan",
                                                     "empty"])
def test_suggest_lr_matches_jax(history):
    assert suggest_lr(history) == jax_suggest_lr(history)


def test_lr_find_sweeps_geometrically_and_keeps_the_weights(batches):
    model = _model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    suggested, history = lr_find(model, batches, OptimConfig(), min_lr=1e-5, max_lr=1e-1,
                                 num_steps=5)
    lrs = [lr for lr, _ in history]
    np.testing.assert_allclose(lrs, np.geomspace(1e-5, 1e-1, 5)[:len(lrs)], rtol=1e-12)
    assert all(math.isfinite(loss) for _, loss in history)
    assert suggested in lrs or len(history) < 4
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
