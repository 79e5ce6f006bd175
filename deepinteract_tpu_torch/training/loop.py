"""The training loop: epochs, validation, early stopping, checkpoints,
resume, SWA.

Port of ``deepinteract_tpu/training/loop.py`` on one device: a
:class:`Trainer` that runs train epochs of :func:`~.steps.train_step`
under the non-finite guard, evaluates the reference's metric suite
(median over complexes; L = n1 + n2 at validation, min(n1, n2) at test)
after each epoch, and stops early on the tracked metric (patience 5,
min_delta 5e-6, mode 'min' iff the name contains 'ce').

With ``LoopConfig.ckpt_dir`` it checkpoints (``training/checkpoint.py``):
epoch ``e``'s end is saved as step ``e + 1`` into best/ and last/, and the
``trainer_state.json`` sidecar holds the early-stopping counters as of that
boundary; ``save_every_steps`` adds mid-epoch saves to mid/ with the
loader cursor in the sidecar. ``fit(resume=True)`` restores the newest
position and reproduces the uninterrupted run. A preemption (SIGTERM, or
the ``train.sigterm`` fault site) stops the loop before the next step,
drains the save in flight and raises ``TrainingPreempted``. SWA averages
the parameters of the last epochs and refreshes the batch statistics.
Telemetry spans, the diagnostics dump and multi-device dispatch are not
ported.

Data sources are callables ``epoch -> iterable of PairedComplex`` (the
loader re-shuffles per epoch) or plain sequences of padded batches.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from deepinteract_tpu_torch.data.graph import PairedComplex
from deepinteract_tpu_torch.models.layers import dropout_rng
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.robustness import artifacts, faults
from deepinteract_tpu_torch.robustness.guards import NonFiniteTrainingError
from deepinteract_tpu_torch.robustness.preemption import PreemptionGuard, TrainingPreempted
from deepinteract_tpu_torch.training import metrics as M
from deepinteract_tpu_torch.training.checkpoint import (CheckpointConfig, Checkpointer,
                                                        decode_position, metric_mode)
from deepinteract_tpu_torch.training.optim import OptimConfig
from deepinteract_tpu_torch.training.steps import (TrainState, create_train_state,
                                                   dropout_generator, eval_step, train_step)

DataSource = Union[Sequence[PairedComplex], Callable[[int], Iterable[PairedComplex]]]
SIDECAR_KIND = "trainer-state"


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    num_epochs: int = 50
    metric_to_track: str = "val_ce"
    patience: int = 5
    min_delta: float = 5e-6
    ckpt_dir: Optional[str] = None
    save_top_k: int = 3
    seed: int = 42
    weight_classes: bool = False
    pos_prob_threshold: float = 0.5
    log_every: int = 100
    max_time_seconds: Optional[float] = None
    # Stochastic weight averaging: the running mean of the parameters of
    # each epoch from ceil(swa_epoch_start * epochs) on replaces the
    # trained ones when the loop ends.
    swa: bool = False
    swa_epoch_start: float = 0.8
    # Skip the optimizer update of a step whose loss or gradients are not
    # finite, and abort after max_bad_steps consecutive skips.
    nonfinite_guard: bool = True
    max_bad_steps: int = 10
    # SIGTERM/SIGINT handlers around fit: stop before the next step, flush
    # the newest checkpoint, raise TrainingPreempted.
    preemption_guard: bool = True
    # Mid-epoch save cadence in train steps (0: epoch boundaries only).
    save_every_steps: int = 0
    # Write the epoch-boundary save on a worker thread while the next
    # epoch trains. The state is copied to host memory first, on the loop's
    # thread, so the JAX package's fallback for a device snapshot that
    # exhausts device memory has no counterpart here.
    async_checkpoint: bool = True


class EarlyStopping:
    """Stop after ``patience`` consecutive epochs without an improvement
    of at least ``min_delta``. A non-finite value counts against patience
    and never becomes the best."""

    def __init__(self, mode: str, patience: int, min_delta: float):
        self.mode = mode
        self.patience = patience
        self.min_delta = min_delta
        self.best = math.inf if mode == "min" else -math.inf
        self.stale_epochs = 0

    def update(self, value: float) -> bool:
        """Record one epoch's value; True when training should stop."""
        improved = math.isfinite(value) and (
            value < self.best - self.min_delta if self.mode == "min"
            else value > self.best + self.min_delta)
        if improved:
            self.best = value
            self.stale_epochs = 0
        else:
            self.stale_epochs += 1
        return self.stale_epochs >= self.patience


@dataclasses.dataclass
class ResumeCursor:
    """Where a resumed fit starts: the epoch and batch decoded from the
    restored step, and, in mid-epoch, the interrupted epoch's loss ledger
    and skip counts from the sidecar."""
    epoch: int = 0
    batch: int = 0
    skips_used: int = 0
    skipped_steps: int = 0
    losses: List[float] = dataclasses.field(default_factory=list)


def _iter_data(data: DataSource, epoch: int) -> Iterable[PairedComplex]:
    return data(epoch) if callable(data) else data


def _complex_ce(logits: np.ndarray, examples: np.ndarray, mask: np.ndarray) -> float:
    """Per-complex cross entropy over its example list."""
    ex = examples[mask]
    sel = logits[ex[:, 0], ex[:, 1]]  # [M, 2]
    sel = sel - sel.max(axis=-1, keepdims=True)
    logp = sel - np.log(np.sum(np.exp(sel), axis=-1, keepdims=True))
    return float(-np.mean(logp[np.arange(len(ex)), ex[:, 2]]))


def host_snapshot(state: TrainState) -> Dict:
    """``state.state_dict()`` with every tensor copied to host memory: what
    a checkpoint writes, safe from the next step's in-place updates."""
    def copy(value):
        if isinstance(value, torch.Tensor):
            return value.detach().to("cpu", copy=True)
        if isinstance(value, dict):
            return {k: copy(v) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return type(value)(copy(v) for v in value)
        return value
    return copy(state.state_dict())


def sidecar_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "trainer_state.json")


def write_sidecar(ckpt_dir: str, payload: Dict[str, Any]) -> None:
    """The loop's bookkeeping beside the checkpoint roots, with an
    integrity sidecar. ``json`` writes a fresh stopper's +-inf as
    ``Infinity`` (the JAX package's encoding, which both read back)."""
    artifacts.atomic_write_artifact(sidecar_path(ckpt_dir), json.dumps(payload), SIDECAR_KIND)


def read_sidecar(ckpt_dir: str) -> Optional[Dict[str, Any]]:
    """None when absent or corrupt (a corrupt one is quarantined): the
    restored step is the source of truth, and without the sidecar a resume
    only loses the early-stopping counters and the partial epoch's loss
    ledger."""
    path = sidecar_path(ckpt_dir)
    if not os.path.exists(path):
        return None
    try:
        raw = artifacts.verify_read(path, kind=SIDECAR_KIND, require_sidecar=False)
        return json.loads(raw.decode("utf-8"))
    except (artifacts.ArtifactError, UnicodeDecodeError, ValueError) as exc:
        artifacts.quarantine(path, SIDECAR_KIND, str(exc))
        return None
    except OSError:
        return None


class _Saver:
    """Epoch-boundary saves: synchronous, or (``async_``) on one worker
    thread with at most one save in flight; a worker's error re-raises at
    the next submit or drain."""

    def __init__(self, ckpt: Checkpointer, async_: bool):
        self.ckpt = ckpt
        self.pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-save") \
            if async_ else None
        self.pending: Optional[Future] = None

    def submit(self, step: int, state: TrainState, metrics: Dict) -> None:
        self.drain()
        snapshot = host_snapshot(state)  # before the next step moves the weights
        if self.pool is None:
            self.ckpt.save(step, snapshot, metrics)
        else:
            self.pending = self.pool.submit(self.ckpt.save, step, snapshot, dict(metrics))

    def drain(self) -> None:
        if self.pending is not None:
            pending, self.pending = self.pending, None
            pending.result()

    def close(self) -> None:
        try:
            self.drain()
        finally:
            if self.pool is not None:
                self.pool.shutdown(wait=True)


class Trainer:
    """Runs train and validation epochs of a :class:`DeepInteract` on the
    device its parameters are on."""

    def __init__(self, model: DeepInteract, loop_cfg: LoopConfig = LoopConfig(),
                 optim_cfg: Optional[OptimConfig] = None,
                 log_fn: Callable[[str], None] = print):
        self.model = model
        self.cfg = loop_cfg
        self.optim_cfg = optim_cfg or OptimConfig()
        self.log = log_fn
        # The guard of the running fit (None outside fit or when off).
        self._preempt: Optional[PreemptionGuard] = None
        # Train steps run by this trainer (a resumed fit runs only the
        # steps after its checkpoint).
        self.steps_run = 0

    def init_state(self, fine_tune_from: Optional[str] = None) -> TrainState:
        """The train state around the model's current weights, seeded (for
        dropout) from ``LoopConfig.seed``. ``fine_tune_from`` (a checkpoint
        directory) restores the model from its best/ step and freezes the
        decoder, the reference's fine-tune mode."""
        state = create_train_state(self.model, self.cfg.seed, self.optim_cfg,
                                   frozen_prefixes=("decoder",) if fine_tune_from else ())
        if fine_tune_from:
            Checkpointer(CheckpointConfig(directory=fine_tune_from)).restore(
                state, which="best", partial=True)
        return state

    def evaluate(self, state: TrainState, data: DataSource, stage: str = "val",
                 targets: Optional[List[str]] = None,
                 csv_path: Optional[str] = None) -> Dict[str, float]:
        """The reference metric suite over ``data``, median over complexes
        (``{stage}_ce`` is the mean), with ``stage`` picking the L
        convention. ``csv_path`` writes the per-target top-k CSV."""
        per_complex: List[Dict[str, float]] = []
        for batch in _iter_data(data, 0):
            out = eval_step(state, batch, self.cfg.weight_classes)
            probs = out["probs"].float().cpu().numpy()
            logits = out["logits"].float().cpu().numpy()
            for b in range(probs.shape[0]):
                examples = batch.examples[b].numpy()
                mask = batch.example_mask[b].numpy()
                pos_probs, labels = M.gather_pair_predictions(probs[b], examples, mask)
                per_complex.append(M.complex_metrics(
                    pos_probs, labels, int(batch.graph1.num_nodes[b]),
                    int(batch.graph2.num_nodes[b]), stage=stage,
                    threshold=self.cfg.pos_prob_threshold,
                    ce=_complex_ce(logits[b], examples, mask)))
        if csv_path:
            names = targets or [f"complex_{i}" for i in range(len(per_complex))]
            M.write_topk_csv(per_complex, names, csv_path)
        return {(f"med_{stage}_{k[4:]}" if k.startswith("med_") else f"{stage}_{k}"): v
                for k, v in M.aggregate_median(per_complex).items()}

    def _check_preempt(self) -> None:
        if self._preempt is not None:
            self._preempt.check()

    def _epoch_source(self, data: DataSource, epoch: int, start_batch: int, skips_used: int):
        """The epoch's batches from a mid-epoch cursor: a loader with a
        cursor skips the paid prefix unloaded, any other source loads and
        drops it."""
        if not start_batch and not skips_used:
            return iter(_iter_data(data, epoch))
        if callable(getattr(data, "iter_epoch", None)):
            return data.iter_epoch(epoch, start_batch=start_batch, skips_used=skips_used)
        source = iter(_iter_data(data, epoch))
        for _ in range(start_batch):
            next(source, None)
        return source

    def _train_epoch(self, state: TrainState, data: DataSource, epoch: int,
                     losses: List[float], stats: Dict[str, int], start_batch: int = 0,
                     skips_used: int = 0, save_fn=None) -> None:
        """One epoch of train steps, appending to ``losses`` (which holds the
        paid batches' losses when resuming mid-epoch) and counting skipped
        steps in ``stats``; ``save_fn(state, batches_done)`` runs every
        ``save_every_steps`` steps."""
        cfg = self.cfg
        since_save = 0
        for batch in self._epoch_source(data, epoch, start_batch, skips_used):
            if faults.fire("train.sigterm") and self._preempt is not None:
                self._preempt.request("injected SIGTERM (fault plan)")
            batch = faults.maybe_poison("train.nan_batch", batch)
            self._check_preempt()
            m = train_step(state, batch, cfg.weight_classes, guard=cfg.nonfinite_guard)
            self.steps_run += 1
            losses.append(m["loss"])
            if m.get("bad_step"):
                stats["skipped_steps"] += 1
                self.log(f"epoch {epoch} step {len(losses)}: non-finite loss/grads "
                         f"(loss={m['loss']}) - optimizer update skipped")
                if state.bad_steps >= cfg.max_bad_steps:
                    raise NonFiniteTrainingError(
                        f"aborting: {state.bad_steps} consecutive non-finite train steps "
                        f"(epoch {epoch}, step {len(losses)}, max_bad_steps="
                        f"{cfg.max_bad_steps})")
            if cfg.log_every and len(losses) % cfg.log_every == 0:
                self.log(f"epoch {epoch} step {len(losses)}: loss={m['loss']:.4f} "
                         f"grad_norm={m['grad_norm']:.4f}")
            since_save += 1
            if save_fn is not None and since_save >= cfg.save_every_steps:
                save_fn(state, len(losses))
                since_save = 0

    def _make_midsave(self, ckpt: Checkpointer, saver: _Saver, epoch: int,
                      stopper: EarlyStopping, losses: List[float], stats: Dict[str, int],
                      data: DataSource, base_skips: int):
        """The mid-epoch save: the state into mid/ at the position reached,
        then the sidecar's cursor (loss ledger, skip ledger), so a resume
        lands on the next batch with this epoch's metrics intact."""
        skips_fn = getattr(data, "skips_before", None)

        def midsave(state: TrainState, batches_done: int) -> None:
            saver.drain()  # the boundary save in flight shares the retention of last/
            ckpt.save_midepoch(epoch, batches_done, host_snapshot(state))
            skips = int(skips_fn(batches_done)) if callable(skips_fn) else base_skips
            write_sidecar(self.cfg.ckpt_dir, {
                "epoch": epoch, "stopper_best": stopper.best,
                "stopper_stale": stopper.stale_epochs,
                "cursor": {"epoch": epoch, "batch_index": int(batches_done),
                           "opt_step": int(state.step), "seed": self.cfg.seed,
                           "skips_used": skips, "skipped_steps": int(stats["skipped_steps"]),
                           "loss_ledger": [float(x) for x in losses]}})

        return midsave

    def _resume(self, ckpt: Checkpointer, state: TrainState,
                stopper: EarlyStopping) -> ResumeCursor:
        """Restore the newest position (mid/, last/ or best/, verified,
        walking back past corrupt steps) into ``state`` and the stopper;
        the position comes from the step actually restored."""
        ckpt.restore(state, which="mid")
        epoch, batch = decode_position(ckpt.last_restored_which, ckpt.last_restored_step)
        cursor = ResumeCursor(epoch, batch)
        sidecar = read_sidecar(self.cfg.ckpt_dir)
        # A sidecar of another epoch (killed between the save and its
        # write) is ignored: the restored step is the source of truth.
        if sidecar and int(sidecar.get("epoch", -1)) == epoch:
            stopper.best = float(sidecar["stopper_best"])
            stopper.stale_epochs = int(sidecar["stopper_stale"])
        if not batch:
            self.log(f"resumed from epoch {epoch}")
            return cursor
        cur = (sidecar or {}).get("cursor") or {}
        if int(cur.get("epoch", -1)) == epoch and int(cur.get("batch_index", -1)) == batch:
            cursor.losses = [float(x) for x in cur.get("loss_ledger", [])]
            cursor.skips_used = int(cur.get("skips_used", 0))
            cursor.skipped_steps = int(cur.get("skipped_steps", 0))
        else:
            self.log("mid-epoch resume: the trainer_state.json cursor does not match the "
                     "restored checkpoint; the position is exact but the interrupted epoch's "
                     "train_loss covers only the re-run batches")
        self.log(f"resumed from epoch {epoch}, batch {batch}")
        return cursor

    def fit(self, state: TrainState, train_data: DataSource,
            val_data: Optional[DataSource] = None, num_epochs: Optional[int] = None,
            resume: bool = False):
        """Run the epoch loop. Returns (state, history: one metric dict per
        epoch run). With ``resume`` and a checkpoint under ``ckpt_dir``, the
        run continues from its newest position."""
        cfg = self.cfg
        ckpt = Checkpointer(CheckpointConfig(directory=cfg.ckpt_dir,
                                             metric_to_track=cfg.metric_to_track,
                                             save_top_k=cfg.save_top_k)) if cfg.ckpt_dir else None
        stopper = EarlyStopping(metric_mode(cfg.metric_to_track), cfg.patience, cfg.min_delta)
        cursor = ResumeCursor()
        if resume and ckpt is not None and ckpt.has_restorable():
            cursor = self._resume(ckpt, state, stopper)
        epochs = cfg.num_epochs if num_epochs is None else num_epochs
        swa_first = int(math.ceil(cfg.swa_epoch_start * epochs))
        swa_params: Optional[List[torch.Tensor]] = None
        swa_count = 0
        history: List[Dict[str, float]] = []
        saver = _Saver(ckpt, cfg.async_checkpoint) if ckpt is not None else None
        preempt = PreemptionGuard(log=self.log) if cfg.preemption_guard else None
        self._preempt = preempt
        t_start = time.time()
        abort: Optional[Exception] = None
        try:
            if preempt is not None:
                preempt.__enter__()
            for epoch in range(cursor.epoch, epochs):
                self._check_preempt()
                t0 = time.perf_counter()
                resuming = epoch == cursor.epoch and cursor.batch > 0
                losses = list(cursor.losses) if resuming else []
                stats = {"skipped_steps": cursor.skipped_steps if resuming else 0}
                midsave = None
                if ckpt is not None and cfg.save_every_steps > 0:
                    midsave = self._make_midsave(ckpt, saver, epoch, stopper, losses, stats,
                                                 train_data,
                                                 cursor.skips_used if resuming else 0)
                self._train_epoch(state, train_data, epoch, losses, stats,
                                  start_batch=cursor.batch if resuming else 0,
                                  skips_used=cursor.skips_used if resuming else 0,
                                  save_fn=midsave)
                # Skipped steps made no update: their losses stay out of the mean.
                finite = [x for x in losses if math.isfinite(x)]
                metrics: Dict[str, float] = {
                    "epoch": epoch,
                    "train_loss": float(np.mean(finite)) if finite else float("nan"),
                    "train_steps": float(len(losses)),
                    "train_seconds": time.perf_counter() - t0}
                if cfg.nonfinite_guard:
                    metrics["train_skipped_steps"] = float(stats["skipped_steps"])
                if val_data is not None:
                    metrics.update(self.evaluate(state, val_data, stage="val"))
                metrics["epoch_seconds"] = time.perf_counter() - t0
                history.append(metrics)
                self.log(f"epoch {epoch}: train_loss={metrics['train_loss']:.4f} "
                         f"train_s={metrics['train_seconds']:.1f} " + " ".join(
                             f"{k}={v:.4f}" for k, v in metrics.items()
                             if k.startswith(("val_", "med_val_")) and not math.isnan(v)))
                if cfg.swa and epoch >= swa_first:
                    params = [p.detach().clone() for p in state.model.parameters()]
                    swa_count += 1
                    if swa_params is None:
                        swa_params = params
                    else:
                        for avg, p in zip(swa_params, params):
                            avg.add_((p - avg) / swa_count)
                if saver is not None:
                    t_save = time.perf_counter()
                    saver.submit(epoch + 1, state, metrics)
                    metrics["checkpoint_seconds"] = time.perf_counter() - t_save
                stop = False
                if val_data is not None and stopper.update(
                        metrics.get(cfg.metric_to_track, float("nan"))):
                    self.log(f"early stop at epoch {epoch}: no {cfg.metric_to_track} "
                             f"improvement in {cfg.patience} epochs (best {stopper.best:.6f})")
                    stop = True
                if ckpt is not None:
                    # After stopper.update: a resume at this boundary takes the
                    # counters as they stand here.
                    write_sidecar(cfg.ckpt_dir, {"epoch": epoch + 1,
                                                 "stopper_best": stopper.best,
                                                 "stopper_stale": stopper.stale_epochs})
                if cfg.max_time_seconds and time.time() - t_start > cfg.max_time_seconds:
                    self.log("max_time reached; stopping")
                    stop = True
                if stop:
                    break
        except (TrainingPreempted, NonFiniteTrainingError) as exc:
            abort = exc  # raised after the drain below: the save in flight lands first
        finally:
            try:
                if saver is not None:
                    saver.close()
            finally:
                if preempt is not None:
                    preempt.__exit__(None, None, None)
                self._preempt = None
        if abort is not None:
            if isinstance(abort, TrainingPreempted):
                self.log(f"preempted ({abort}): the newest checkpoint is flushed - rerun "
                         "with resume=True to continue")
            raise abort
        if swa_params is not None:
            self.log(f"SWA: averaged {swa_count} epoch snapshot(s) into the final params")
            with torch.no_grad():
                for p, avg in zip(state.model.parameters(), swa_params):
                    p.copy_(avg)
            self.refresh_batch_stats(state, train_data)
            if ckpt is not None and history:
                # cli.test and predict then load the weights the last metrics
                # were computed with.
                ckpt.save(history[-1]["epoch"] + 2, host_snapshot(state), history[-1])
        if ckpt is not None:
            ckpt.close()
        return state, history

    @torch.no_grad()
    def refresh_batch_stats(self, state: TrainState, data: DataSource) -> None:
        """One train-mode pass over epoch 0 of ``data`` without gradients:
        the batch-norm running statistics of the current parameters."""
        model = state.model
        device = next(model.parameters()).device
        model.train()
        with dropout_rng(model, dropout_generator(state.seed, state.step, device)):
            for batch in _iter_data(data, 0):
                batch = batch.to(device)
                model(batch.graph1, batch.graph2)
