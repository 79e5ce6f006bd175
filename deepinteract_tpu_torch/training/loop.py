"""The training loop: epochs, validation, early stopping.

Port of the core of ``deepinteract_tpu/training/loop.py``: a
:class:`Trainer` that runs train epochs of :func:`~.steps.train_step`
under the non-finite guard, evaluates the reference's metric suite
(median over complexes; L = n1 + n2 at validation, min(n1, n2) at test)
after each epoch, and stops early on the tracked metric (patience 5,
min_delta 5e-6, mode 'min' iff the name contains 'ce'). Checkpoints,
resume, SWA, telemetry and multi-device dispatch are not ported yet.

Data sources are callables ``epoch -> iterable of PairedComplex`` (the
loader re-shuffles per epoch) or plain sequences of padded batches.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from deepinteract_tpu_torch.data.graph import PairedComplex
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.robustness.guards import NonFiniteTrainingError
from deepinteract_tpu_torch.training import metrics as M
from deepinteract_tpu_torch.training.optim import OptimConfig
from deepinteract_tpu_torch.training.steps import (TrainState, create_train_state, eval_step,
                                                   train_step)

DataSource = Union[Sequence[PairedComplex], Callable[[int], Iterable[PairedComplex]]]


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    num_epochs: int = 50
    metric_to_track: str = "val_ce"
    patience: int = 5
    min_delta: float = 5e-6
    seed: int = 42
    weight_classes: bool = False
    pos_prob_threshold: float = 0.5
    log_every: int = 100
    # Skip the optimizer update of a step whose loss or gradients are not
    # finite, and abort after max_bad_steps consecutive skips.
    nonfinite_guard: bool = True
    max_bad_steps: int = 10


def metric_mode(metric_name: str) -> str:
    """'min' iff the tracked metric's name contains 'ce'."""
    return "min" if "ce" in metric_name else "max"


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


def _iter_data(data: DataSource, epoch: int) -> Iterable[PairedComplex]:
    return data(epoch) if callable(data) else data


def _complex_ce(logits: np.ndarray, examples: np.ndarray, mask: np.ndarray) -> float:
    """Per-complex cross entropy over its example list."""
    ex = examples[mask]
    sel = logits[ex[:, 0], ex[:, 1]]  # [M, 2]
    sel = sel - sel.max(axis=-1, keepdims=True)
    logp = sel - np.log(np.sum(np.exp(sel), axis=-1, keepdims=True))
    return float(-np.mean(logp[np.arange(len(ex)), ex[:, 2]]))


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

    def init_state(self) -> TrainState:
        """The train state around the model's current weights, seeded (for
        dropout) from ``LoopConfig.seed``."""
        return create_train_state(self.model, self.cfg.seed, self.optim_cfg)

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

    def _train_epoch(self, state: TrainState, data: DataSource, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        losses: List[float] = []
        skipped = 0
        for batch in _iter_data(data, epoch):
            m = train_step(state, batch, cfg.weight_classes, guard=cfg.nonfinite_guard)
            losses.append(m["loss"])
            if m.get("bad_step"):
                skipped += 1
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
        # Skipped steps made no update: their losses stay out of the mean.
        finite = [x for x in losses if math.isfinite(x)]
        out = {"train_loss": float(np.mean(finite)) if finite else float("nan"),
               "train_steps": float(len(losses))}
        if cfg.nonfinite_guard:
            out["train_skipped_steps"] = float(skipped)
        return out

    def fit(self, state: TrainState, train_data: DataSource,
            val_data: Optional[DataSource] = None, num_epochs: Optional[int] = None):
        """Run the epoch loop. Returns (state, history: one metric dict per
        epoch)."""
        cfg = self.cfg
        stopper = EarlyStopping(metric_mode(cfg.metric_to_track), cfg.patience, cfg.min_delta)
        history: List[Dict[str, float]] = []
        for epoch in range(cfg.num_epochs if num_epochs is None else num_epochs):
            t0 = time.perf_counter()
            metrics: Dict[str, float] = {"epoch": epoch}
            metrics.update(self._train_epoch(state, train_data, epoch))
            metrics["train_seconds"] = time.perf_counter() - t0
            if val_data is not None:
                metrics.update(self.evaluate(state, val_data, stage="val"))
            metrics["epoch_seconds"] = time.perf_counter() - t0
            history.append(metrics)
            self.log(f"epoch {epoch}: train_loss={metrics['train_loss']:.4f} "
                     f"train_s={metrics['train_seconds']:.1f} " + " ".join(
                         f"{k}={v:.4f}" for k, v in metrics.items()
                         if k.startswith(("val_", "med_val_")) and not math.isnan(v)))
            if val_data is not None and stopper.update(
                    metrics.get(cfg.metric_to_track, float("nan"))):
                self.log(f"early stop at epoch {epoch}: no {cfg.metric_to_track} "
                         f"improvement in {cfg.patience} epochs (best {stopper.best:.6f})")
                break
        return state, history
