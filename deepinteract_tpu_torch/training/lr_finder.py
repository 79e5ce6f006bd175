"""Learning-rate range test (the reference's optional ``lr_find``, gated by
``--find_lr``).

Port of ``deepinteract_tpu/training/lr_finder.py``: sweep the learning
rate geometrically from ``min_lr`` to ``max_lr`` over ``num_steps`` train
steps on a copy of the model (the caller's weights are left as they
were), record the loss of each step, stop on divergence (a loss above 4x
the best so far, Lightning's rule), and suggest the rate at the steepest
descent of the smoothed loss curve.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from deepinteract_tpu_torch.data.graph import PairedComplex
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.training.optim import OptimConfig
from deepinteract_tpu_torch.training.steps import create_train_state, train_step


def lr_find(model: DeepInteract, data: Iterable[PairedComplex],
            optim_cfg: Optional[OptimConfig] = None, min_lr: float = 1e-6,
            max_lr: float = 1.0, num_steps: int = 30, seed: int = 42,
            weight_classes: bool = False) -> Tuple[float, List[Tuple[float, float]]]:
    """Returns (suggested lr, [(lr, loss), ...]). ``data`` is cycled when
    it holds fewer than ``num_steps`` batches. Step i runs at ``min_lr *
    (max_lr / min_lr) ** (i / (num_steps - 1))`` under the optimizer chain
    without accumulation."""
    cfg = dataclasses.replace(optim_cfg or OptimConfig(), lr=min_lr, accumulate_steps=1)
    ratio = max_lr / min_lr
    span = max(num_steps - 1, 1)
    state = create_train_state(copy.deepcopy(model), seed, cfg)
    # The sweep replaces the schedule: AdamW's count -> rate, on the device.
    state.optimizer.lr_at = lambda count: min_lr * ratio ** (count.to(torch.float32) / span)
    batches = list(data)
    history: List[Tuple[float, float]] = []
    best = np.inf
    for i in range(num_steps):
        lr = min_lr * ratio ** (i / span)
        loss = train_step(state, batches[i % len(batches)], weight_classes)["loss"]
        history.append((lr, loss))
        if np.isfinite(loss):
            best = min(best, loss)
        if not np.isfinite(loss) or loss > 4.0 * best:
            break  # diverged
    return suggest_lr(history), history


def suggest_lr(history: List[Tuple[float, float]]) -> float:
    """The rate at the steepest negative slope of the smoothed loss over
    log(lr)."""
    if len(history) < 4:
        return history[len(history) // 2][0] if history else 1e-3
    lrs = np.array([h[0] for h in history])
    losses = np.array([h[1] for h in history])
    finite = np.isfinite(losses)
    lrs, losses = lrs[finite], losses[finite]
    if len(losses) < 4:
        return 1e-3
    smoothed = np.empty_like(losses)
    acc = losses[0]
    for i, loss in enumerate(losses):
        acc = 0.7 * acc + 0.3 * loss
        smoothed[i] = acc
    grads = np.gradient(smoothed, np.log(lrs))
    return float(lrs[int(np.argmin(grads))])
