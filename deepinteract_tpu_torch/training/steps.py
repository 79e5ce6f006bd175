"""Train and eval steps over a :class:`TrainState`.

Port of ``deepinteract_tpu/training/steps.py`` (``create_train_state``,
``train_step``, ``eval_step``). The model holds the parameters and the
batch statistics; the state adds the optimizer (AdamW and its schedule),
the step counter and the seed. Step ``s`` draws its dropout masks from a
generator seeded with ``(seed, s)`` alone, the counterpart of
``fold_in(dropout_rng, step)``, so any step can be replayed on its own.
The JAX package's ``multi_*_step`` and ``pack_tree`` amortize the TPU's
host round trip and have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence

import torch

from deepinteract_tpu_torch.data.graph import PairedComplex
from deepinteract_tpu_torch.models.layers import dropout_rng
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.robustness.guards import apply_guarded_update
from deepinteract_tpu_torch.training.objective import contact_loss
from deepinteract_tpu_torch.training.optim import OptimConfig, Optimizer, global_norm


@dataclasses.dataclass
class TrainState:
    model: DeepInteract
    optimizer: Optimizer
    seed: int = 42
    step: int = 0
    # Consecutive non-finite (skipped) steps under the guard.
    bad_steps: int = 0


def create_train_state(model: DeepInteract, seed: int = 42,
                       optim_cfg: Optional[OptimConfig] = None,
                       frozen_prefixes: Sequence[str] = ()) -> TrainState:
    """The state around an initialized model (its weights are the
    caller's: ``weights.init_weights`` or ``load_jax_variables``).
    ``frozen_prefixes`` freezes top-level submodules (``("decoder",)``
    for the reference's fine-tune mode)."""
    return TrainState(model, Optimizer(model.named_parameters(), optim_cfg, frozen_prefixes),
                      seed)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of step ``step`` of a run seeded ``seed``, on
    ``device``. (seed, step) is hashed into the generator's seed: the CPU
    generator keeps only its low 32 bits."""
    digest = hashlib.sha256(f"dropout:{seed}:{step}".encode()).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(digest[:8], "little"))


def loss_and_grads(model: DeepInteract, batch: PairedComplex, weight_classes: bool,
                   generator: torch.Generator) -> torch.Tensor:
    """Train-mode forward (batch statistics updated, dropout drawn from
    ``generator``), the contact loss, and its backward into ``.grad`` of
    every parameter. Returns the loss, detached."""
    model.train()
    model.zero_grad(set_to_none=True)
    with dropout_rng(model, generator):
        logits = model(batch.graph1, batch.graph2)
    loss = contact_loss(logits, batch.contact_map, batch.pair_mask, weight_classes)
    loss.backward()
    return loss.detach()


def train_step(state: TrainState, batch: PairedComplex, weight_classes: bool = False,
               guard: bool = False) -> Dict[str, float]:
    """One optimization step on ``batch`` (moved to the model's device).
    Returns ``loss`` and the pre-clip ``grad_norm`` over every parameter;
    with ``guard``, a non-finite step skips the update
    (:func:`~deepinteract_tpu_torch.robustness.guards.apply_guarded_update`)
    and the metrics gain ``bad_step`` (0/1) and ``bad_steps`` (consecutive
    skips after this step). The gradients stay in ``.grad``."""
    model = state.model
    device = _device(model)
    batch = batch.to(device)
    before = ({name: buf.clone() for name, buf in model.named_buffers()} if guard else None)
    loss = loss_and_grads(model, batch, weight_classes,
                          dropout_generator(state.seed, state.step, device))
    grads: List[torch.Tensor] = [p.grad for p in model.parameters() if p.grad is not None]
    metrics = {"loss": float(loss), "grad_norm": float(global_norm(grads))}
    if guard:
        finite = apply_guarded_update(state, loss, grads, before)
        metrics["bad_step"] = 0.0 if finite else 1.0
        metrics["bad_steps"] = float(state.bad_steps)
    else:
        state.optimizer.update()
        state.step += 1
    return metrics


@torch.no_grad()
def eval_step(state: TrainState, batch: PairedComplex,
              weight_classes: bool = False) -> Dict[str, torch.Tensor]:
    """Eval-mode forward, loss and per-pair probabilities; no update."""
    model = state.model
    batch = batch.to(_device(model))
    model.eval()
    logits = model(batch.graph1, batch.graph2)
    loss = contact_loss(logits, batch.contact_map, batch.pair_mask, weight_classes)
    return {"loss": loss, "probs": torch.softmax(logits, dim=-1), "logits": logits}
