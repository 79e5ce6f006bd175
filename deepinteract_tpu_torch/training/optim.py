"""Optimizer: global-norm clipping, AdamW and cosine warm restarts, with
optional gradient accumulation and frozen parameter prefixes.

Port of ``deepinteract_tpu/training/optim.py``, which chains
``optax.clip_by_global_norm`` -> ``optax.adamw(cosine_warm_restarts)``,
optionally under ``multi_transform`` (frozen prefixes) and ``MultiSteps``
(accumulation). torch's look-alikes differ from that chain, so it is
written out here:

* the clip scales by ``max_norm / norm`` only when ``norm >= max_norm``,
  with no epsilon (``clip_grad_norm_`` adds 1e-6), and the norm covers the
  trainable parameters only;
* frozen parameters get neither an update nor weight decay; every
  trainable one is decayed, norm scales and biases included;
* the schedule is step-granular (``CosineAnnealingWarmRestarts`` counts
  epochs): ``join_schedules`` of cosine decays as a ``LambdaLR``, step 0 at
  the full rate;
* accumulation averages k micro-step gradients as optax's ``MultiSteps``
  does (``acc += (g - acc) / (i + 1)``); the schedule and Adam's count move
  once per real update, and the parameters do not move in between.

Gradients are read from ``p.grad`` and never modified. ``state_dict`` /
``load_state_dict`` carry AdamW's moments and count, the schedule's step
and the accumulator, so a checkpoint taken between two micro-steps resumes
exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.optim.lr_scheduler import LambdaLR


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-3
    weight_decay: float = 1e-2
    grad_clip_norm: float = 0.5
    t0_epochs: int = 10  # first cosine restart period, in epochs
    t_mult: int = 1  # equal-length restart cycles
    eta_min: float = 0.0
    steps_per_epoch: int = 1000
    num_epochs: int = 50
    accumulate_steps: int = 1


def cosine_warm_restarts(cfg: OptimConfig) -> Callable[[int], float]:
    """Step -> multiplier of ``cfg.lr``: cosine decays of t0_epochs *
    steps_per_epoch steps each (times t_mult per restart) joined end to
    end, down to eta_min, as the JAX package's ``optax.join_schedules`` of
    ``cosine_decay_schedule``s."""
    total = cfg.num_epochs * cfg.steps_per_epoch
    period = cfg.t0_epochs * cfg.steps_per_epoch
    cycles: List[int] = []
    while sum(cycles) < total:
        cycles.append(period)
        period *= cfg.t_mult if cfg.t_mult > 1 else 1
    starts = [sum(cycles[:i]) for i in range(len(cycles))]
    alpha = cfg.eta_min / cfg.lr

    def multiplier(step: int) -> float:
        start, length = starts[0], cycles[0]
        for s, c in zip(starts[1:], cycles[1:]):
            if step >= s:
                start, length = s, c
        count = min(step - start, length)
        return (1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / length)) + alpha

    return multiplier


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))).float())


class AdamW(torch.optim.Optimizer):
    """optax ``adamw`` in optax's arithmetic: mu and nu moments, bias
    corrections, update ``mu_hat / (sqrt(nu_hat) + eps) + wd * p`` scaled
    by ``-lr``. :meth:`step` takes the gradients, one per parameter of the
    single group, in order."""

    def __init__(self, params, lr: float, weight_decay: float,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        (group,) = self.param_groups
        params = group["params"]
        if not params:
            return
        b1, b2 = group["betas"]
        state = self.state[params[0]]
        if "count" not in state:
            state["count"] = 0
            state["mu"] = [torch.zeros_like(p) for p in params]
            state["nu"] = [torch.zeros_like(p) for p in params]
        mu, nu = state["mu"], state["nu"]
        grads = list(grads)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(grads, grads), alpha=1 - b2)
        state["count"] += 1
        mu_hat = torch._foreach_div(mu, 1 - b1 ** state["count"])
        denom = torch._foreach_sqrt(torch._foreach_div(nu, 1 - b2 ** state["count"]))
        torch._foreach_add_(denom, group["eps"])
        update = torch._foreach_div(mu_hat, denom)
        if group["weight_decay"]:
            torch._foreach_add_(update, params, alpha=group["weight_decay"])
        torch._foreach_add_(params, update, alpha=-group["lr"])


class Optimizer:
    """The JAX package's optimizer chain over named parameters.
    ``frozen_prefixes`` names top-level submodules (``"decoder"``) whose
    parameters are left out entirely."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 cfg: Optional[OptimConfig] = None, frozen_prefixes: Sequence[str] = ()):
        self.cfg = cfg = cfg or OptimConfig()
        self.frozen_prefixes = frozen = tuple(frozen_prefixes)
        self.params = [p for name, p in named_params if name.split(".")[0] not in frozen]
        self.adamw = AdamW(self.params, lr=cfg.lr, weight_decay=cfg.weight_decay)
        self.schedule = LambdaLR(self.adamw, cosine_warm_restarts(cfg))
        self._acc: Optional[List[torch.Tensor]] = None
        self._micro = 0

    @torch.no_grad()
    def update(self) -> bool:
        """Apply one (micro-)step from the parameters' ``.grad`` (None
        counts as zero). Returns True when the parameters moved."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        k = self.cfg.accumulate_steps
        if k > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            diff = torch._foreach_sub(grads, self._acc)
            torch._foreach_div_(diff, self._micro + 1)
            torch._foreach_add_(self._acc, diff)
            self._micro += 1
            if self._micro < k:
                return False
            grads, self._acc, self._micro = self._acc, None, 0
        if grads:
            norm = float(global_norm(grads))
            max_norm = self.cfg.grad_clip_norm
            if not norm < max_norm:
                grads = torch._foreach_mul(torch._foreach_div(grads, norm), max_norm)
        self.adamw.step(grads)
        self.schedule.step()
        return True

    def state_dict(self) -> Dict:
        """AdamW (moments, count, the current rate), the schedule's step,
        the accumulator (``_acc``/``_micro``: plain attributes, not torch
        optimizer state) and the frozen prefixes the parameter list was
        cut by. Tensors are the live ones."""
        return {"adamw": self.adamw.state_dict(), "schedule": self.schedule.state_dict(),
                "acc": None if self._acc is None else list(self._acc),
                "micro": self._micro, "frozen_prefixes": list(self.frozen_prefixes)}

    def load_state_dict(self, state: Dict) -> None:
        """Restore :meth:`state_dict`'s output. A state saved over another
        parameter list (another set of frozen prefixes) is refused."""
        if tuple(state["frozen_prefixes"]) != self.frozen_prefixes:
            raise ValueError(
                f"optimizer state was saved with frozen prefixes "
                f"{tuple(state['frozen_prefixes'])}, this optimizer has "
                f"{self.frozen_prefixes}: restore the model only (partial=True)")
        self.adamw.load_state_dict(state["adamw"])
        self.schedule.load_state_dict(state["schedule"])
        acc = state["acc"]
        self._acc = None if acc is None else [
            a.to(device=p.device, dtype=p.dtype).clone() for a, p in zip(acc, self.params)]
        self._micro = int(state["micro"])
