"""Optimizer: global-norm clipping, AdamW and cosine warm restarts, with
optional gradient accumulation and frozen parameter prefixes, computed on
the parameters' device without a host read.

Port of ``deepinteract_tpu/training/optim.py``, which chains
``optax.clip_by_global_norm`` -> ``optax.adamw(cosine_warm_restarts)``,
optionally under ``multi_transform`` (frozen prefixes) and ``MultiSteps``
(accumulation). torch's look-alikes differ from that chain, so it is
written out here:

* the clip is optax's rule, ``where(norm < max_norm, g, g / norm *
  max_norm)``, with no epsilon (``clip_grad_norm_`` adds 1e-6), over the
  trainable parameters only;
* frozen parameters get neither an update nor weight decay; every
  trainable one is decayed, norm scales and biases included;
* the learning rate is computed on the device from AdamW's count, in
  float32, as optax's ``join_schedules`` of ``cosine_decay_schedule``s
  (step-granular; ``CosineAnnealingWarmRestarts`` counts epochs);
* accumulation averages k micro-step gradients as optax's ``MultiSteps``
  does (``acc += (g - acc) / (i + 1)``); the schedule and Adam's count move
  once per real update, and the parameters do not move in between.

Everything that moves lives in tensors allocated once, on the first
update, and updated in place, so a CUDA graph captured around an update
keeps addressing the live state: one flat float32 buffer each for the
gradients (every parameter's ``.grad`` is a view into it), AdamW's mu and
nu, the accumulator and the update, and int64 scalars for AdamW's count
and the micro-step counter. :meth:`Optimizer.apply_update` takes an
optional device flag (the non-finite guard's): where it is false, nothing
moves. ``state_dict`` / ``load_state_dict`` keep the layout of a torch
``AdamW`` + ``LambdaLR`` pair (count and micro as ints, the schedule's
step), and load writes into the existing tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch


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


def _cycles(cfg: OptimConfig) -> List[int]:
    total = cfg.num_epochs * cfg.steps_per_epoch
    period = cfg.t0_epochs * cfg.steps_per_epoch
    cycles: List[int] = []
    while sum(cycles) < total:
        cycles.append(period)
        period *= cfg.t_mult if cfg.t_mult > 1 else 1
    return cycles


def cosine_warm_restarts_lr(cfg: OptimConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """The learning rate on the device: count (an int64 0-d tensor) -> the
    float32 rate of cosine decays of t0_epochs * steps_per_epoch steps
    each (times t_mult per restart) joined end to end, down to eta_min, as
    the JAX package's ``optax.join_schedules`` of
    ``cosine_decay_schedule``s, in their float32 arithmetic (``lr * ((1 -
    alpha) * 0.5 * (1 + cos(pi * c / T)) + alpha)``). The cycle is picked
    by a gather, not a host branch."""
    cycles = _cycles(cfg)
    starts = [sum(cycles[:i]) for i in range(len(cycles))]
    alpha = cfg.eta_min / cfg.lr
    tables: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def lr(count: torch.Tensor) -> torch.Tensor:
        table = tables.get(count.device)
        if table is None:
            table = tables[count.device] = (
                torch.tensor(starts, dtype=torch.int64, device=count.device),
                torch.tensor(cycles, dtype=torch.int64, device=count.device))
        start_t, length_t = table
        cycle = ((count >= start_t).sum() - 1).reshape(1)
        start, length = start_t.index_select(0, cycle)[0], length_t.index_select(0, cycle)[0]
        c = torch.minimum(count - start, length).to(torch.float32)
        decay = 0.5 * (1 + torch.cos(math.pi * c / length.to(torch.float32)))
        return cfg.lr * ((1 - alpha) * decay + alpha)

    return lr


def _views(flat: torch.Tensor, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, offset = [], 0
    for p in params:
        out.append(flat[offset:offset + p.numel()].view_as(p))
        offset += p.numel()
    return out


class AdamW(torch.optim.Optimizer):
    """optax ``adamw`` in optax's arithmetic: mu and nu moments, bias
    corrections, update ``mu_hat / (sqrt(nu_hat) + eps) + wd * p`` scaled
    by ``-lr``. The state of its single group (``self.state[params[0]]``)
    is flat: ``mu`` / ``nu`` are lists of per-parameter views into the
    flat ``mu_flat`` / ``nu_flat``, ``count`` an int64 0-d tensor."""

    def __init__(self, params, lr: float, weight_decay: float,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, betas=betas, eps=eps))

    @property
    def params(self) -> List[torch.nn.Parameter]:
        return self.param_groups[0]["params"]

    def buffers(self) -> Dict:
        """The group's state, allocated on the first call on the
        parameters' device and never reallocated."""
        params = self.params
        state = self.state[params[0]]
        if "count" not in state:
            for p in params:
                if p.dtype != torch.float32 or not p.is_contiguous():
                    raise TypeError(f"AdamW keeps flat float32 state: a parameter is "
                                    f"{p.dtype}, contiguous={p.is_contiguous()}")
            device = params[0].device
            n = sum(p.numel() for p in params)
            mu, nu = (torch.zeros(n, device=device) for _ in range(2))
            update = torch.zeros(n, device=device)
            state.update(count=torch.zeros((), dtype=torch.int64, device=device),
                         mu_flat=mu, nu_flat=nu, mu=_views(mu, params), nu=_views(nu, params),
                         update_flat=update, update=_views(update, params))
        return state

    @torch.no_grad()
    def step(self, grads: torch.Tensor, lr: torch.Tensor,
             apply: Optional[torch.Tensor] = None) -> None:
        """One update from ``grads``, the flat gradient of every parameter
        in order, at the float32 rate ``lr``. ``apply`` (a bool 0-d
        tensor) masks it: where false, mu, nu, count and the parameters
        keep their values exactly (the rate becomes 0 and the update is
        finite)."""
        (group,) = self.param_groups
        st = self.buffers()
        b1, b2 = group["betas"]
        mu, nu, count = st["mu_flat"], st["nu_flat"], st["count"]
        new_mu = torch.mul(mu, b1).add_(grads, alpha=1 - b1)
        new_nu = torch.mul(nu, b2).add_(grads * grads, alpha=1 - b2)
        if apply is None:
            mu.copy_(new_mu)
            nu.copy_(new_nu)
        else:
            mu.copy_(torch.where(apply, new_mu, mu))
            nu.copy_(torch.where(apply, new_nu, nu))
            lr = torch.where(apply, lr, torch.zeros_like(lr))
        # The bias corrections of the update's count: count + 1 whether or
        # not it applies, so a masked update stays finite.
        count_inc = (count + 1).to(torch.float32)
        mu_hat = mu / (1 - torch.pow(b1, count_inc))
        denom = torch.sqrt(nu / (1 - torch.pow(b2, count_inc))).add_(group["eps"])
        update = st["update_flat"]
        torch.div(mu_hat, denom, out=update)
        if group["weight_decay"]:
            torch._foreach_add_(st["update"], self.params, alpha=group["weight_decay"])
        update.mul_(-lr)
        torch._foreach_add_(self.params, st["update"])
        count.add_(1 if apply is None else apply.to(torch.int64))


class Schedule:
    """The learning-rate schedule's view of the optimizer (the layout of a
    torch ``LambdaLR``): its step is AdamW's count."""

    def __init__(self, opt: "Optimizer"):
        self._opt = opt

    @property
    def last_epoch(self) -> int:
        return int(self._opt.count)

    def state_dict(self) -> Dict:
        lr = float(self._opt.lr_at(self._opt.count))
        step = self.last_epoch
        return {"base_lrs": [self._opt.cfg.lr], "last_epoch": step, "_step_count": step + 1,
                "_get_lr_called_within_step": False, "_last_lr": [lr], "lr_lambdas": [None]}


class Optimizer:
    """The JAX package's optimizer chain over named parameters.
    ``frozen_prefixes`` names top-level submodules (``"decoder"``) whose
    parameters are left out of the update; their gradients still share
    the flat gradient buffer (:meth:`zero_grad`), after the trainable
    ones. ``lr_at`` maps AdamW's count to the rate on the device
    (:func:`cosine_warm_restarts_lr`; the LR finder puts its sweep
    there)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 cfg: Optional[OptimConfig] = None, frozen_prefixes: Sequence[str] = ()):
        self.cfg = cfg = cfg or OptimConfig()
        self.frozen_prefixes = frozen = tuple(frozen_prefixes)
        named = [(name, p) for name, p in named_params if p.requires_grad]
        self.params = [p for name, p in named if name.split(".")[0] not in frozen]
        self.frozen_params = [p for name, p in named if name.split(".")[0] in frozen]
        self.adamw = AdamW(self.params, lr=cfg.lr, weight_decay=cfg.weight_decay)
        self.schedule = Schedule(self)
        self.lr_at = cosine_warm_restarts_lr(cfg)
        self._grad: Optional[torch.Tensor] = None
        self._grad_views: List[torch.Tensor] = []
        self._acc: Optional[torch.Tensor] = None
        self._micro: Optional[torch.Tensor] = None

    # -- the live state ---------------------------------------------------

    def _ensure(self) -> None:
        """Allocate the flat gradient, AdamW's state and the accumulator
        on the parameters' device (once)."""
        if self._grad is not None:
            return
        everything = self.params + self.frozen_params
        device = everything[0].device
        self._grad = torch.zeros(sum(p.numel() for p in everything), device=device)
        self._grad_views = _views(self._grad, everything)
        if self.params:
            self.adamw.buffers()
        if self.cfg.accumulate_steps > 1:
            self._acc = torch.zeros(sum(p.numel() for p in self.params), device=device)
            self._micro = torch.zeros((), dtype=torch.int64, device=device)

    @property
    def count(self) -> torch.Tensor:
        """AdamW's count of real updates: an int64 0-d device tensor."""
        self._ensure()
        return self.adamw.buffers()["count"]

    @property
    def micro(self) -> int:
        """Micro-steps in the accumulator (a host read)."""
        return 0 if self._micro is None else int(self._micro)

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor an update writes (AdamW's state, the accumulator,
        its counter): what a snapshot must copy to undo updates."""
        self._ensure()
        out = []
        if self.params:
            st = self.adamw.buffers()
            out += [st["count"], st["mu_flat"], st["nu_flat"]]
        if self._acc is not None:
            out += [self._acc, self._micro]
        return out

    @torch.no_grad()
    def zero_grad(self) -> None:
        """Zero the flat gradient, first making every parameter's ``.grad``
        its view again where something replaced it (the backward then
        accumulates into it in place)."""
        self._ensure()
        for p, view in zip(self.params + self.frozen_params, self._grad_views):
            if p.grad is None or p.grad.data_ptr() != view.data_ptr():
                p.grad = view
        self._grad.zero_()

    def grads(self) -> torch.Tensor:
        """The flat gradient of every parameter, trainable ones first.
        Where a parameter's ``.grad`` is not its view (set by hand, or
        None), it is copied in (None as zeros)."""
        self._ensure()
        with torch.no_grad():
            for p, view in zip(self.params + self.frozen_params, self._grad_views):
                if p.grad is None:
                    view.zero_()
                elif p.grad.data_ptr() != view.data_ptr():
                    view.copy_(p.grad)
        return self._grad

    # -- the update -------------------------------------------------------

    @torch.no_grad()
    def apply_update(self, finite: Optional[torch.Tensor] = None,
                     grads: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Apply one (micro-)step from the trainable part of ``grads`` (the
        flat gradient, default :meth:`grads`) without a host read.
        ``finite`` (bool 0-d) is the guard's flag: where false the
        gradients are replaced by zeros and nothing moves, the accumulator
        included. Returns a bool 0-d tensor: the parameters moved."""
        self._ensure()
        device = self._grad.device
        if not self.params:
            return torch.zeros((), dtype=torch.bool, device=device)
        flat = (self.grads() if grads is None else grads)[:self._acc_size()]
        ok = torch.ones((), dtype=torch.bool, device=device) if finite is None else finite
        g = flat if finite is None else torch.where(finite, flat, torch.zeros((), device=device))
        k = self.cfg.accumulate_steps
        if k > 1:
            acc, micro = self._acc, self._micro
            new_acc = acc + (g - acc) / (micro + 1).to(torch.float32)
            acc.copy_(torch.where(ok, new_acc, acc))
            new_micro = micro + ok.to(torch.int64)
            apply = new_micro == k
            g = acc
        else:
            apply = ok
        norm = torch.linalg.vector_norm(g)
        max_norm = self.cfg.grad_clip_norm
        g = torch.where(norm < max_norm, g, g / norm * max_norm)
        self.adamw.step(g, self.lr_at(self.count),
                        None if finite is None and k == 1 else apply)
        if k > 1:
            acc.copy_(torch.where(apply, torch.zeros((), device=device), acc))
            micro.copy_(torch.where(apply, torch.zeros_like(new_micro), new_micro))
        return apply

    def _acc_size(self) -> int:
        return sum(p.numel() for p in self.params)

    def update(self) -> bool:
        """Apply one (micro-)step from the parameters' ``.grad`` (None
        counts as zero). Returns True when the parameters moved (a host
        read: the eager API)."""
        return bool(self.apply_update())

    # -- checkpoints -------------------------------------------------------

    def state_dict(self) -> Dict:
        """AdamW (moments and count; an empty state before the first
        update), the schedule's step, the accumulator (None between
        updates) and its micro count, and the frozen prefixes the
        parameter list was cut by: the layout of a torch ``AdamW`` +
        ``LambdaLR`` pair. Tensors are the live ones; the counts are read
        to the host."""
        self._ensure()
        count = self.schedule.last_epoch
        group = {k: v for k, v in self.adamw.param_groups[0].items() if k != "params"}
        group.update(lr=float(self.lr_at(self.count)), initial_lr=self.cfg.lr,
                     params=list(range(len(self.params))))
        state = {}
        if count and self.params:
            st = self.adamw.buffers()
            state[0] = {"count": count, "mu": list(st["mu"]), "nu": list(st["nu"])}
        micro = self.micro
        return {"adamw": {"state": state, "param_groups": [group]},
                "schedule": self.schedule.state_dict(),
                "acc": None if not micro else _views(self._acc, self.params),
                "micro": micro, "frozen_prefixes": list(self.frozen_prefixes)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Restore :meth:`state_dict`'s output into the existing tensors.
        A state saved over another parameter list (another set of frozen
        prefixes) is refused."""
        if tuple(state["frozen_prefixes"]) != self.frozen_prefixes:
            raise ValueError(
                f"optimizer state was saved with frozen prefixes "
                f"{tuple(state['frozen_prefixes'])}, this optimizer has "
                f"{self.frozen_prefixes}: restore the model only (partial=True)")
        self._ensure()
        if self.params:
            st = self.adamw.buffers()
            saved = state["adamw"]["state"].get(0) or state["adamw"]["state"].get("0")
            if saved is None:  # saved before the first update
                st["count"].zero_()
                st["mu_flat"].zero_()
                st["nu_flat"].zero_()
            else:
                st["count"].fill_(int(saved["count"]))
                torch._foreach_copy_(st["mu"], [t.to(st["mu_flat"].device) for t in saved["mu"]])
                torch._foreach_copy_(st["nu"], [t.to(st["nu_flat"].device) for t in saved["nu"]])
        if self._acc is not None:
            acc = state["acc"]
            if acc is None:
                self._acc.zero_()
            else:
                torch._foreach_copy_(_views(self._acc, self.params),
                                     [a.to(self._acc.device) for a in acc])
            self._micro.fill_(int(state["micro"]))
