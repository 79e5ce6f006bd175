"""Non-finite step guard.

Port of ``step_is_finite``, ``apply_guarded_update``, ``summarize_batch``
and ``dump_diagnostics`` from ``deepinteract_tpu/robustness/guards.py``.
One NaN loss or gradient would poison every parameter at the next
optimizer update; the guard skips that update instead and counts
consecutive skips, and the trainer aborts with
:class:`NonFiniteTrainingError` once the count reaches its limit, after
writing a diagnostics JSON (:func:`dump_diagnostics`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Sequence

import torch

from deepinteract_tpu_torch.training.optim import global_norm


class NonFiniteTrainingError(RuntimeError):
    """Raised by the trainer after ``max_bad_steps`` consecutive skipped
    (non-finite) optimizer steps; ``diagnostics_path`` is the dump it
    wrote, if any."""

    def __init__(self, msg: str, diagnostics_path: Optional[str] = None):
        super().__init__(msg)
        self.diagnostics_path = diagnostics_path


def step_is_finite(loss: torch.Tensor, grads: Sequence[torch.Tensor]) -> bool:
    """True iff ``loss`` and every gradient entry are finite (a NaN or inf
    anywhere makes the global norm non-finite)."""
    return bool(torch.isfinite(loss) & torch.isfinite(global_norm(grads)))


def apply_guarded_update(state, loss: torch.Tensor, grads: Sequence[torch.Tensor],
                         buffers_before: Dict[str, torch.Tensor]) -> bool:
    """Apply the optimizer update only when the step is finite; returns
    whether it was. A bad step leaves the parameters, the optimizer, the
    step counter and the batch statistics (restored from
    ``buffers_before``: a NaN batch may have poisoned them in the forward)
    as they were, and adds one to ``state.bad_steps``; a good step resets
    it to 0."""
    finite = step_is_finite(loss, grads)
    if finite:
        state.optimizer.update()
        state.step += 1
        state.bad_steps = 0
    else:
        with torch.no_grad():
            for name, buf in state.model.named_buffers():
                buf.copy_(buffers_before[name])
        state.bad_steps += 1
    return finite


def summarize_batch(batch) -> Dict[str, Any]:
    """Per-tensor summary of a batch (a dataclass of tensors, nested) for
    the diagnostics dump: path, shape and dtype, NaN and inf counts of
    float tensors, the sum of integer ones. Enough to identify a poisoned
    complex without shipping the arrays."""
    leaves = []

    def walk(value, path):
        if isinstance(value, torch.Tensor):
            t = value.detach().cpu()
            info: Dict[str, Any] = {"path": path, "shape": list(t.shape),
                                    "dtype": str(t.dtype).replace("torch.", "")}
            if t.is_floating_point():
                info["nan_count"] = int(torch.isnan(t).sum())
                info["inf_count"] = int(torch.isinf(t).sum())
            elif t.dtype != torch.bool:
                info["sum"] = int(t.sum())
            leaves.append(info)
        elif dataclasses.is_dataclass(value):
            for f in dataclasses.fields(value):
                walk(getattr(value, f.name), f"{path}.{f.name}")

    walk(batch, "batch")
    return {"leaves": leaves}


def dump_diagnostics(directory: str, payload: Dict[str, Any]) -> str:
    """Write an abort-diagnostics JSON (atomic tmp + rename) and return its
    path. Non-finite floats survive the round trip (json's Infinity and
    NaN literals): they are the point of the dump."""
    from deepinteract_tpu_torch.robustness import artifacts

    os.makedirs(directory or ".", exist_ok=True)
    path = os.path.join(directory or ".",
                        f"nonfinite_abort_epoch{payload.get('epoch', 'x')}"
                        f"_step{payload.get('step', 'x')}.json")
    artifacts.atomic_write(path, json.dumps(payload, indent=2, default=str))
    return path
