"""Non-finite step guard.

Port of ``step_is_finite``, ``apply_guarded_update``, ``summarize_batch``
and ``dump_diagnostics`` from ``deepinteract_tpu/robustness/guards.py``.
One NaN loss or gradient would poison every parameter at the next
optimizer update; the guard skips that update instead and counts
consecutive skips, and the trainer aborts with
:class:`NonFiniteTrainingError` once the count reaches its limit, after
writing a diagnostics JSON (:func:`dump_diagnostics`). The decision and
the counters stay on the device (``torch.where`` in place of the JAX
package's ``lax.cond``), so a guarded step can be captured in a CUDA
graph; the trainer reads the counter with the step's other metrics.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Sequence

import torch



class NonFiniteTrainingError(RuntimeError):
    """Raised by the trainer after ``max_bad_steps`` consecutive skipped
    (non-finite) optimizer steps; ``diagnostics_path`` is the dump it
    wrote, if any."""

    def __init__(self, msg: str, diagnostics_path: Optional[str] = None):
        super().__init__(msg)
        self.diagnostics_path = diagnostics_path


def step_is_finite(loss: torch.Tensor, grad_norm: torch.Tensor) -> torch.Tensor:
    """A bool 0-d tensor on the loss's device, true iff ``loss`` and the
    global gradient norm are finite (a NaN or inf in any gradient makes
    the norm non-finite). No host read."""
    return torch.isfinite(loss) & torch.isfinite(grad_norm)


@torch.no_grad()
def apply_guarded_update(state, loss: torch.Tensor, grad_norm: torch.Tensor,
                         buffers: Sequence[torch.Tensor],
                         buffers_before: Sequence[torch.Tensor]) -> torch.Tensor:
    """Apply the optimizer update only where the step is finite, on the
    device: returns the flag (bool 0-d). A bad step leaves the parameters,
    the optimizer, the step counter and the batch statistics (``buffers``,
    restored from the static copies ``buffers_before``: a NaN batch may
    have poisoned them in the forward) as they were, and adds one to
    ``state.bad_steps_t``; a good step resets it to 0. Every choice is a
    ``torch.where`` on the flag: nothing is read on the host."""
    finite = step_is_finite(loss, grad_norm)
    state.optimizer.apply_update(finite)
    state.step_t.add_(finite.to(torch.int64))
    state.bad_steps_t.copy_(torch.where(finite, torch.zeros_like(state.bad_steps_t),
                                        state.bad_steps_t + 1))
    for buf, before in zip(buffers, buffers_before):
        buf.copy_(torch.where(finite, buf, before))
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
