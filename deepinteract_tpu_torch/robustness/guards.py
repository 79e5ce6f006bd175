"""Non-finite step guard.

Port of ``step_is_finite`` and ``apply_guarded_update`` from
``deepinteract_tpu/robustness/guards.py``. One NaN loss or gradient would
poison every parameter at the next optimizer update; the guard skips that
update instead and counts consecutive skips, and the trainer aborts with
:class:`NonFiniteTrainingError` once the count reaches its limit.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from deepinteract_tpu_torch.training.optim import global_norm


class NonFiniteTrainingError(RuntimeError):
    """Raised by the trainer after ``max_bad_steps`` consecutive skipped
    (non-finite) optimizer steps."""


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
