"""The model-wide dtype policy: the one place the port's models name a dtype.

Port of ``deepinteract_tpu/models/policy.py``. Parameters live in float32;
matmuls, convolutions and elementwise activations run in the compute dtype
(float32 or bfloat16); normalization statistics, softmax accumulators and
the logits stay float32 whatever the compute dtype.
"""

from __future__ import annotations

import torch

# STATS_DTYPE is for accumulation-sensitive reductions (norm moments,
# softmax exp/sums, pooled means); OUTPUT_DTYPE for outward-facing tensors
# (logits, probabilities). Same dtype today, different reasons.
STATS_DTYPE = torch.float32
OUTPUT_DTYPE = torch.float32

_COMPUTE_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def compute_dtype(name: str) -> torch.dtype:
    """'float32' | 'bfloat16' -> torch dtype (the activation/matmul dtype)."""
    try:
        return _COMPUTE_DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown compute dtype {name!r}; expected one of "
            f"{sorted(_COMPUTE_DTYPES)}") from None


def validate_compute_dtype(name: str) -> str:
    """Raise early (config construction time) on an unknown dtype name."""
    compute_dtype(name)
    return name


def set_backend_precision(name: str) -> None:
    """Pin the CUDA backends to the policy's precision.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits and breaks the 1e-4 logit parity with the JAX
    reference. Under the float32 policy both TF32 switches are turned off
    (the matmul one is off by default; it is set explicitly so a caller's
    earlier change cannot leak in). Under bfloat16 the convolutions and
    matmuls run in bf16 anyway and the switches are left as they are."""
    if compute_dtype(name) == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

