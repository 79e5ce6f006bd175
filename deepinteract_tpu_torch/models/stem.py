"""Interaction stem: the dilated decoder's entry 1x1 conv, with or without
the 2C pair tensor.

Port of ``PairFactors`` and ``PairStem1x1`` from
``deepinteract_tpu/models/stem.py``. The interaction tensor's value at
(i, j) is ``[f1_i | f2_j]``, so its 1x1 conv splits per chain:

    conv1x1([f1_i | f2_j]) = W1 @ f1_i + W2 @ f2_j + b,

two O(L*C^2) matmuls plus a broadcast add that materializes only the
``features`` output channels. The JAX conv kernel ``[1, 1, 2C, F]`` is
held here as its two halves (``weights.load_jax_variables`` splits it).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from deepinteract_tpu_torch.models.layers import Dense

STEM_CHOICES = ("factorized", "materialized")


def validate_stem(name: str) -> str:
    if name not in STEM_CHOICES:
        raise ValueError(f"unknown interaction stem {name!r}; expected one of "
                         f"{STEM_CHOICES}")
    return name


@dataclasses.dataclass
class PairFactors:
    """Per-chain factors of the interaction tensor: the encoded
    ``[B, L1, C]`` / ``[B, L2, C]`` chain features. (The pair mask travels
    beside them, as the decoder's ``mask`` argument.)"""

    feats1: torch.Tensor
    feats2: torch.Tensor


class PairStem1x1(nn.Module):
    """The decoder's entry 1x1 conv over ``[f1 | f2]`` pair features, from
    factors or from the materialized NHWC tensor. Returns NCHW
    ``[B, features, L1, L2]`` in the input dtype:

        out[b, :, i, j] = chain1(f1[b, i]) + chain2(f2[b, j])

    (``chain2`` carries the conv's bias)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        half = in_channels // 2
        self.chain1 = Dense(half, features, bias=False)
        self.chain2 = Dense(half, features)

    def forward(self, x) -> torch.Tensor:
        if isinstance(x, PairFactors):
            r1 = self.chain1(x.feats1)  # [B, L1, F]
            r2 = self.chain2(x.feats2)  # [B, L2, F]
            return r1.transpose(1, 2)[:, :, :, None] + r2.transpose(1, 2)[:, :, None, :]
        weight = torch.cat([self.chain1.weight, self.chain2.weight], dim=1).to(x.dtype)
        out = torch.nn.functional.linear(x, weight, self.chain2.bias.to(x.dtype))
        return out.permute(0, 3, 1, 2)
