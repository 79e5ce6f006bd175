"""Shared building blocks: dense layers, masked normalization, residual blocks.

Port of ``deepinteract_tpu/models/layers.py``. Graphs are padded, so batch
statistics are taken over valid elements only (masked BatchNorm); LayerNorm
is positionwise and needs no mask. Module attribute names follow the flax
module names so that ``weights.load_jax_variables`` can carry a JAX
parameter tree across by path.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepinteract_tpu_torch.models.policy import STATS_DTYPE


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Dense(nn.Linear):
    """flax ``Dense`` as an ``nn.Linear`` whose float32 parameters are cast
    to the input's dtype, the policy's compute dtype (a no-op under
    float32). Seeded init: lecun normal
    (:func:`deepinteract_tpu_torch.weights.init_weights`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class GODense(Dense):
    """``GODense``: a :class:`Dense` whose seeded init is glorot
    orthogonal, as the reference's."""


class Conv2d(nn.Conv2d):
    """flax ``Conv`` (NCHW here) with its float32 parameters cast to the
    input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid elements of any number of leading axes,
    in float32 whatever the input dtype (eps 1e-5); padded rows come out
    as zero.

    Eval mode normalizes with the running statistics, as torch
    ``BatchNorm1d`` in eval mode over the flattened list of real
    nodes/edges. Train mode reproduces the JAX package's
    ``MaskedBatchNorm`` exactly, including a count that differs from
    ``BatchNorm1d``'s: the mask is broadcast over channels before it is
    summed, so ``count = n_valid * C`` divides the per-channel sums.
    Gradients flow through the batch statistics. The running statistics
    move with momentum 0.1, the variance unbiased by count / (count - 1),
    outside the autograd graph."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        xf = x.to(STATS_DTYPE)
        m = mask[..., None].to(STATS_DTYPE)
        if self.training:
            axes = tuple(range(x.dim() - 1))
            count = torch.clamp(m.sum() * x.shape[-1], min=1.0)  # n_valid * C
            mean = (xf * m).sum(axes) / count
            var = (m * (xf - mean) ** 2).sum(axes) / count
            with torch.no_grad():
                mom = self.momentum
                unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
                self.running_mean.copy_((1 - mom) * self.running_mean + mom * mean)
                self.running_var.copy_((1 - mom) * self.running_var + mom * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        # Zero padded slots: downstream code may read intermediate
        # features without re-masking.
        return (y * m).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm``: eps 1e-6 (torch's default is 1e-5), statistics
    in float32, output in the input dtype. Takes and ignores a mask so it
    can stand wherever :class:`MaskedBatchNorm` does."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-6)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        y = F.layer_norm(x.to(STATS_DTYPE), self.normalized_shape,
                         self.weight, self.bias, self.eps)
        return y.to(x.dtype)


def FeatureNorm(norm_type: str, channels: int) -> nn.Module:
    """'batch' or 'layer' normalization switch (reference
    ``norm_to_apply``)."""
    if norm_type == "layer":
        return LayerNorm(channels)
    if norm_type == "batch":
        return MaskedBatchNorm(channels)
    raise ValueError(f"unknown norm_type {norm_type!r}")


class ResBlock(nn.Module):
    """Conformation-module residual block: x + (Linear-Norm-SiLU) x3, with
    the *same* norm instance reused at all three positions (a reference
    quirk: one ``norm_layer`` object appears three times in its ModuleList,
    sharing parameters and running statistics)."""

    def __init__(self, hidden: int, norm_type: str = "batch"):
        super().__init__()
        self.linear_0 = GODense(hidden, hidden)
        self.linear_1 = GODense(hidden, hidden)
        self.linear_2 = GODense(hidden, hidden)
        self.shared_norm = FeatureNorm(norm_type, hidden)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = x
        for linear in (self.linear_0, self.linear_1, self.linear_2):
            h = F.silu(self.shared_norm(linear(h), mask))
        return x + h


_M32 = 0xFFFFFFFF
# Odd multipliers below 2**31: a product with a 32-bit value stays inside
# int64, so the hash is exact on every device.
_MUL = (0x7FEB352D, 0x2C1B3C6D, 0x297A2D39)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash of int64 tensors holding values in
    [0, 2**32): xor-shift / multiply rounds, every product masked back to
    32 bits."""
    x = x ^ (x >> 16)
    x = (x * _MUL[0]) & _M32
    x = x ^ (x >> 15)
    x = (x * _MUL[1]) & _M32
    return x ^ (x >> 16)


class DropoutKey:
    """The dropout key of one train step: the run's seed and the step
    counter, both int64 tensors on the device (``TrainState.seed_t`` /
    ``step_t``), and a stream (0, or a tile's fork). A mask is a
    counter-based hash of (seed, step, stream, the module's index, the
    element's index), computed on the device by torch ops: no generator
    state, no host read, the same masks eager and inside a CUDA graph, and
    the same masks again when a step is recomputed (remat) or retried
    after a skip (a skipped step leaves ``step`` where it was, as the JAX
    package's ``fold_in(dropout_rng, state.step)`` does)."""

    def __init__(self, seed: torch.Tensor, step: torch.Tensor, stream: int = 0):
        self.seed, self.step, self.stream = seed, step, stream
        self.count = 1  # Dropout modules under this key (dropout_rng sets it)
        self._multipliers: Optional[torch.Tensor] = None

    def fork(self, index: int) -> "DropoutKey":
        """Stream ``index`` of this key (a tile's own masks)."""
        key = DropoutKey(self.seed, self.step, (self.stream * 0x9E3779B1 + index + 1) & _M32)
        key.count = self.count
        return key

    def multiplier(self, index: int) -> torch.Tensor:
        """Module ``index``'s odd 31-bit multiplier, a 0-d int64 tensor; all
        ``count`` of them are hashed at the first call of a forward."""
        if self._multipliers is None:
            seed = self.seed.to(torch.int64)
            base = _mix32(_mix32(((seed ^ (seed >> 32)) & _M32) ^ 0x5BD1E995)
                          ^ (self.step.to(torch.int64) & _M32))
            idx = torch.arange(self.count, dtype=torch.int64, device=base.device)
            mods = _mix32(((idx * _MUL[2]) & _M32) ^ self.stream)
            self._multipliers = (_mix32(mods ^ base) & 0x7FFFFFFF) | 1
        return self._multipliers[index]

    def keep(self, index: int, shape, keep_prob: float, device) -> torch.Tensor:
        """The keep mask (uniform < keep_prob) of module ``index`` for a
        tensor of ``shape``: bool, on ``device``."""
        numel = math.prod(shape)
        if numel >= 2 ** 32:
            raise ValueError(f"dropout over {numel} elements: the hash counts below 2**32")
        idx = torch.arange(1, numel + 1, dtype=torch.int64, device=device)
        h = _mix32((idx * self.multiplier(index)) & _M32)
        return (h < int(keep_prob * 2 ** 32)).reshape(shape)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode keep each element with
    probability 1 - p and scale kept ones by 1 / (1 - p); identity in eval
    mode or at p = 0. The mask comes from the module's ``key`` (a
    :class:`DropoutKey`, set by :func:`dropout_rng`) and its ``index``
    among the model's dropouts, never from torch's global generator; a
    train-mode call without a key raises."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.key: Optional[DropoutKey] = None
        self.index = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.key is None:
            raise RuntimeError("train-mode dropout draws from an explicit key: "
                               "run the forward under layers.dropout_rng(model, key)")
        keep_prob = 1.0 - self.p
        keep = self.key.keep(self.index, x.shape, keep_prob, x.device)
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


@contextlib.contextmanager
def dropout_rng(model: nn.Module, key: DropoutKey):
    """Inside the block, every :class:`Dropout` of ``model`` (numbered in
    module order) draws its train-mode masks from ``key``: the counterpart
    of flax's ``rngs={"dropout": key}``."""
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    key.count = max(1, len(drops))
    for i, d in enumerate(drops):
        d.key, d.index = key, i
    try:
        yield key
    finally:
        for d in drops:
            d.key = None


class MLP(nn.Module):
    """Transformer FFN: Dense(2C, no bias) - SiLU - Dropout - Dense(C, no
    bias)."""

    # flax auto-names its two unnamed GODense children.
    flax_names = {"GODense_0": "fc1", "GODense_1": "fc2"}

    def __init__(self, hidden: int, dropout_rate: float = 0.1):
        super().__init__()
        self.fc1 = GODense(hidden, 2 * hidden, bias=False)
        self.fc2 = GODense(2 * hidden, hidden, bias=False)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.dropout(F.silu(self.fc1(x))))
