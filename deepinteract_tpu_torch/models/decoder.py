"""Dilated squeeze-excitation ResNet interaction decoder.

Port of ``deepinteract_tpu/models/decoder.py`` in its plain masked
formulation: instance norms take their statistics over valid pixels only,
the padded region is zeroed before every dilated 3x3 and at every block
output, and the logits are masked. The JAX package's default de-padded
statistics compute the same statistics up to float association, and its
chunk scan serves XLA's compiler; neither is needed here (the scanned
parameter layout is still accepted by ``weights.py``).

With ``remat`` every bottleneck block is rematerialized in the backward
(:func:`remat_call`, the JAX package's ``nn.remat`` per block): under
``remat_policy='full'`` a block keeps only its input and recomputes the
rest; under ``'convs'`` it keeps its conv outputs too and recomputes the
elementwise chain. Blocks hold no dropout and no running statistic, so a
recomputation draws nothing and updates nothing. Remat applies only with
grad enabled; eval and predict run as without it.

Convolutions run NCHW on cuDNN; the public boundary keeps the JAX layout
(NHWC logits ``[B, L1, L2, num_classes]``). The positive-class bias of the
final conv starts at -7, so positives start at p ~= 0.001. With
``use_attention`` a :class:`RegionalAttention` follows each ResNet stage
(``mha2d_1``, ``mha2d_2``), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from deepinteract_tpu_torch.models import policy
from deepinteract_tpu_torch.models.layers import Conv2d, Dense, Dropout
from deepinteract_tpu_torch.models.policy import OUTPUT_DTYPE, STATS_DTYPE
from deepinteract_tpu_torch.models.stem import PairStem1x1

POSITIVE_CLASS_BIAS = -7.0
REMAT_POLICIES = ("full", "convs")


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Defaults mirror the reference (14 chunks of (1, 2, 4, 8))."""

    num_chunks: int = 14
    in_channels: int = 256  # 2 * GNN hidden
    num_channels: int = 128
    num_classes: int = 2
    dilation_cycle: Sequence[int] = (1, 2, 4, 8)
    use_attention: bool = False
    num_attention_heads: int = 4
    dropout_rate: float = 0.2  # on the regional attention weights
    region_size: int = 3
    # Rematerialize each bottleneck block in the backward (remat_call).
    remat: bool = False
    remat_policy: str = "full"  # 'full' | 'convs'
    compute_dtype: str = "float32"

    def __post_init__(self):
        policy.validate_compute_dtype(self.compute_dtype)
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}; "
                             f"expected one of {REMAT_POLICIES}")

    @property
    def dtype(self) -> torch.dtype:
        return policy.compute_dtype(self.compute_dtype)


def _save_convs(ctx, op, *args, **kwargs):
    """The 'convs' policy: keep every convolution's output, recompute the
    rest."""
    if op == torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(module: nn.Module, remat_policy: str, *args):
    """``module(*args)`` rematerialized in the backward when grad is
    enabled (``torch.utils.checkpoint``, non-reentrant): 'full' keeps only
    the inputs, 'convs' also the conv outputs. Without grad, a plain
    call. No block draws from torch's generators (dropout hashes its
    masks from a key, ``layers.DropoutKey``), so the generators' states
    are not saved: reading the card's would fail inside a CUDA graph
    capture."""
    if not torch.is_grad_enabled():
        return module(*args)
    if remat_policy == "convs":
        return checkpoint(module, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                       _save_convs))
    return checkpoint(module, *args, use_reentrant=False, preserve_rng_state=False)


def masked_instance_norm(x, mask, weight, bias, eps: float = 1e-6):
    """InstanceNorm2d over valid pixels per sample and channel.

    x: [B, C, H, W]; mask: [B, 1, H, W] float (1 = valid). Statistics are
    float32 (two-pass variance); the output is masked and cast back to
    x's dtype."""
    xf = x.to(STATS_DTYPE)
    m = mask.to(STATS_DTYPE)
    count = torch.clamp(m.sum(dim=(2, 3), keepdim=True), min=1.0)
    mean = (xf * m).sum(dim=(2, 3), keepdim=True) / count
    var = ((xf - mean) ** 2 * m).sum(dim=(2, 3), keepdim=True) / count
    y = (xf - mean) * torch.rsqrt(var + eps) * weight[:, None, None] + bias[:, None, None]
    return (y * m).to(x.dtype)


class InstanceNorm(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, mask):
        return masked_instance_norm(x, mask, self.weight, self.bias)


class SEBlock(nn.Module):
    """Squeeze-and-excitation over the masked spatial mean. Note the relu
    *before* the sigmoid, as in the reference."""

    # flax auto-names its two unnamed Dense children.
    flax_names = {"Dense_0": "squeeze", "Dense_1": "excite"}

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        self.squeeze = Dense(channels, max(1, channels // ratio))
        self.excite = Dense(max(1, channels // ratio), channels)

    def forward(self, x, mask):
        m = mask.to(STATS_DTYPE)
        pooled = (x.to(STATS_DTYPE) * m).sum(dim=(2, 3)) / torch.clamp(m.sum(dim=(2, 3)), min=1.0)
        h = F.relu(self.excite(F.relu(self.squeeze(pooled.to(x.dtype)))))
        return x * torch.sigmoid(h)[:, :, None, None]


class BottleneckBlock(nn.Module):
    """One dilated bottleneck unit: [inorm] - elu - 1x1 down - [inorm] - elu
    - mask - 3x3 dilated - [inorm] - elu - 1x1 up - SE - residual - mask."""

    def __init__(self, channels: int, dilation: int, use_inorm: bool):
        super().__init__()
        half = channels // 2
        self.use_inorm = use_inorm
        if use_inorm:
            self.inorm_1 = InstanceNorm(channels)
            self.inorm_2 = InstanceNorm(half)
            self.inorm_3 = InstanceNorm(half)
        self.conv2d_1 = Conv2d(channels, half, 1)
        self.conv2d_2 = Conv2d(half, half, 3, padding=dilation, dilation=dilation)
        self.conv2d_3 = Conv2d(half, channels, 1)
        self.se_block = SEBlock(channels)

    def forward(self, x, mask):
        residual = x
        if self.use_inorm:
            x = self.inorm_1(x, mask)
        x = self.conv2d_1(F.elu(x))
        if self.use_inorm:
            x = self.inorm_2(x, mask)
        # Zero the padded region before the only spatially-mixing conv, so
        # padded buckets match the reference's zero-boundary conv exactly.
        x = self.conv2d_2(F.elu(x) * mask.to(x.dtype))
        if self.use_inorm:
            x = self.inorm_3(x, mask)
        x = self.se_block(self.conv2d_3(F.elu(x)), mask)
        return (x + residual) * mask.to(x.dtype)


class DilatedResNet(nn.Module):
    """An initial 1x1 projection, then num_chunks x dilation_cycle
    bottleneck blocks (+2 optional extra blocks). Blocks are named as the
    JAX package's unrolled tree: ``block_{chunk}_{dilation}``,
    ``extra_block_{i}``."""

    def __init__(self, channels: int, num_chunks: int, dilation_cycle: Sequence[int],
                 use_inorm: bool, extra_blocks: bool = False, remat: bool = False,
                 remat_policy: str = "full"):
        super().__init__()
        self.remat, self.remat_policy = remat, remat_policy
        self.init_proj = Conv2d(channels, channels, 1)
        self.blocks = []
        for i in range(num_chunks):
            for d in dilation_cycle:
                self.blocks.append((f"block_{i}_{d}", d))
        if extra_blocks:
            self.blocks += [(f"extra_block_{i}", 1) for i in range(2)]
        for name, d in self.blocks:
            self.add_module(name, BottleneckBlock(channels, d, use_inorm))

    def forward(self, x, mask):
        x = self.init_proj(x)
        for name, _ in self.blocks:
            block = getattr(self, name)
            x = remat_call(block, self.remat_policy, x, mask) if self.remat else block(x, mask)
        return x


class RegionalAttention(nn.Module):
    """Multi-head attention over a region_size x region_size window around
    each pixel (the reference's MultiHeadRegionalAttention), the window
    built from shifted pads: q, k, v are bias-free 1x1 convs, a head's
    score sums its d_k / heads channels of q * k, the softmax over the s^2
    window runs in float32 with scale 1/sqrt(d_k), dropout hits the
    attention weights, and input and output are masked (window slots in
    the pad then act like the reference's zero boundary)."""

    def __init__(self, channels: int, d_k: int = 16, num_heads: int = 4,
                 region_size: int = 3, dropout_rate: float = 0.1):
        super().__init__()
        self.d_k, self.num_heads, self.region_size = d_k, num_heads, region_size
        self.q_layer = Conv2d(channels, d_k, 1, bias=False)
        self.k_layer = Conv2d(channels, d_k, 1, bias=False)
        self.v_layer = Conv2d(channels, channels, 1, bias=False)
        self.dropout = Dropout(dropout_rate)

    def _patches(self, t):
        """[B, C, H, W] -> [B, C, s*s, H, W], window offsets row-major."""
        s, pad = self.region_size, self.region_size // 2
        h, w = t.shape[2:]
        tp = F.pad(t, (pad, pad, pad, pad))
        return torch.stack([tp[:, :, dy:dy + h, dx:dx + w]
                            for dy in range(s) for dx in range(s)], dim=2)

    def forward(self, x, mask):
        b, c, h, w = x.shape
        n, s2 = self.num_heads, self.region_size ** 2
        x = x * mask.to(x.dtype)
        qk = self._patches(self.q_layer(x)) * self._patches(self.k_layer(x))
        qk = qk.reshape(b, n, self.d_k // n, s2, h, w).sum(2)  # [B, heads, s2, H, W]
        att = torch.softmax(qk.to(STATS_DTYPE) / self.d_k ** 0.5, dim=2).to(qk.dtype)
        att = self.dropout(att)
        v = self._patches(self.v_layer(x)).reshape(b, n, c // n, s2, h, w)
        out = (att[:, :, None] * v).sum(3).reshape(b, c, h, w)
        return out * mask.to(out.dtype)


class InteractionDecoder(nn.Module):
    """Full decoder head: entry 1x1 conv + inorm -> base dilated ResNet
    (inorm) -> phase-2 ResNet (+extra blocks) -> 1x1 conv to classes.

    ``pair_input`` is a :class:`~deepinteract_tpu_torch.models.stem.
    PairFactors` bundle or the materialized ``[B, L1, L2, 2C]`` tensor;
    ``mask`` the ``[B, L1, L2]`` pair mask. Returns float32 logits
    ``[B, L1, L2, num_classes]``, zero at padded pairs."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.num_channels
        self.conv2d_1 = PairStem1x1(cfg.in_channels, ch)
        self.inorm_1 = InstanceNorm(ch)
        remat = dict(remat=cfg.remat, remat_policy=cfg.remat_policy)
        self.base_resnet = DilatedResNet(ch, cfg.num_chunks, cfg.dilation_cycle, use_inorm=True,
                                         **remat)
        self.phase2_resnet = DilatedResNet(ch, 1, cfg.dilation_cycle, use_inorm=False,
                                           extra_blocks=True, **remat)
        if cfg.use_attention:
            for name in ("mha2d_1", "mha2d_2"):
                self.add_module(name, RegionalAttention(
                    ch, num_heads=cfg.num_attention_heads, region_size=cfg.region_size,
                    dropout_rate=cfg.dropout_rate))
        self.phase2_conv = nn.Conv2d(ch, cfg.num_classes, 1)

    def forward(self, pair_input, mask):
        m = mask[:, None].to(self.cfg.dtype)  # [B, 1, L1, L2]
        x = self.conv2d_1(pair_input).to(self.cfg.dtype)
        x = F.elu(self.inorm_1(x, m))
        x = F.elu(self.base_resnet(x, m))
        if self.cfg.use_attention:
            x = F.elu(self.mha2d_1(x, m))
        x = F.elu(self.phase2_resnet(x, m))
        if self.cfg.use_attention:
            x = F.elu(self.mha2d_2(x, m))
        # Logits in float32 whatever the activation dtype.
        logits = self.phase2_conv(x.to(OUTPUT_DTYPE)) * m.to(OUTPUT_DTYPE)
        return logits.permute(0, 2, 3, 1)
