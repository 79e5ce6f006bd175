"""Dilated squeeze-excitation ResNet interaction decoder.

Port of ``deepinteract_tpu/models/decoder.py`` in its plain masked
formulation: instance norms take their statistics over valid pixels only,
the padded region is zeroed before every dilated 3x3 and at every block
output, and the logits are masked. The JAX package's default de-padded
statistics compute the same statistics up to float association, and its
chunk scan and remat serve XLA's compiler; neither is needed here (the
scanned parameter layout is still accepted by ``weights.py``).

Convolutions run NCHW on cuDNN; the public boundary keeps the JAX layout
(NHWC logits ``[B, L1, L2, num_classes]``). The positive-class bias of the
final conv starts at -7, so positives start at p ~= 0.001. The optional
``RegionalAttention`` (off by default) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deepinteract_tpu_torch.models import policy
from deepinteract_tpu_torch.models.layers import Conv2d, Dense
from deepinteract_tpu_torch.models.policy import OUTPUT_DTYPE, STATS_DTYPE
from deepinteract_tpu_torch.models.stem import PairStem1x1

POSITIVE_CLASS_BIAS = -7.0


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Defaults mirror the reference (14 chunks of (1, 2, 4, 8))."""

    num_chunks: int = 14
    in_channels: int = 256  # 2 * GNN hidden
    num_channels: int = 128
    num_classes: int = 2
    dilation_cycle: Sequence[int] = (1, 2, 4, 8)
    compute_dtype: str = "float32"

    def __post_init__(self):
        policy.validate_compute_dtype(self.compute_dtype)

    @property
    def dtype(self) -> torch.dtype:
        return policy.compute_dtype(self.compute_dtype)


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
                 use_inorm: bool, extra_blocks: bool = False):
        super().__init__()
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
            x = getattr(self, name)(x, mask)
        return x


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
        self.base_resnet = DilatedResNet(ch, cfg.num_chunks, cfg.dilation_cycle, use_inorm=True)
        self.phase2_resnet = DilatedResNet(ch, 1, cfg.dilation_cycle, use_inorm=False,
                                           extra_blocks=True)
        self.phase2_conv = nn.Conv2d(ch, cfg.num_classes, 1)

    def forward(self, pair_input, mask):
        m = mask[:, None].to(self.cfg.dtype)  # [B, 1, L1, L2]
        x = self.conv2d_1(pair_input).to(self.cfg.dtype)
        x = F.elu(self.inorm_1(x, m))
        x = F.elu(self.base_resnet(x, m))
        x = F.elu(self.phase2_resnet(x, m))
        # Logits in float32 whatever the activation dtype.
        logits = self.phase2_conv(x.to(OUTPUT_DTYPE)) * m.to(OUTPUT_DTYPE)
        return logits.permute(0, 2, 3, 1)
