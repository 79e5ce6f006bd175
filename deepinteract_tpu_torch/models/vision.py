"""DeepLabV3+ interaction decoder, the reference's alternative 2D decoder.

Port of ``deepinteract_tpu/models/vision.py``: a ResNet encoder (basic or
bottleneck blocks, the last stage or two dilated for output stride 16 or
8), ASPP with separable atrous convs and a masked global pooling, the x4
(os 16) or x2 (os 8) upsample fused with a 1x1-projected 1/4-scale skip,
and a float32 1x1 head upsampled back to the input size.

The pair map is padded to shape buckets, so every norm is the masked
instance norm of ``models/decoder.py`` over valid pixels, the mask is
max-pooled beside each downsampling, and upsampling is mask-renormalized
bilinear (:func:`_masked_resize`): padded buckets reproduce unpadded
outputs. Convolutions run NCHW on cuDNN with the JAX package's 'SAME'
padding (``stem.SameConv2d``); the public boundary keeps the JAX layout
(NHWC logits ``[B, H, W, num_classes]``). Children carry readable names
and map the flax auto-names (``ConvNormAct_0``, ``SeparableConv_3``,
``Conv_0``, ...) through ``flax_names`` for ``weights.load_jax_variables``.
With ``remat`` each ResNet block is rematerialized in the backward
(``decoder.remat_call``, policy 'full'), as the JAX package's ``nn.remat``.

Bilinear resizes are two products with interpolation matrices, one along
each axis (:func:`resize_matrix`, ``jax.image.resize``'s weights): their
backward is two more products, deterministic on the card, where the CUDA
backward of ``F.interpolate`` is not.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepinteract_tpu_torch.models import policy
from deepinteract_tpu_torch.models.decoder import InstanceNorm, remat_call
from deepinteract_tpu_torch.models.layers import Conv2d, Dropout
from deepinteract_tpu_torch.models.policy import OUTPUT_DTYPE, STATS_DTYPE
from deepinteract_tpu_torch.models.stem import (DeepLabStemConv, PairFactors, SameConv2d,
                                                same_pad)

# encoder_name -> (block kind, stage_blocks, stage_channels)
ENCODER_ZOO = {
    "resnet18": ("basic", (2, 2, 2, 2), (64, 128, 256, 512)),
    "resnet34": ("basic", (3, 4, 6, 3), (64, 128, 256, 512)),
    "resnet50": ("bottleneck", (3, 4, 6, 3), (256, 512, 1024, 2048)),
    "resnet101": ("bottleneck", (3, 4, 23, 3), (256, 512, 1024, 2048)),
    "resnet152": ("bottleneck", (3, 8, 36, 3), (256, 512, 1024, 2048)),
}

# (stride, dilation) per stage. os 16 dilates the last stage; os 8 runs the
# last two at stride 1 with dilations 2 and 4.
_PLAN16 = ((1, 1), (2, 1), (2, 1), (1, 2))
_PLAN8 = ((1, 1), (2, 1), (1, 2), (1, 4))


@dataclasses.dataclass(frozen=True)
class DeepLabConfig:
    """Defaults mirror the reference assembly: resnet34 encoder, output
    stride 16, ASPP rates (12, 24, 36), 256 decoder channels, 2 classes.
    ``stage_channels`` / ``stage_blocks`` left None derive from
    ``encoder_name``; explicit values win."""

    in_channels: int = 256  # 2 * GNN hidden
    num_classes: int = 2
    encoder_name: str = "resnet34"
    stem_channels: int = 64
    stage_channels: Optional[Sequence[int]] = None
    stage_blocks: Optional[Sequence[int]] = None
    aspp_rates: Sequence[int] = (12, 24, 36)
    decoder_channels: int = 256
    high_res_channels: int = 48
    output_stride: int = 16
    dropout_rate: float = 0.2
    # Rematerialize each ResNet block in the backward.
    remat: bool = False
    compute_dtype: str = "float32"

    def __post_init__(self):
        policy.validate_compute_dtype(self.compute_dtype)
        if self.output_stride not in (8, 16):
            raise ValueError("DeepLabConfig.output_stride must be 8 or 16")
        if self.encoder_name not in ENCODER_ZOO:
            raise ValueError(f"unknown encoder {self.encoder_name!r}; "
                             f"choose from {sorted(ENCODER_ZOO)}")
        _, zoo_blocks, zoo_channels = ENCODER_ZOO[self.encoder_name]
        if self.stage_blocks is None:
            object.__setattr__(self, "stage_blocks", zoo_blocks)
        if self.stage_channels is None:
            object.__setattr__(self, "stage_channels", zoo_channels)

    @property
    def dtype(self) -> torch.dtype:
        return policy.compute_dtype(self.compute_dtype)


def _pool_mask(mask: torch.Tensor, factor: int) -> torch.Tensor:
    """Downsample a [B, 1, H, W] validity mask by a VALID max pool of
    stride ``factor``: a coarse cell is valid if any covered cell is."""
    return mask if factor == 1 else F.max_pool2d(mask, factor, factor)


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 'SAME' max pool; flax pads with -inf, at lo = total // 2."""
    lo_h, hi_h, _ = same_pad(x.shape[2], 3, 2)
    lo_w, hi_w, _ = same_pad(x.shape[3], 3, 2)
    return F.max_pool2d(F.pad(x, (lo_w, hi_w, lo_h, hi_h), value=float("-inf")), 3, 2)


@functools.lru_cache(maxsize=64)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] float64 weights of ``jax.image.resize(...,
    "bilinear")`` along one axis (``jax._src.image.scale``'s
    ``compute_weight_mat`` at scale out/in, no translation): a triangle
    kernel at the half-pixel sample points, widened by in/out when
    shrinking (antialiasing), each row normalized to sum 1, and zero for
    sample points outside the input."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[:, None] - np.arange(in_size)[None, :]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - x)
    total = weights.sum(axis=1, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], weights, 0.0)


def bilinear_resize(x: torch.Tensor, hw) -> torch.Tensor:
    """``jax.image.resize(x, ..., "bilinear")`` of x [B, C, h, w] to
    [B, C, H, W]: a product along W, then one along H."""
    h, w = x.shape[2:]
    mh, mw = (torch.as_tensor(resize_matrix(int(n), int(m)), dtype=x.dtype, device=x.device)
              for n, m in ((h, hw[0]), (w, hw[1])))
    return torch.matmul(mh, torch.matmul(x, mw.t()))


def _masked_resize(y: torch.Tensor, mask: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear upsample that ignores padded cells: resize the masked
    values and the mask, then renormalize by the resized mask (zero where
    no valid support). y: [B, C, h, w]; mask: [B, 1, h, w]."""
    m = mask.to(y.dtype)
    num = bilinear_resize(y * m, hw)
    den = bilinear_resize(m, hw)
    return torch.where(den > 1e-6, num / den.clamp(min=1e-6), torch.zeros((), dtype=y.dtype,
                                                                            device=y.device))


class ConvNormAct(nn.Module):
    """Bias-free 'SAME' conv + masked instance norm (+ relu)."""

    flax_names = {"Conv_0": "conv", "InstanceNorm_0": "norm"}

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, use_act: bool = True):
        super().__init__()
        self.conv = SameConv2d(in_channels, features, kernel, stride=stride,
                               dilation=dilation, bias=False)
        self.norm = InstanceNorm(features)
        self.use_act = use_act

    def forward(self, x, mask):
        x = self.norm(self.conv(x), mask)
        return F.relu(x) if self.use_act else x


class StemConvNorm(ConvNormAct):
    """The encoder's 7x7/2 stem: :class:`~deepinteract_tpu_torch.models.
    stem.DeepLabStemConv` (materialized tensor or factors, one parameter
    set) + masked instance norm + relu."""

    def __init__(self, in_channels: int, features: int):
        super().__init__(in_channels, features, 7, 2)
        self.conv = DeepLabStemConv(in_channels, features)


class SeparableConv(nn.Module):
    """Depthwise 3x3 (optionally atrous) + pointwise 1x1 + norm + relu. The
    depthwise HWIO kernel ``[3, 3, 1, C]`` is OIHW ``[C, 1, 3, 3]`` with
    ``groups=C``."""

    flax_names = {"Conv_0": "depthwise", "Conv_1": "pointwise", "InstanceNorm_0": "norm"}

    def __init__(self, in_channels: int, features: int, dilation: int = 1):
        super().__init__()
        self.depthwise = SameConv2d(in_channels, in_channels, 3, dilation=dilation,
                                    groups=in_channels, bias=False)
        self.pointwise = Conv2d(in_channels, features, 1, bias=False)
        self.norm = InstanceNorm(features)

    def forward(self, x, mask):
        return F.relu(self.norm(self.pointwise(self.depthwise(x)), mask))


class BasicBlock(nn.Module):
    """ResNet-34 basic block: two 3x3 convs + identity or 1x1 projection."""

    flax_names = {"ConvNormAct_0": "conv1", "ConvNormAct_1": "conv2", "ConvNormAct_2": "proj"}

    def __init__(self, in_channels: int, features: int, stride: int, dilation: int,
                 project: bool):
        super().__init__()
        self.conv1 = ConvNormAct(in_channels, features, 3, stride, dilation)
        self.conv2 = ConvNormAct(features, features, 3, 1, dilation, use_act=False)
        self.proj = (ConvNormAct(in_channels, features, 1, stride, use_act=False)
                     if project else None)

    def forward(self, x, mask):
        y = self.conv2(self.conv1(x, mask), mask)
        return F.relu(y + (x if self.proj is None else self.proj(x, mask)))


class BottleneckResBlock(nn.Module):
    """ResNet-50 bottleneck, 1x1 reduce -> 3x3 -> 1x1 expand, striding on
    the first 1x1 (ResNet v1, as the JAX package: the strided norm then
    sees the mask of its own scale). torchvision's v1.5 strides on the 3x3:
    same shapes, other activations."""

    flax_names = {"ConvNormAct_0": "reduce", "ConvNormAct_1": "conv",
                  "ConvNormAct_2": "expand", "ConvNormAct_3": "proj"}

    def __init__(self, in_channels: int, features: int, stride: int, dilation: int,
                 project: bool):
        super().__init__()
        mid = features // 4
        self.reduce = ConvNormAct(in_channels, mid, 1, stride)
        self.conv = ConvNormAct(mid, mid, 3, 1, dilation)
        self.expand = ConvNormAct(mid, features, 1, use_act=False)
        self.proj = (ConvNormAct(in_channels, features, 1, stride, use_act=False)
                     if project else None)

    def forward(self, x, mask):
        y = self.expand(self.conv(self.reduce(x, mask), mask), mask)
        return F.relu(y + (x if self.proj is None else self.proj(x, mask)))


class ResNetEncoder(nn.Module):
    """Stem (7x7/2 + 3x3/2 max pool) + 4 residual stages. Returns (1/4-scale
    skip, its mask, deep features, their mask)."""

    flax_names = {"ConvNormAct_0": "stem"}

    def __init__(self, cfg: DeepLabConfig):
        super().__init__()
        self.remat = cfg.remat
        self.stem = StemConvNorm(cfg.in_channels, cfg.stem_channels)
        block_cls = (BottleneckResBlock if ENCODER_ZOO[cfg.encoder_name][0] == "bottleneck"
                     else BasicBlock)
        self.plan = _PLAN8 if cfg.output_stride == 8 else _PLAN16
        self.stages = []
        in_ch = cfg.stem_channels
        for s, (feats, blocks) in enumerate(zip(cfg.stage_channels, cfg.stage_blocks)):
            stride, dilation = self.plan[s]
            names = []
            for b in range(blocks):
                # Projections follow the os-16 plan, so both output
                # strides share one parameter tree.
                project = b == 0 and (_PLAN16[s][0] != 1 or in_ch != feats)
                names.append(f"stage{s}_block{b}")
                self.add_module(names[-1], block_cls(in_ch, feats, stride if b == 0 else 1,
                                                     dilation, project))
                in_ch = feats
            self.stages.append(names)

    def forward(self, x, mask):
        x = self.stem(x, _pool_mask(mask, 2))
        m4 = _pool_mask(mask, 4)
        # Max pooling at the pad frontier picks up valid neighbours: re-zero
        # the padded pixels before the stage convs read them.
        x = _max_pool_same(x) * m4.to(x.dtype)
        m, scale, skip = m4, 4, None
        for s, names in enumerate(self.stages):
            if self.plan[s][0] == 2:
                scale *= 2
                m = _pool_mask(mask, scale)
            for name in names:
                block = getattr(self, name)
                x = remat_call(block, "full", x, m) if self.remat else block(x, m)
            if s == 0:
                skip = x
        return skip, m4, x, m


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: 1x1 + one separable atrous conv per
    rate + masked global pooling (mean in float32), concatenated,
    projected, refined, dropout."""

    def __init__(self, cfg: DeepLabConfig, in_channels: int):
        super().__init__()
        ch, n = cfg.decoder_channels, len(cfg.aspp_rates)
        self.flax_names = {"ConvNormAct_0": "branch", "Conv_0": "pool_conv",
                           "ConvNormAct_1": "project", f"SeparableConv_{n}": "refine",
                           **{f"SeparableConv_{i}": f"rate_{i}" for i in range(n)}}
        self.branch = ConvNormAct(in_channels, ch, 1)
        for i, rate in enumerate(cfg.aspp_rates):
            self.add_module(f"rate_{i}", SeparableConv(in_channels, ch, rate))
        self.num_rates = n
        self.pool_conv = Conv2d(in_channels, ch, 1, bias=False)
        self.project = ConvNormAct(ch * (n + 2), ch, 1)
        self.refine = SeparableConv(ch, ch)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, x, mask):
        branches = [self.branch(x, mask)]
        branches += [getattr(self, f"rate_{i}")(x, mask) for i in range(self.num_rates)]
        m = mask.to(STATS_DTYPE)
        count = torch.clamp(m.sum(dim=(2, 3), keepdim=True), min=1.0)
        pooled = ((x.to(STATS_DTYPE) * m).sum(dim=(2, 3), keepdim=True) / count).to(x.dtype)
        pooled = F.relu(self.pool_conv(pooled))
        branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        y = self.project(torch.cat(branches, dim=1), mask)
        return self.dropout(self.refine(y, mask))


class DeepLabDecoder(nn.Module):
    """Drop-in alternative to ``InteractionDecoder``: ``pair_input`` is a
    :class:`~deepinteract_tpu_torch.models.stem.PairFactors` bundle (with
    chain masks) or the materialized ``[B, H, W, 2C]`` tensor, ``mask`` the
    ``[B, H, W]`` pair mask (None: derived from the chain masks, or all
    valid). The map is padded to a multiple of the output stride and the
    logits sliced back. Returns float32 logits ``[B, H, W, num_classes]``,
    zero at padded pairs."""

    flax_names = {"ResNetEncoder_0": "encoder", "ASPP_0": "aspp", "ConvNormAct_0": "high_res",
                  "SeparableConv_0": "fuse_0", "SeparableConv_1": "fuse_1", "Conv_0": "head"}

    def __init__(self, cfg: DeepLabConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.decoder_channels
        self.encoder = ResNetEncoder(cfg)
        self.aspp = ASPP(cfg, cfg.stage_channels[-1])
        self.high_res = ConvNormAct(cfg.stage_channels[0], cfg.high_res_channels, 1)
        self.fuse_0 = SeparableConv(ch + cfg.high_res_channels, ch)
        self.fuse_1 = SeparableConv(ch, ch)
        self.head = nn.Conv2d(ch, cfg.num_classes, 1)  # float32 logits

    def forward(self, pair_input, mask=None):
        cfg = self.cfg
        dt = cfg.dtype
        os_ = cfg.output_stride
        if isinstance(pair_input, PairFactors):
            f1, f2 = pair_input.feats1, pair_input.feats2
            b, h = f1.shape[:2]
            w = f2.shape[1]
            m1 = (torch.ones((b, h), dtype=dt, device=f1.device) if pair_input.mask1 is None
                  else pair_input.mask1.to(dt))
            m2 = (torch.ones((b, w), dtype=dt, device=f2.device) if pair_input.mask2 is None
                  else pair_input.mask2.to(dt))
            ph, pw = (-h) % os_, (-w) % os_
            f1, m1 = F.pad(f1, (0, 0, 0, ph)), F.pad(m1, (0, ph))
            f2, m2 = F.pad(f2, (0, 0, 0, pw)), F.pad(m2, (0, pw))
            # A caller's pair mask must lie inside the chain masks' outer
            # product: the stem conv factorizes only that form.
            mask = (m1[:, :, None] * m2[:, None, :] if mask is None
                    else F.pad(mask.to(dt), (0, pw, 0, ph)))
            enc_in = PairFactors(f1.to(dt), f2.to(dt), m1, m2)
        else:
            b, h, w, _ = pair_input.shape
            mask = (torch.ones((b, h, w), dtype=dt, device=pair_input.device) if mask is None
                    else mask.to(dt))
            ph, pw = (-h) % os_, (-w) % os_
            x = F.pad(pair_input, (0, 0, 0, pw, 0, ph))
            mask = F.pad(mask, (0, pw, 0, ph))
            enc_in = (x.to(dt) * mask[..., None]).permute(0, 3, 1, 2)
        m = mask[:, None]  # [B, 1, H, W]

        skip, m4, deep, m_deep = self.encoder(enc_in, m)
        y = self.aspp(deep, m_deep)
        # Upsample to the 1/4-scale skip, fuse with its 1x1 projection,
        # refine.
        y = _masked_resize(y, m_deep, skip.shape[2:])
        hi = self.high_res(skip, m4)
        y = torch.cat([y * m4.to(y.dtype), hi], dim=1)
        y = self.fuse_1(self.fuse_0(y, m4), m4)
        # Head in float32, upsampled to the padded input size.
        logits = _masked_resize(self.head(y.to(OUTPUT_DTYPE)), m4, (h + ph, w + pw))
        logits = logits[:, :, :h, :w] * m[:, :, :h, :w].to(OUTPUT_DTYPE)
        return logits.permute(0, 2, 3, 1)
