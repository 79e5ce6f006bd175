"""Interaction stems: the decoders' first layer, with or without the 2C
pair tensor.

Port of ``PairFactors``, ``PairStem1x1``, ``factorized_stem_conv`` and
``DeepLabStemConv`` from ``deepinteract_tpu/models/stem.py``. The
interaction tensor's value at (i, j) is ``[f1_i | f2_j]``, so the dilated
decoder's 1x1 conv splits per chain:

    conv1x1([f1_i | f2_j]) = W1 @ f1_i + W2 @ f2_j + b,

two O(L*C^2) matmuls plus a broadcast add that materializes only the
``features`` output channels. The JAX conv kernel ``[1, 1, 2C, F]`` is
held here as its two halves (``weights.load_jax_variables`` splits it).
DeepLab's 7x7/2 stem conv of the masked tensor splits the same way, per
channel block, into 1-D convs over each chain contracted against the
other chain's shifted masks (:func:`factorized_stem_conv`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepinteract_tpu_torch.models.layers import Conv2d, Dense

STEM_CHOICES = ("factorized", "materialized")


def validate_stem(name: str) -> str:
    if name not in STEM_CHOICES:
        raise ValueError(f"unknown interaction stem {name!r}; expected one of "
                         f"{STEM_CHOICES}")
    return name


@dataclasses.dataclass
class PairFactors:
    """Per-chain factors of the interaction tensor: the encoded
    ``[B, L1, C]`` / ``[B, L2, C]`` chain features and their ``[B, L]``
    validity masks (None = fully valid). The pair mask travels beside
    them, as the decoder's ``mask`` argument; the DeepLab stem reads the
    chain masks."""

    feats1: torch.Tensor
    feats2: torch.Tensor
    mask1: Optional[torch.Tensor] = None
    mask2: Optional[torch.Tensor] = None


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


def same_pad(size: int, kernel: int, stride: int):
    """flax/XLA 'SAME' padding of one spatial dim -> (lo, hi, out): the
    total pad goes ``lo = total // 2`` before and the rest after, so at
    stride 2 it is asymmetric (PyTorch's ``padding=k // 2`` is not).
    ``kernel`` is the effective (dilated) extent."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    lo = total // 2
    return lo, total - lo, out


def _conv1d(x, kernel, stride: int, pad):
    """[B, L, Cin] x HIO [K, Cin, Cout] -> [B, Lout, Cout]."""
    y = F.conv1d(F.pad(x.transpose(1, 2), pad), kernel.permute(2, 1, 0), stride=stride)
    return y.transpose(1, 2)


def _shifted_mask(mask, kernel: int, stride: int, pad, out: int):
    """[B, L] mask -> [B, Lout, K] with entry (o, t) = mask[stride*o + t -
    lo] (zero outside): the per-tap mask slices the factorized combine
    contracts against."""
    mp = F.pad(mask, pad)
    return torch.stack([mp[:, t: t + stride * (out - 1) + 1: stride] for t in range(kernel)],
                       dim=-1)


def factorized_stem_conv(factors: PairFactors, weight: torch.Tensor, stride: int,
                         dtype: torch.dtype) -> torch.Tensor:
    """A KxK/stride 'SAME' bias-free conv of the *masked* pair tensor,
    computed from per-chain factors without materializing it.

    ``weight``: OIHW ``[F, C1 + C2, K, K]``. The masked tensor is
    channel-block separable, ``x[i, j, :C1] = g1[i] * m2[j]`` and
    ``x[i, j, C1:] = g2[j] * m1[i]`` with ``g = f * m``, so each block's
    conv is a 1-D conv over its own chain (taps x output channels folded
    into ``K * F`` channels) contracted against the other chain's
    shifted-mask slices; zero padding extends masks and features by zeros
    alike, so this is exact up to float association. Returns NCHW
    ``[B, F, Hout, Wout]`` in ``dtype``."""
    f1, f2 = factors.feats1, factors.feats2
    b, h, c1 = f1.shape
    w = f2.shape[1]
    k = weight.to(dtype).permute(2, 3, 1, 0)  # HWIO [kh, kw, Cin, F]
    kh, kw, _, fo = k.shape
    lo_h, hi_h, out_h = same_pad(h, kh, stride)
    lo_w, hi_w, out_w = same_pad(w, kw, stride)
    m1 = (torch.ones((b, h), dtype=dtype, device=f1.device) if factors.mask1 is None
          else factors.mask1.to(dtype))
    m2 = (torch.ones((b, w), dtype=dtype, device=f2.device) if factors.mask2 is None
          else factors.mask2.to(dtype))
    g1 = f1.to(dtype) * m1[..., None]
    g2 = f2.to(dtype) * m2[..., None]

    # Chain-1 block: conv over rows, output channels (column tap, F).
    k1 = k[:, :, :c1].permute(0, 2, 1, 3).reshape(kh, c1, kw * fo)
    a1 = _conv1d(g1, k1, stride, (lo_h, hi_h)).reshape(b, out_h, kw, fo)
    m2s = _shifted_mask(m2, kw, stride, (lo_w, hi_w), out_w)
    y = torch.einsum("bitf,bjt->bfij", a1, m2s)
    # Chain-2 block: conv over columns, output channels (row tap, F).
    c2 = k.shape[2] - c1
    k2 = k[:, :, c1:].permute(1, 2, 0, 3).reshape(kw, c2, kh * fo)
    a2 = _conv1d(g2, k2, stride, (lo_w, hi_w)).reshape(b, out_w, kh, fo)
    m1s = _shifted_mask(m1, kh, stride, (lo_h, hi_h), out_h)
    return y + torch.einsum("bjtf,bit->bfij", a2, m1s)


class SameConv2d(Conv2d):
    """flax ``nn.Conv(padding="SAME")``, NCHW: the input is padded
    explicitly by :func:`same_pad` per spatial dim, so a strided conv
    samples the same pixels as the JAX package's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw), (dh, dw) = self.kernel_size, self.stride, self.dilation
        lo_h, hi_h, _ = same_pad(x.shape[2], (kh - 1) * dh + 1, sh)
        lo_w, hi_w, _ = same_pad(x.shape[3], (kw - 1) * dw + 1, sw)
        if lo_h or hi_h or lo_w or hi_w:
            x = F.pad(x, (lo_w, hi_w, lo_h, hi_h))
        return super().forward(x)


class DeepLabStemConv(SameConv2d):
    """DeepLab's bias-free 7x7/2 'SAME' stem conv (one ``kernel`` leaf, as
    the flax ``nn.Conv`` it stands for) over :class:`PairFactors`
    (:func:`factorized_stem_conv`, in the features' dtype) or over the
    materialized masked NCHW tensor. Returns NCHW."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 7,
                 stride: int = 2):
        super().__init__(in_channels, features, kernel_size, stride=stride, bias=False)

    def forward(self, x) -> torch.Tensor:
        if isinstance(x, PairFactors):
            return factorized_stem_conv(x, self.weight, self.stride[0], x.feats1.dtype)
        return super().forward(x)
