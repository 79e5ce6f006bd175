"""Interaction-tensor construction: two chains' node features -> pair map.

Port of ``deepinteract_tpu/models/interaction.py``. The value at (i, j) is
``[feats1_i | feats2_j]`` (chain-1 channels first), NHWC
``[B, L1, L2, 2C]``. This is the materialized form; the default
factorized stem (``models/stem.py``) never builds it.
"""

from __future__ import annotations

import torch


def interaction_tensor(feats1: torch.Tensor, feats2: torch.Tensor) -> torch.Tensor:
    """[B, L1, C] x [B, L2, C] -> [B, L1, L2, 2C]."""
    b, l1, c = feats1.shape
    l2 = feats2.shape[1]
    return torch.cat([feats1[:, :, None, :].expand(b, l1, l2, c),
                      feats2[:, None, :, :].expand(b, l1, l2, c)], dim=-1)


def pair_mask(node_mask1: torch.Tensor, node_mask2: torch.Tensor) -> torch.Tensor:
    """[B, L1] x [B, L2] -> [B, L1, L2] validity mask."""
    return node_mask1[:, :, None] & node_mask2[:, None, :]
