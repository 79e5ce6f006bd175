"""Contact-prediction objective.

Port of ``deepinteract_tpu/training/objective.py``. The reference's
example tensor enumerates every L1 x L2 pair, so its cross entropy over
gathered (i, j) examples equals a dense masked cross entropy over the pair
map, which is :func:`contact_loss`; :func:`example_gather_loss` keeps the
gather form for sampled examples.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# Reference class weights: negatives 1, positives 5.
DEFAULT_CLASS_WEIGHTS = (1.0, 5.0)


def _weighted_ce(logits, labels, mask, weight_classes: bool, class_weights) -> torch.Tensor:
    """-sum(w * log p[label]) / max(sum(w), 1) with w = mask (times the
    label's class weight): torch ``CrossEntropyLoss``'s (weighted) mean."""
    ll = torch.gather(F.log_softmax(logits, dim=-1), -1, labels[..., None].long())[..., 0]
    w = mask.to(logits.dtype)
    if weight_classes:
        # A select, not an index into a tensor built from the tuple: that
        # would copy from the host inside a captured step.
        w = torch.where(labels.long() == 1, class_weights[1], class_weights[0]).to(w.dtype) * w
    return -(w * ll).sum() / torch.clamp(w.sum(), min=1.0)


def contact_loss(logits: torch.Tensor, contact_map: torch.Tensor, pair_mask: torch.Tensor,
                 weight_classes: bool = False,
                 class_weights: Tuple[float, float] = DEFAULT_CLASS_WEIGHTS) -> torch.Tensor:
    """Masked mean cross entropy over the dense pair map. logits
    [B, L1, L2, 2]; contact_map [B, L1, L2] int; pair_mask [B, L1, L2]."""
    return _weighted_ce(logits, contact_map, pair_mask, weight_classes, class_weights)


def example_gather_loss(logits: torch.Tensor, examples: torch.Tensor,
                        example_mask: torch.Tensor, weight_classes: bool = False,
                        class_weights: Tuple[float, float] = DEFAULT_CLASS_WEIGHTS) -> torch.Tensor:
    """Cross entropy over (i, j, label) examples [B, M, 3] with their mask
    [B, M]: the reference's flat-index gather form."""
    i, j, labels = examples[..., 0].long(), examples[..., 1].long(), examples[..., 2]
    batch = torch.arange(logits.shape[0], device=logits.device)[:, None]
    return _weighted_ce(logits[batch, i, j], labels, example_mask, weight_classes,
                        class_weights)


def downsample_examples(examples: torch.Tensor, example_mask: torch.Tensor, pn_ratio: float,
                        generator: torch.Generator) -> torch.Tensor:
    """The reference's negative-pair downsampling at a static shape: keeps
    every positive and each negative with probability
    (num_pos / pn_ratio) / num_neg (clipped to [0, 1]), drawn from
    ``generator``. Returns the new [B, M] mask."""
    labels = examples[..., 2]
    pos = (labels == 1) & example_mask
    neg = (labels == 0) & example_mask
    num_pos = pos.sum(-1, keepdim=True).float()
    num_neg = torch.clamp(neg.sum(-1, keepdim=True).float(), min=1.0)
    keep_prob = torch.clamp((num_pos / pn_ratio) / num_neg, 0.0, 1.0)
    u = torch.rand(labels.shape, generator=generator, device=labels.device)
    return pos | (neg & (u < keep_prob))
