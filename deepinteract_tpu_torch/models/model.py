"""The full siamese network: Geometric Transformer encoder x2 -> interaction
stem -> dilated SE-ResNet decoder -> per-pair contact logits.

Port of ``ModelConfig`` and ``DeepInteract`` from
``deepinteract_tpu/models/model.py`` for the geotran encoder and the
dilated decoder. Both chains share one set of encoder weights.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from torch import nn

from deepinteract_tpu_torch import constants as C
from deepinteract_tpu_torch.data.graph import ProteinGraph
from deepinteract_tpu_torch.models.decoder import DecoderConfig, InteractionDecoder
from deepinteract_tpu_torch.models.geometric_transformer import GeometricTransformer, GTConfig
from deepinteract_tpu_torch.models.interaction import interaction_tensor, pair_mask
from deepinteract_tpu_torch.models.layers import GODense
from deepinteract_tpu_torch.models.policy import validate_compute_dtype
from deepinteract_tpu_torch.models.stem import PairFactors, validate_stem


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full-network hyperparameters (defaults follow the reference's)."""

    num_node_input_feats: int = C.NUM_NODE_FEATS
    gnn: GTConfig = dataclasses.field(default_factory=GTConfig)
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)
    num_classes: int = C.NUM_CLASSES
    # 'factorized' computes the decoder's first layer from per-chain
    # features without the [B, L1, L2, 2C] tensor; 'materialized' builds
    # it. Both share one parameter set.
    interaction_stem: str = "factorized"
    # None keeps the sub-configs' own dtypes; 'float32' / 'bfloat16' is
    # pushed into the encoder and the decoder.
    compute_dtype: Optional[str] = None

    def __post_init__(self):
        validate_stem(self.interaction_stem)
        if self.compute_dtype is not None:
            validate_compute_dtype(self.compute_dtype)
            object.__setattr__(self, "gnn", dataclasses.replace(
                self.gnn, compute_dtype=self.compute_dtype))
            object.__setattr__(self, "decoder", dataclasses.replace(
                self.decoder, compute_dtype=self.compute_dtype))
        if (self.decoder.in_channels != 2 * self.gnn.hidden
                or self.decoder.num_classes != self.num_classes):
            object.__setattr__(self, "decoder", dataclasses.replace(
                self.decoder, in_channels=2 * self.gnn.hidden,
                num_classes=self.num_classes))


class DeepInteract(nn.Module):
    """Siamese GT + interaction decoder. ``forward`` returns
    ``[B, L1, L2, num_classes]`` float32 logits and, optionally, the
    learned node/edge representations. In train mode (``.train()``) the
    batch norms normalize with batch statistics and update their running
    ones, and dropout draws from the generator that
    ``layers.dropout_rng(model, generator)`` sets (``training.steps`` does
    this)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.gnn.hidden
        if cfg.num_node_input_feats != hidden:
            self.node_in_embedding = GODense(cfg.num_node_input_feats, hidden, bias=False)
        else:
            self.node_in_embedding = None
        self.gnn = GeometricTransformer(cfg.gnn)
        self.decoder = InteractionDecoder(cfg.decoder)

    def encode(self, graph: ProteinGraph):
        """Shared-weight chain encoder (siamese leg) -> (node_feats [B,N,C],
        edge_feats [B,N,K,C])."""
        x = graph.node_feats.to(self.cfg.gnn.dtype)
        if self.node_in_embedding is not None:
            x = self.node_in_embedding(x)
        return self.gnn(graph, x)

    def decode(self, feats1, feats2, mask1, mask2):
        """Interaction stem + decoder over encoded chain features
        ``[B, L, C]`` and node masks ``[B, L]``. ``forward`` is exactly
        ``decode(encode(g1), encode(g2))``."""
        dt = self.cfg.gnn.dtype
        feats1, feats2 = feats1.to(dt), feats2.to(dt)
        pm = pair_mask(mask1, mask2)
        if self.cfg.interaction_stem == "factorized":
            return self.decoder(PairFactors(feats1, feats2), pm)
        return self.decoder(interaction_tensor(feats1, feats2), pm)

    def forward(self, graph1: ProteinGraph, graph2: ProteinGraph,
                return_representations: bool = False):
        feats1, efeats1 = self.encode(graph1)
        feats2, efeats2 = self.encode(graph2)
        logits = self.decode(feats1, feats2, graph1.node_mask, graph2.node_mask)
        if return_representations:
            return logits, {
                "graph1_node_feats": feats1,
                "graph1_edge_feats": efeats1,
                "graph2_node_feats": feats2,
                "graph2_edge_feats": efeats2,
            }
        return logits
