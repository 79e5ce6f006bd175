"""The full siamese network: chain encoder x2 -> interaction stem -> 2D
decoder -> per-pair contact logits.

Port of ``ModelConfig``, ``GCNStack`` and ``DeepInteract`` from
``deepinteract_tpu/models/model.py``. The encoder is the Geometric
Transformer ('geotran') or a plain GCN ('gcn'); the decoder the dilated
SE-ResNet ('dilated') or DeepLabV3+ ('deeplab'), decoded whole or, with
``tile_pair_map``, in tiles (``models/tiled.py``). Both chains share one
set of encoder weights.

With ``shard_pair_map`` (context parallelism; the JAX package's field of
the same name) the dilated decoder runs on this rank's rows of the pair
map over the pair group of the active ``parallel.pair.pair_sharded``
block, untiled or inside each tile, and ``forward`` returns those rows
(:meth:`DeepInteract.pair_row_slices`). The encoder is replicated over
the pair group: every rank encodes both chains. A configuration that
cannot be sharded raises; it never runs unsharded in its place.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from deepinteract_tpu_torch import constants as C
from deepinteract_tpu_torch.data.graph import ProteinGraph
from deepinteract_tpu_torch.models.decoder import DecoderConfig, InteractionDecoder
from deepinteract_tpu_torch.models.geometric_transformer import GeometricTransformer, GTConfig
from deepinteract_tpu_torch.models.interaction import interaction_tensor, pair_mask
from deepinteract_tpu_torch.models.layers import GODense
from deepinteract_tpu_torch.models.policy import validate_compute_dtype
from deepinteract_tpu_torch.models.stem import PairFactors, shard_pair_rows, validate_stem
from deepinteract_tpu_torch.models.tiled import tiled_decode
from deepinteract_tpu_torch.models.vision import DeepLabConfig, DeepLabDecoder
from deepinteract_tpu_torch.ops.cuda_attention import in_edge_csr
from deepinteract_tpu_torch.parallel.pair import active_pair, row_slices

GNN_LAYER_TYPES = ("geotran", "gcn")
INTERACT_MODULE_TYPES = ("dilated", "deeplab")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full-network hyperparameters (defaults follow the reference's)."""

    num_node_input_feats: int = C.NUM_NODE_FEATS
    gnn: GTConfig = dataclasses.field(default_factory=GTConfig)
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)
    gnn_layer_type: str = "geotran"  # 'geotran' | 'gcn'
    interact_module_type: str = "dilated"  # 'dilated' | 'deeplab'
    num_classes: int = C.NUM_CLASSES
    # Context parallelism: decode this rank's rows of the L1 x L2 map over
    # the pair group (parallel/pair.py; needs a pair mesh at decode time).
    shard_pair_map: bool = False
    # Decode the pair map in tile_size x tile_size blocks when a padded
    # chain exceeds one tile (models/tiled.py).
    tile_pair_map: bool = False
    tile_size: int = C.PAIR_MAP_TILE
    deeplab: DeepLabConfig = dataclasses.field(default_factory=DeepLabConfig)
    # 'factorized' computes the decoder's first layer from per-chain
    # features without the [B, L1, L2, 2C] tensor; 'materialized' builds
    # it. Both share one parameter set.
    interaction_stem: str = "factorized"
    # None keeps the sub-configs' own dtypes; 'float32' / 'bfloat16' is
    # pushed into the encoder and both decoders.
    compute_dtype: Optional[str] = None

    def __post_init__(self):
        validate_stem(self.interaction_stem)
        if self.gnn_layer_type not in GNN_LAYER_TYPES:
            raise ValueError(f"unknown gnn_layer_type {self.gnn_layer_type!r}; expected one "
                             f"of {GNN_LAYER_TYPES}")
        if self.interact_module_type not in INTERACT_MODULE_TYPES:
            raise ValueError(f"unknown interact_module_type {self.interact_module_type!r}; "
                             f"expected one of {INTERACT_MODULE_TYPES}")
        if self.shard_pair_map and self.interact_module_type == "deeplab":
            raise ValueError("pair-map sharding of the DeepLab decoder is not ported "
                             "(DeepLab's pair sharding, ROADMAP queue 1 item 2): use the "
                             "dilated decoder or drop shard_pair_map")
        if self.compute_dtype is not None:
            validate_compute_dtype(self.compute_dtype)
            for name in ("gnn", "decoder", "deeplab"):
                object.__setattr__(self, name, dataclasses.replace(
                    getattr(self, name), compute_dtype=self.compute_dtype))
        # The decoders' input width and classes follow the encoder.
        for name in ("decoder", "deeplab"):
            sub = getattr(self, name)
            if sub.in_channels != 2 * self.gnn.hidden or sub.num_classes != self.num_classes:
                object.__setattr__(self, name, dataclasses.replace(
                    sub, in_channels=2 * self.gnn.hidden, num_classes=self.num_classes))


class GCNStack(nn.Module):
    """The plain graph-convolution encoder (``--gnn_layer_type gcn``): per
    layer a bias-free dense map, DGL ``GraphConv(norm='both')`` message
    passing weighted by the min-max-normalized squared distance (edge
    feature column 1), the bias, and the node mask; no activation between
    layers. Both norms are rsqrt(max(degree, 1e-9)) over unweighted valid
    edge counts (out-degree at the source, in-degree at the destination).

    Messages are summed into their destinations in the order of the
    in-edge CSR (``ops.cuda_attention.in_edge_csr``, one build per
    forward): the edges sorted by destination form one contiguous segment
    per destination, and a segmented inclusive scan (log2(N*K) shifted
    adds, each masked to its own segment) leaves every segment's sum at
    its last position. Every shape follows from the graph's shapes alone,
    and nothing is read on the host, so the forward captures as a CUDA
    graph; the sums use no atomics and are bitwise repeatable (unlike
    ``index_add_``), and a hub of any in-degree is summed whole.
    Returns ``(node_feats, None)``: the GCN learns no edge features."""

    def __init__(self, cfg: GTConfig):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.num_layers):
            self.add_module(f"gcn_{i}", GODense(cfg.hidden, cfg.hidden, bias=False))
            self.register_parameter(f"gcn_bias_{i}", nn.Parameter(torch.zeros(cfg.hidden)))

    def forward(self, graph: ProteinGraph, node_feats: torch.Tensor):
        b, n, kk = graph.nbr_idx.shape
        e_mask = graph.edge_mask().to(node_feats.dtype)                    # [B, N, K]
        w = (graph.edge_feats[..., C.EDGE_WEIGHT].to(node_feats.dtype) * e_mask).reshape(b, n * kk)
        in_ptr, in_eid = in_edge_csr(graph.nbr_idx)
        eid = in_eid.long()                                                # [B, P] by destination
        dst = torch.gather(graph.nbr_idx.reshape(b, -1).long(), 1, eid)   # nondecreasing
        src = eid // kk
        p = n * kk
        spans = []
        span = 1
        while span < p:  # the scan's steps: (shift, same-segment mask)
            spans.append((span, (dst[:, span:] == dst[:, :-span])[..., None]))
            span *= 2
        last = (in_ptr[:, 1:].long() - 1).clamp(min=0)[..., None]         # [B, N, 1]
        has_in = (in_ptr[:, 1:] > in_ptr[:, :-1])[..., None]               # [B, N, 1]

        def into_dst(vals):  # [B, P, C] in CSR order -> [B, N, C] per-destination sums
            for shift, same in spans:
                vals = torch.cat([vals[:, :shift],
                                  vals[:, shift:] + torch.where(same, vals[:, :-shift], 0)], 1)
            return torch.gather(vals, 1, last.expand(-1, -1, vals.shape[-1])) * has_in

        norm_src = torch.rsqrt(torch.clamp(e_mask.sum(-1), min=1e-9))     # out-degree
        in_deg = into_dst(torch.gather(e_mask.reshape(b, -1), 1, eid)[..., None])[..., 0]
        norm_dst = torch.rsqrt(torch.clamp(in_deg, min=1e-9))
        w_in = torch.gather(w, 1, eid)[..., None]                          # [B, P, 1]
        batch = torch.arange(b, device=src.device)[:, None]
        node_mask = graph.node_mask[..., None].to(node_feats.dtype)
        h = node_feats
        for i in range(self.cfg.num_layers):
            hn = getattr(self, f"gcn_{i}")(h) * norm_src[..., None]
            h = into_dst(hn[batch, src] * w_in) * norm_dst[..., None]
            h = (h + getattr(self, f"gcn_bias_{i}").to(h.dtype)) * node_mask
        return h, None


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
        self.gnn = (GCNStack(cfg.gnn) if cfg.gnn_layer_type == "gcn"
                    else GeometricTransformer(cfg.gnn))
        self.decoder = (DeepLabDecoder(cfg.deeplab) if cfg.interact_module_type == "deeplab"
                        else InteractionDecoder(cfg.decoder))

    def encode(self, graph: ProteinGraph):
        """Shared-weight chain encoder (siamese leg) -> (node_feats [B,N,C],
        edge_feats [B,N,K,C], or None from the GCN)."""
        x = graph.node_feats.to(self.cfg.gnn.dtype)
        if self.node_in_embedding is not None:
            x = self.node_in_embedding(x)
        return self.gnn(graph, x)

    def _tiled(self, l1: int, l2: int) -> bool:
        return self.cfg.tile_pair_map and max(l1, l2) > self.cfg.tile_size

    def pair_row_slices(self, l1: int, l2: int, pair) -> List[slice]:
        """The rows of an ``l1 x l2`` map that a ``shard_pair_map`` decode
        returns on this rank of ``pair``: one run per tile row when tiled,
        one run untiled. Raises when the rows do not split into shards at
        least as wide as the decoder's halo."""
        blocks = l1 // self.cfg.tile_size if self._tiled(l1, l2) else 1
        return row_slices(l1, pair, blocks, self.decoder.halo_rows())

    def _pair(self):
        pair = active_pair()
        if pair is None:
            raise RuntimeError(
                "shard_pair_map decodes over a pair group: run it inside "
                "parallel.pair.pair_sharded(mesh.pair), as cli.train, cli.test and "
                "cli.serve's pair placement do")
        return pair

    def decode(self, feats1, feats2, mask1, mask2):
        """Interaction stem + decoder over encoded chain features
        ``[B, L, C]`` and node masks ``[B, L]``; tiled when
        ``tile_pair_map`` is set and a chain exceeds ``tile_size``;
        this rank's rows (:meth:`pair_row_slices`) with ``shard_pair_map``.
        ``forward`` is exactly ``decode(encode(g1), encode(g2))``."""
        cfg = self.cfg
        dt = cfg.gnn.dtype
        feats1, feats2 = feats1.to(dt), feats2.to(dt)
        pair = self._pair() if cfg.shard_pair_map else None
        if self._tiled(feats1.shape[1], feats2.shape[1]):
            return tiled_decode(self.decoder, feats1, feats2, mask1, mask2, cfg.tile_size,
                                cfg.interaction_stem, pair=pair)
        if pair is not None:
            rows = self.pair_row_slices(feats1.shape[1], feats2.shape[1], pair)
            feats1, mask1 = shard_pair_rows(feats1, rows), shard_pair_rows(mask1, rows)
        pm = pair_mask(mask1, mask2)
        stem_input = (PairFactors(feats1, feats2, mask1, mask2)
                      if cfg.interaction_stem == "factorized"
                      else interaction_tensor(feats1, feats2))
        return self.decoder(stem_input, pm) if pair is None else self.decoder(stem_input, pm, pair)

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
