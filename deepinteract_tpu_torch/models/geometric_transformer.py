"""Geometric Transformer (GT) encoder on dense [N, K] graphs.

Port of ``deepinteract_tpu/models/geometric_transformer.py``:
  * InitEdgeModule              — gated edge initializer
  * ConformationModule          — edge-neighbourhood geometry module
  * PlainEdgeModule             — ``disable_geometric_mode`` stand-in
  * MultiHeadGeometricAttention — Q/K/V + edge projections into the
                                  fused edge attention
  * GeometricTransformerLayer   — node+edge (or node-only final) layer
  * GeometricTransformer        — init-edge + (L-1) layers + final layer

All edge state lives in ``[B, N, K, C]`` tensors. Submodule names follow
the flax module names, so a JAX parameter tree maps over by path
(``weights.load_jax_variables``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from deepinteract_tpu_torch import constants as C
from deepinteract_tpu_torch.data.graph import ProteinGraph
from deepinteract_tpu_torch.models import policy
from deepinteract_tpu_torch.models.layers import MLP, Dropout, FeatureNorm, GODense, ResBlock
from deepinteract_tpu_torch.ops import cuda_attention
from deepinteract_tpu_torch.ops.attention import edge_attention

ATTENTION_IMPLS = ("auto", "plain", "kernel")


@dataclasses.dataclass(frozen=True)
class GTConfig:
    """Encoder hyperparameters (defaults = the reference's)."""

    num_layers: int = 2
    hidden: int = 128
    num_heads: int = 4
    shared_embed: int = 64
    dist_embed: int = 8
    dir_embed: int = 8
    orient_embed: int = 8
    amide_embed: int = 8
    num_pre_res_blocks: int = 2
    num_post_res_blocks: int = 2
    norm_type: str = "batch"  # 'batch' | 'layer'
    dropout_rate: float = 0.2
    residual: bool = True
    node_count_limit: int = C.NODE_COUNT_LIMIT
    disable_geometric_mode: bool = False
    # 'scatter' is the reference's in-edge softmax; 'gather' the out-edge
    # approximation that only coincides on symmetric kNN graphs.
    attention_mode: str = "scatter"
    # 'auto': the CUDA kernel (ops/cuda_attention.py) for CUDA tensors in
    # scatter mode, the plain op (ops/attention.py) for CPU tensors or
    # gather mode. 'plain' / 'kernel' force one path; 'kernel' on CPU
    # tensors runs the kernel's plain version.
    attention_impl: str = "auto"
    compute_dtype: str = "float32"

    def __post_init__(self):
        policy.validate_compute_dtype(self.compute_dtype)
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}; "
                             f"expected one of {ATTENTION_IMPLS}")

    @property
    def dtype(self) -> torch.dtype:
        return policy.compute_dtype(self.compute_dtype)


def _split_geo_feats(orig_edge_feats: torch.Tensor):
    """Raw 28-d edge features -> (dist, dir, orient, amide) groups."""
    return (
        orig_edge_feats[..., C.EDGE_DIST_FEATS],
        orig_edge_feats[..., C.EDGE_DIR_FEATS],
        orig_edge_feats[..., C.EDGE_ORIENT_FEATS],
        orig_edge_feats[..., C.EDGE_AMIDE_ANGLE, None],
    )


def _edge_messages(orig_edge_feats: torch.Tensor) -> torch.Tensor:
    """[pos_enc, weight] channels."""
    return torch.stack([orig_edge_feats[..., C.EDGE_POS_ENC],
                        orig_edge_feats[..., C.EDGE_WEIGHT]], dim=-1)


class InitEdgeModule(nn.Module):
    """Gated edge initializer."""

    def __init__(self, cfg: GTConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.hidden
        self.node_embedding = nn.Embedding(cfg.node_count_limit, ch)
        groups = (("edge_messages", C.NUM_EDGE_MESSAGE_FEATS), ("dist", C.NUM_DIST_FEATS),
                  ("dir", C.NUM_DIR_FEATS), ("orient", C.NUM_ORIENT_FEATS),
                  ("amide", C.NUM_AMIDE_FEATS))
        for name, width in groups:
            for i in (0, 1):
                self.add_module(f"{name}_linear_{i}", GODense(width, ch, bias=False))
        self.combined_linear_0 = GODense(7 * ch, ch, bias=False)
        combined_out = sum(width for _, width in groups)
        self.combined_linear_1 = GODense(ch, combined_out, bias=False)
        self.combined_linear_2 = GODense(combined_out, ch, bias=False)

    def forward(self, graph: ProteinGraph, orig_edge_feats: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, n, k = graph.nbr_idx.shape
        if n > cfg.node_count_limit:
            raise ValueError(
                f"padded node count {n} exceeds node_count_limit="
                f"{cfg.node_count_limit}; raise GTConfig.node_count_limit for "
                "long-context buckets")
        node_emb = self.node_embedding.weight[:n].to(orig_edge_feats.dtype)  # [N, C]
        src_emb = node_emb[None, :, None, :].expand(b, n, k, cfg.hidden)
        dst_emb = node_emb[graph.nbr_idx]                                     # [B,N,K,C]

        msgs = _edge_messages(orig_edge_feats)
        dist, direc, orient, amide = _split_geo_feats(orig_edge_feats)
        silu = F.silu
        msg0 = self.edge_messages_linear_0(msgs)
        dist0 = silu(self.dist_linear_0(dist))
        dir0 = silu(self.dir_linear_0(direc))
        orient0 = silu(self.orient_linear_0(orient))
        amide0 = silu(self.amide_linear_0(amide))
        combined = silu(self.combined_linear_0(
            torch.cat([src_emb, dst_emb, msg0, dist0, dir0, orient0, amide0], dim=-1)))

        # Gated second branch; the message branch is NOT activated.
        msg1 = self.edge_messages_linear_1(msgs) * combined
        dist1 = silu(self.dist_linear_1(dist)) * combined
        dir1 = silu(self.dir_linear_1(direc)) * combined
        orient1 = silu(self.orient_linear_1(orient)) * combined
        amide1 = silu(self.amide_linear_1(amide)) * combined
        out = self.combined_linear_1(msg1 + dist1 + dir1 + orient1 + amide1)
        return self.combined_linear_2(out)


class ConformationModule(nn.Module):
    """Edge-neighbourhood geometry module."""

    def __init__(self, cfg: GTConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.hidden
        self.nbr_linear = GODense(ch, ch)
        self.dist_linear_0 = GODense(C.NUM_DIST_FEATS, cfg.dist_embed, bias=False)
        self.dist_linear_1 = GODense(cfg.dist_embed, ch, bias=False)
        self.downward_proj = GODense(ch, cfg.shared_embed, bias=False)
        self.dir_linear_0 = GODense(C.NUM_DIR_FEATS, cfg.dir_embed, bias=False)
        self.dir_linear_1 = GODense(cfg.dir_embed, cfg.shared_embed, bias=False)
        self.orient_linear_0 = GODense(C.NUM_ORIENT_FEATS, cfg.orient_embed, bias=False)
        self.orient_linear_1 = GODense(cfg.orient_embed, cfg.shared_embed, bias=False)
        self.amide_linear_0 = GODense(C.NUM_AMIDE_FEATS, cfg.amide_embed, bias=False)
        self.amide_linear_1 = GODense(cfg.amide_embed, cfg.shared_embed, bias=False)
        self.upward_proj = GODense(cfg.shared_embed, ch, bias=False)
        self.orig_msg_linear = GODense(ch, ch)
        self.pre_res_blocks = [f"pre_res_block_{i}" for i in range(cfg.num_pre_res_blocks)]
        self.post_res_blocks = [f"post_res_block_{i}" for i in range(cfg.num_post_res_blocks)]
        for name in self.pre_res_blocks + self.post_res_blocks:
            self.add_module(name, ResBlock(ch, cfg.norm_type))
        self.res_connect_linear = GODense(ch, ch)
        self.final_dist_linear = GODense(C.NUM_DIST_FEATS, ch, bias=False)
        self.final_dir_linear = GODense(C.NUM_DIR_FEATS, ch, bias=False)
        self.final_orient_linear = GODense(C.NUM_ORIENT_FEATS, ch, bias=False)
        self.final_amide_linear = GODense(C.NUM_AMIDE_FEATS, ch, bias=False)
        self.final_linear = GODense(ch, ch)

    def forward(self, graph: ProteinGraph, edge_feats, orig_edge_feats) -> torch.Tensor:
        b, n, k = graph.nbr_idx.shape
        ch = self.cfg.hidden
        edge_mask = graph.edge_mask()
        dist, direc, orient, amide = _split_geo_feats(orig_edge_feats)

        # Gather the sampled neighbouring-edge features by flat edge id,
        # stacking source-side and destination-side neighbourhoods.
        flat = edge_feats.reshape(b, n * k, ch)
        batch = torch.arange(b, device=flat.device)[:, None, None, None]
        nbr = torch.cat([flat[batch, graph.src_nbr_eids],
                         flat[batch, graph.dst_nbr_eids]], dim=3)  # [B,N,K,2G,C]

        silu = F.silu
        nbr = silu(self.nbr_linear(nbr))
        nbr = nbr * self.dist_linear_1(self.dist_linear_0(dist))[..., None, :]
        nbr = silu(self.downward_proj(nbr))
        nbr = nbr * self.dir_linear_1(self.dir_linear_0(direc))[..., None, :]
        nbr = nbr * self.orient_linear_1(self.orient_linear_0(orient))[..., None, :]
        nbr = nbr * self.amide_linear_1(self.amide_linear_0(amide))[..., None, :]
        nbr = silu(self.upward_proj(nbr.sum(3)))  # aggregate the 2G neighbourhood

        out = self.orig_msg_linear(edge_feats) + nbr
        for name in self.pre_res_blocks:
            out = getattr(self, name)(out, edge_mask)
        out = edge_feats + silu(self.res_connect_linear(out))
        for name in self.post_res_blocks:
            out = getattr(self, name)(out, edge_mask)

        gated = (self.final_dist_linear(dist) * out + self.final_dir_linear(direc) * out
                 + self.final_orient_linear(orient) * out
                 + self.final_amide_linear(amide) * out)
        return edge_feats + silu(self.final_linear(gated))


class PlainEdgeModule(nn.Module):
    """``disable_geometric_mode`` conformation stand-in: one Linear over
    [edge messages | raw edge feats]."""

    def __init__(self, cfg: GTConfig):
        super().__init__()
        self.linear = GODense(C.NUM_EDGE_MESSAGE_FEATS + C.NUM_EDGE_FEATS, cfg.hidden,
                              bias=False)

    def forward(self, orig_edge_feats: torch.Tensor) -> torch.Tensor:
        return self.linear(torch.cat([_edge_messages(orig_edge_feats), orig_edge_feats], -1))


def _attention_impl(cfg: GTConfig, x: torch.Tensor) -> str:
    """'plain' or 'kernel': the route of the edge attention for tensors
    on x's device (the CUDA kernels for CUDA tensors in scatter mode under
    'auto')."""
    if cfg.attention_impl != "auto":
        return cfg.attention_impl
    return "kernel" if x.is_cuda and cfg.attention_mode == "scatter" else "plain"


def _dispatch_attention(cfg: GTConfig, q, k, v, proj_e, nbr_idx, edge_mask, prepared=None):
    """Route the edge attention: the CUDA kernels on the kernel route, the
    plain op otherwise. On the kernel path an input that requires grad
    (with grad enabled) goes through
    :class:`~deepinteract_tpu_torch.ops.cuda_attention.EdgeAttention` (K1
    forward, K2 backward); otherwise K1 runs alone. ``prepared`` is the
    graph's :func:`~deepinteract_tpu_torch.ops.cuda_attention.attention_graph`,
    made once per encode; None makes it here. Returns (h_out, e_out)."""
    if _attention_impl(cfg, q) == "plain":
        return edge_attention(q, k, v, proj_e, nbr_idx, edge_mask, mode=cfg.attention_mode)
    if cfg.attention_mode != "scatter":
        raise ValueError("the edge-attention kernel computes scatter mode only")
    if prepared is None:
        prepared = cuda_attention.attention_graph(nbr_idx, edge_mask)
    args = (q, k, v, proj_e, prepared.nbr_idx, prepared.edge_mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args[:4]):
        return cuda_attention.EdgeAttention.apply(*args, *(prepared.in_edges or (None, None)))
    h_out, e_out, _ = cuda_attention.edge_attention_forward(*args, in_edges=prepared.in_edges)
    return h_out, e_out


class MultiHeadGeometricAttention(nn.Module):
    """Q/K/V + edge projections feeding the fused edge attention. No
    biases: the reference adds one only where a Linear changes sizes."""

    def __init__(self, cfg: GTConfig, update_edge_feats: bool = True):
        super().__init__()
        self.cfg = cfg
        self.update_edge_feats = update_edge_feats
        ch = cfg.hidden
        self.Q = GODense(ch, ch, bias=False)
        self.K = GODense(ch, ch, bias=False)
        self.V = GODense(ch, ch, bias=False)
        self.edge_feats_projection = GODense(ch, ch, bias=False)

    def forward(self, graph: ProteinGraph, node_feats, edge_feats, prepared=None):
        cfg = self.cfg
        h, d = cfg.num_heads, cfg.hidden // cfg.num_heads
        b, n, k = graph.nbr_idx.shape
        q = self.Q(node_feats).reshape(b, n, h, d)
        kk = self.K(node_feats).reshape(b, n, h, d)
        v = self.V(node_feats).reshape(b, n, h, d)
        proj_e = self.edge_feats_projection(edge_feats).reshape(b, n, k, h, d)
        h_out, e_out = _dispatch_attention(cfg, q, kk, v, proj_e, graph.nbr_idx,
                                           graph.edge_mask(), prepared)
        # The kernel returns float32 accumulators; activations stay in the
        # compute dtype.
        h_out = h_out.to(node_feats.dtype).reshape(b, n, cfg.hidden)
        e_out = (e_out.to(node_feats.dtype).reshape(b, n, k, cfg.hidden)
                 if self.update_edge_feats else None)
        return h_out, e_out


class GeometricTransformerLayer(nn.Module):
    """One GT layer: conformation -> norm -> MHA -> O-proj -> residual ->
    norm -> FFN -> residual, updating nodes and (optionally) edges."""

    def __init__(self, cfg: GTConfig, update_edge_feats: bool = True):
        super().__init__()
        self.cfg = cfg
        self.update_edge_feats = update_edge_feats
        ch = cfg.hidden
        self.conformation_module = (PlainEdgeModule(cfg) if cfg.disable_geometric_mode
                                    else ConformationModule(cfg))
        self.norm1_node = FeatureNorm(cfg.norm_type, ch)
        self.norm1_edge = FeatureNorm(cfg.norm_type, ch)
        self.mha = MultiHeadGeometricAttention(cfg, update_edge_feats)
        self.dropout = Dropout(cfg.dropout_rate)
        self.O_node = GODense(ch, ch)
        self.norm2_node = FeatureNorm(cfg.norm_type, ch)
        self.node_mlp = MLP(ch, cfg.dropout_rate)
        if update_edge_feats:
            self.O_edge = GODense(ch, ch)
            self.norm2_edge = FeatureNorm(cfg.norm_type, ch)
            self.edge_mlp = MLP(ch, cfg.dropout_rate)

    def forward(self, graph: ProteinGraph, node_feats, edge_feats, orig_edge_feats,
                prepared=None):
        cfg = self.cfg
        node_mask, edge_mask = graph.node_mask, graph.edge_mask()
        node_in1, edge_in1 = node_feats, edge_feats

        if cfg.disable_geometric_mode:
            edge_feats = self.conformation_module(orig_edge_feats)
        else:
            edge_feats = self.conformation_module(graph, edge_feats, orig_edge_feats)

        node_feats = self.norm1_node(node_feats, node_mask)
        edge_feats = self.norm1_edge(edge_feats, edge_mask)
        node_attn, edge_attn = self.mha(graph, node_feats, edge_feats, prepared)

        node_feats = self.O_node(self.dropout(node_attn))
        if cfg.residual:
            node_feats = node_in1 + node_feats
        node_in2 = node_feats
        node_feats = self.node_mlp(self.norm2_node(node_feats, node_mask))
        if cfg.residual:
            node_feats = node_in2 + node_feats

        if not self.update_edge_feats:
            return node_feats, None

        edge_feats = self.O_edge(self.dropout(edge_attn))
        if cfg.residual:
            edge_feats = edge_in1 + edge_feats
        edge_in2 = edge_feats
        edge_feats = self.edge_mlp(self.norm2_edge(edge_feats, edge_mask))
        if cfg.residual:
            edge_feats = edge_in2 + edge_feats
        return node_feats, edge_feats


class GeometricTransformer(nn.Module):
    """Full GT stack: edge init + (num_layers - 1) node+edge layers + one
    node-only final layer. Expects node features already embedded to
    ``hidden`` channels. Returns (node_feats, edge_feats)."""

    def __init__(self, cfg: GTConfig):
        super().__init__()
        self.cfg = cfg
        self.init_edge_module = (PlainEdgeModule(cfg) if cfg.disable_geometric_mode
                                 else InitEdgeModule(cfg))
        self.layers = [f"gt_layer_{i}" for i in range(max(0, cfg.num_layers - 1))]
        for name in self.layers:
            self.add_module(name, GeometricTransformerLayer(cfg, update_edge_feats=True))
        if cfg.num_layers > 0:
            self.final_gt_layer = GeometricTransformerLayer(cfg, update_edge_feats=False)

    def forward(self, graph: ProteinGraph, node_feats: torch.Tensor):
        cfg = self.cfg
        # Entry cast into the compute dtype (a no-op under float32).
        node_feats = node_feats.to(cfg.dtype)
        orig_edge_feats = graph.edge_feats.to(cfg.dtype)  # raw 28-d
        if cfg.disable_geometric_mode:
            edge_feats = self.init_edge_module(orig_edge_feats)
        else:
            edge_feats = self.init_edge_module(graph, orig_edge_feats)
        # On the kernel route every layer (and its backward) shares one
        # prepared edge index and in-edge CSR.
        prepared = None
        if _attention_impl(cfg, node_feats) == "kernel":
            prepared = cuda_attention.attention_graph(graph.nbr_idx, graph.edge_mask())
        for name in self.layers:
            node_feats, edge_feats = getattr(self, name)(
                graph, node_feats, edge_feats, orig_edge_feats, prepared)
        if cfg.num_layers > 0:
            node_feats, _ = self.final_gt_layer(graph, node_feats, edge_feats, orig_edge_feats,
                                                prepared)
        node_feats = node_feats * graph.node_mask[..., None].to(cfg.dtype)
        return node_feats, edge_feats
