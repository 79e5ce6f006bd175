"""Edge-gated multi-head graph attention on the dense [N, K] edge layout.

Port of ``deepinteract_tpu/ops/attention.py``: the reference's DGL
edge-softmax pipeline ``K.Q -> scale/clip(+-5) -> *proj_e ->
exp(clip(+-5)) -> sum into destination`` as plain PyTorch.

* ``scatter`` mode reproduces the reference exactly: edge (i, k) carries
  K[i] . Q[nbr_idx[i,k]], and each node normalizes over its *incoming*
  edges (reverse kNN, variable degree) through an ``index_add_``.
* ``gather`` mode is the opt-in approximation: node i attends over its own
  K out-edges, a masked reduction over axis K. It equals ``scatter`` only
  on symmetric kNN graphs.

:func:`edge_attention_forward` is the fused scatter forward that the CUDA
kernel computes (``ops/cuda_attention.py``), with the softmax denominator
``z`` as a third output; it is the kernel's plain version, the CPU path,
and what the kernel is held against on the card.
"""

from __future__ import annotations

import math

import torch

from deepinteract_tpu_torch.models.policy import STATS_DTYPE

CLIP = 5.0
EPS = 1e-6


def _gather_nodes(x: torch.Tensor, nbr_idx: torch.Tensor) -> torch.Tensor:
    """x: [B, N, ...], nbr_idx: [B, N, K] -> [B, N, K, ...]."""
    batch = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[batch, nbr_idx]


def _scatter_to_dst(x: torch.Tensor, nbr_idx: torch.Tensor) -> torch.Tensor:
    """Sum edge quantities [B, N, K, ...] into their destination nodes:
    [B, N, ...]. Accumulates in x's dtype."""
    b, n, kk = nbr_idx.shape
    rest = x.shape[3:]
    seg = (nbr_idx + n * torch.arange(b, device=x.device)[:, None, None]).reshape(-1)
    out = torch.zeros((b * n, *rest), dtype=x.dtype, device=x.device)
    out.index_add_(0, seg, x.reshape(b * n * kk, *rest))
    return out.reshape(b, n, *rest)


def edge_scores(q, k, proj_e, nbr_idx, mode: str = "scatter") -> torch.Tensor:
    """Per-edge gated score vectors [B, N, K, H, D] in the input dtype:
    clip(K_src * Q_recv / sqrt(D), +-5) * proj_e. The receiver holds Q: the
    edge destination in ``scatter`` mode, the row owner in ``gather``."""
    if mode == "scatter":
        raw = k[:, :, None] * _gather_nodes(q, nbr_idx)
    elif mode == "gather":
        raw = q[:, :, None] * _gather_nodes(k, nbr_idx)
    else:
        raise ValueError(f"unknown attention mode: {mode}")
    sqrt_d = torch.tensor(math.sqrt(q.shape[-1]), dtype=raw.dtype)
    return torch.clamp(raw / sqrt_d, -CLIP, CLIP) * proj_e


def edge_attention(q, k, v, proj_e, nbr_idx, edge_mask, mode: str = "scatter"):
    """Full edge-gated attention.

    Args:
      q, k, v:    [B, N, H, D] head-split node projections
      proj_e:     [B, N, K, H, D] head-split edge projections
      nbr_idx:    [B, N, K] destination of edge (i, k)
      edge_mask:  [B, N, K] validity of edges
      mode:       'scatter' (reference-exact) or 'gather' (approximation)

    Returns:
      h_out: [B, N, H, D] attention-weighted values, in q's dtype
      e_out: [B, N, K, H, D] gated score vectors (the edge update)
    """
    score_vec = edge_scores(q, k, proj_e, nbr_idx, mode=mode)
    # Softmax accumulators in float32 whatever the compute dtype; values
    # may stay bf16, the weighted sums promote to float32.
    logits = torch.clamp(score_vec.to(STATS_DTYPE).sum(-1), -CLIP, CLIP)
    weights = torch.exp(logits) * edge_mask[..., None].to(STATS_DTYPE)  # [B,N,K,H]
    if mode == "gather":
        v_nbr = _gather_nodes(v, nbr_idx).to(STATS_DTYPE)
        wv = torch.einsum("bnkh,bnkhd->bnhd", weights, v_nbr)
        z = weights.sum(2)
    else:
        wv = _scatter_to_dst(weights[..., None] * v[:, :, None].to(STATS_DTYPE), nbr_idx)
        z = _scatter_to_dst(weights, nbr_idx)
    h_out = (wv / (z[..., None] + EPS)).to(q.dtype)
    e_out = score_vec * edge_mask[..., None, None].to(score_vec.dtype)
    return h_out, e_out


def edge_attention_forward(q, k, v, proj_e, nbr_idx, edge_mask):
    """Fused scatter-mode forward with its softmax denominator.

    The function of ``_pallas_forward`` in
    ``deepinteract_tpu/ops/pallas_attention.py``, at its boundary layout:
    q/k/v [B, N, H, D] and proj_e [B, N, K, H, D] in float32 or bfloat16,
    nbr_idx [B, N, K], edge_mask [B, N, K]. Scores are computed in float32
    from the inputs as given (exact for bf16 inputs). Returns
      h_out [B, N, H, D] float32, e_out [B, N, K, H, D] in the input dtype,
      z [B, N, H*D] float32 (per-head denominators broadcast over D).
    """
    b, n, h, d = q.shape
    f32 = STATS_DTYPE
    q_dst = _gather_nodes(q, nbr_idx).to(f32)          # [B,N,K,H,D]
    k_src = k[:, :, None].to(f32)
    scaled = torch.clamp(k_src * q_dst * (1.0 / math.sqrt(d)), -CLIP, CLIP) * proj_e.to(f32)
    mask = edge_mask.to(f32)
    logits = torch.clamp(scaled.sum(-1), -CLIP, CLIP)  # [B,N,K,H]
    w = torch.exp(logits) * mask[..., None]
    wv = _scatter_to_dst(w[..., None] * v[:, :, None].to(f32), nbr_idx)
    z = _scatter_to_dst(w, nbr_idx)                     # [B,N,H]
    h_out = wv / (z[..., None] + EPS)
    e_out = (scaled * mask[..., None, None]).to(q.dtype)
    z_out = z[..., None].expand(b, n, h, d).reshape(b, n, h * d)
    return h_out, e_out, z_out
