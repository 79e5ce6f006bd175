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
kernel K1 computes (``ops/cuda_attention.py``), with the softmax
denominator ``z`` as a third output; :func:`edge_attention_backward` is
the explicit gradient of that forward that the CUDA kernel K2 computes.
Each is its kernel's plain version, the CPU path, and what the kernel is
held against on the card.
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
    z_out = z[..., None].expand(b, n, h, d).reshape(b, n, h * d).contiguous()
    return h_out, e_out, z_out


def _inside_clip(x: torch.Tensor) -> torch.Tensor:
    """Where a clip to +-5 passes its gradient: strictly inside, as the TPU
    kernel's ``(x > -C) & (x < C)`` (``torch.clamp``'s autograd also passes
    it at the bounds)."""
    return (x > -CLIP) & (x < CLIP)


def edge_attention_backward(q, k, v, proj_e, nbr_idx, edge_mask, h, z, dh, de=None):
    """Gradient of :func:`edge_attention_forward`'s (h_out, e_out) with
    respect to (q, k, v, proj_e), from the forward's residuals.

    The math of ``_bwd_kernel`` in
    ``deepinteract_tpu/ops/pallas_attention.py`` written out, not autograd
    of the forward: the per-edge scores and weights are recomputed from
    q/k/v/proj_e and the saved h [B, N, H, D] and z [B, N, H*D] (float32),
    then with dst = nbr_idx[e] and src the row owner of e::

      dnum = dh * 1 / (z + eps);  dZ = -sum_{d in head} h * dnum    (per dst)
      dw   = sum_{d in head} dnum[dst] * v[src] + dZ[dst];  dl = dw * w
      ds   = dl * 1{|sum_pre| < 5} (broadcast over D) + de * mask
      dpe  = ds * c;  da = ds * pe * 1{|a| < 5} / sqrt(D)
      dq[dst] += da * k[src];  dk[src] += da * q[dst];  dv[src] += w * dnum[dst]

    dh [B, N, H, D] is h_out's cotangent (float32); de [B, N, K, H, D] is
    e_out's, or None for a zero edge cotangent. Sums run in float32; the
    four gradients come back in the input dtype, as ``_bwd`` returns them.
    A node without in-edges has z = 0 and a finite 1 / eps, but no edge
    reads its dnum, so it contributes exactly nothing."""
    b, n, hh, d = q.shape
    f32 = STATS_DTYPE
    inv_sqrt_d = 1.0 / math.sqrt(d)
    q_dst = _gather_nodes(q, nbr_idx).to(f32)          # [B,N,K,H,D]
    k_src = k[:, :, None].to(f32)
    v_src = v[:, :, None].to(f32)
    pe = proj_e.to(f32)
    mask = edge_mask.to(f32)
    a = k_src * q_dst * inv_sqrt_d
    c = torch.clamp(a, -CLIP, CLIP)
    sum_pre = (c * pe).sum(-1)                          # [B,N,K,H]
    w = torch.exp(torch.clamp(sum_pre, -CLIP, CLIP)) * mask[..., None]

    dnum = dh.to(f32) * (1.0 / (z.reshape(b, n, hh, d) + EPS))  # [B,N,H,D]
    dz = -(h.to(f32) * dnum).sum(-1)                    # [B,N,H]
    dnum_dst = _gather_nodes(dnum, nbr_idx)
    dw = (dnum_dst * v_src).sum(-1) + _gather_nodes(dz, nbr_idx)
    dsum = torch.where(_inside_clip(sum_pre), dw * w, 0.0)
    ds = dsum[..., None]
    if de is not None:
        ds = ds + de.to(f32) * mask[..., None, None]
    dpe = ds * c
    da = torch.where(_inside_clip(a), ds * pe, 0.0) * inv_sqrt_d
    dq = _scatter_to_dst(da * k_src, nbr_idx)
    dk = (da * q_dst).sum(2)
    dv = (w[..., None] * dnum_dst).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dpe.to(proj_e.dtype)
