"""Parity of the port's edge attention (ops/attention.py, ops/cuda_attention.py)
with the JAX package's jnp op and its Pallas kernel (interpret mode).

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against the plain version tested here. On the CPU the wrapper takes the
plain version and must not count a launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinteract_tpu.data import features as F
from deepinteract_tpu.data.synthetic import random_backbone
from deepinteract_tpu.ops.attention import edge_attention as jax_edge_attention
from deepinteract_tpu.ops.pallas_attention import _pallas_forward
from deepinteract_tpu_torch.models.geometric_transformer import GTConfig, _dispatch_attention
from deepinteract_tpu_torch.ops import cuda_attention
from deepinteract_tpu_torch.ops.attention import edge_attention, edge_attention_forward

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _inputs(seed=0, b=2, n=32, k=6, h=2, d=8):
    """kNN graphs over random backbones, random projections, padded tail."""
    rng = np.random.default_rng(seed)
    nbr = np.stack([F.knn_edges(random_backbone(n, rng)[:, 1, :], k)[0] for _ in range(b)])
    q, kk, v = (rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(3))
    pe = rng.standard_normal((b, n, k, h, d)).astype(np.float32)
    mask = np.ones((b, n, k), dtype=bool)
    mask[:, -5:] = False
    return q, kk, v, pe, nbr.astype(np.int32), mask


def _torch(arrays, dtype=torch.float32):
    q, kk, v, pe, nbr, mask = arrays
    f = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    return f(q), f(kk), f(v), f(pe), torch.from_numpy(nbr).long(), torch.from_numpy(mask)


def _as_np(t):
    return t.float().numpy()


@pytest.mark.parametrize("mode", ["scatter", "gather"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_edge_attention_matches_jax(mode, dtype):
    arrays = _inputs()
    q, kk, v, pe, nbr, mask = arrays
    jdt = jnp.dtype(dtype)
    jh, je = jax_edge_attention(*(jnp.asarray(a, jdt) for a in (q, kk, v, pe)),
                                jnp.asarray(nbr), jnp.asarray(mask), mode=mode)
    th, te = edge_attention(*_torch(arrays, getattr(torch, dtype)), mode=mode)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert th.dtype == getattr(torch, dtype) and te.dtype == th.dtype
    np.testing.assert_allclose(_as_np(th), np.asarray(jh, np.float32), **tol)
    np.testing.assert_allclose(_as_np(te), np.asarray(je, np.float32), **tol)


@pytest.mark.parametrize("n", [32, 256])
def test_fused_forward_matches_pallas_interpret(n):
    """(h, e_out, z) against the TPU kernel's own forward, run by the
    Pallas interpreter (n=256 takes its multi-block edge grid)."""
    arrays = _inputs(seed=1, b=1, n=n, k=6, h=2, d=8)
    jh, je, jz = _pallas_forward(*(jnp.asarray(a) for a in arrays), interpret=True)
    th, te, tz = cuda_attention.edge_attention_forward(*_torch(arrays)[:4],
                                                       torch.from_numpy(arrays[4]),
                                                       torch.from_numpy(arrays[5]).float())
    assert th.dtype == torch.float32 and tz.shape == (1, n, 16)
    for ours, ref in ((th, jh), (te, je), (tz, jz)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **F32_TOL)


def test_fused_forward_traps():
    """Padded rows carry w = 0, e_out is masked, and a node with no
    in-edges gets h = 0 (and z = 0)."""
    q, kk, v, pe, nbr, mask = _inputs(seed=2, b=1)
    nbr[nbr == 7] = 8  # node 7 loses every in-edge
    base = _torch((q, kk, v, pe, nbr, mask))
    h, e, z = edge_attention_forward(*base)
    assert torch.all(h[0, 7] == 0) and torch.all(z[0, 7] == 0)
    assert torch.all(e[~base[5]] == 0)
    # Whatever the padded rows hold, real nodes see the same result.
    k2, v2, pe2 = kk.copy(), v.copy(), pe.copy()
    for a in (k2, v2, pe2):
        a[:, -5:] = 1e3
    h2, e2, _ = edge_attention_forward(*_torch((q, k2, v2, pe2, nbr, mask)))
    real = torch.from_numpy(mask[0, :, 0])
    np.testing.assert_array_equal(h2[0, real].numpy(), h[0, real].numpy())
    np.testing.assert_array_equal(e2.numpy(), e.numpy())


def test_wrapper_on_cpu_runs_plain_version_without_counting():
    arrays = _inputs(seed=3)
    args = (*_torch(arrays)[:4], torch.from_numpy(arrays[4]), torch.from_numpy(arrays[5]).float())
    before = cuda_attention.edge_attention_forward.launches
    ours = cuda_attention.edge_attention_forward(*args)
    plain = edge_attention_forward(*args)
    assert cuda_attention.edge_attention_forward.launches == before
    for a, b in zip(ours, plain):
        assert torch.equal(a, b)


def test_wrapper_refuses_grad_on_cuda(monkeypatch):
    """On CUDA tensors the K1 wrapper gives no gradients, so called
    directly on an input that requires grad it refuses (and launches
    nothing) instead of cutting the graph. The GT dispatch routes such an
    input through EdgeAttention (K1 forward, K2 backward: one launch each)
    and a no-grad input straight to K1 (no K2 launch)."""
    monkeypatch.setattr(cuda_attention, "_on_cuda", lambda t: True)
    launched = []
    monkeypatch.setattr(cuda_attention, "_launch", lambda name, device, *args:
                        launched.append(name))
    for kernel in (cuda_attention.edge_attention_forward, cuda_attention.edge_attention_backward):
        monkeypatch.setattr(kernel, "launches", 0)
    arrays = _inputs(seed=4)
    q, kk, v, pe, _, _ = _torch(arrays)
    nbr, mask = torch.from_numpy(arrays[4]), torch.from_numpy(arrays[5]).float()
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="EdgeAttention"):
        cuda_attention.edge_attention_forward(q, kk, v, pe, nbr, mask)
    assert launched == [] and cuda_attention.edge_attention_forward.launches == 0

    cfg = GTConfig(hidden=16, num_heads=2, attention_impl="kernel")
    h, e = _dispatch_attention(cfg, q, kk, v, pe, nbr, mask)
    assert h.grad_fn is not None and type(h.grad_fn).__name__ == "EdgeAttentionBackward"
    assert launched == ["edge_attention_fwd"]
    h.sum().backward()
    assert launched == ["edge_attention_fwd", "edge_attention_bwd"]
    assert cuda_attention.edge_attention_forward.launches == 1
    assert cuda_attention.edge_attention_backward.launches == 1

    with torch.no_grad():
        h, _ = _dispatch_attention(cfg, q, kk, v, pe, nbr, mask)
    assert h.grad_fn is None
    assert launched == ["edge_attention_fwd", "edge_attention_bwd", "edge_attention_fwd"]
    assert cuda_attention.edge_attention_forward.launches == 2
    assert cuda_attention.edge_attention_backward.launches == 1


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "contiguous"])
def test_wrapper_input_checks(bad):
    arrays = _inputs(seed=5, d=8)
    q, kk, v, pe, _, _ = _torch(arrays)
    nbr, mask = torch.from_numpy(arrays[4]), torch.from_numpy(arrays[5]).float()
    if bad == "head_dim":  # one head past the kernels' widest row (MAX_WIDTH)
        d = cuda_attention.MAX_WIDTH + 8
        q, kk, v = (torch.zeros(1, 4, 1, d) for _ in range(3))
        pe = torch.zeros(1, 4, 6, 1, d)
        nbr, mask = nbr[:1, :4] % 4, mask[:1, :4]
    elif bad == "dtype":
        nbr = nbr.long()
    else:
        pe = pe.transpose(3, 4).contiguous().transpose(3, 4)
    with pytest.raises(ValueError):
        cuda_attention._check_inputs(q, kk, v, pe, nbr, mask)


@pytest.mark.parametrize("heads,head_dim", [(4, 24), (2, 64), (1, 128), (4, 6), (16, 96),
                                            (1, 4096)])
def test_wrapper_takes_every_head_dim_up_to_the_width_bound(heads, head_dim):
    """K1 and K2 take any head dim with H*D <= MAX_WIDTH (4096); the
    kernels themselves run in chip_smoke.py."""
    arrays = _inputs(seed=5, d=8)
    nbr, mask = torch.from_numpy(arrays[4]), torch.from_numpy(arrays[5]).float()
    b, n, kk = nbr.shape
    q, k, v = (torch.zeros(b, n, heads, head_dim) for _ in range(3))
    cuda_attention._check_inputs(q, k, v, torch.zeros(b, n, kk, heads, head_dim), nbr, mask)


def test_dispatch_routes_cpu_to_plain_and_refuses_kernel_gather():
    arrays = _inputs(seed=6)
    args = _torch(arrays)
    h, e = _dispatch_attention(GTConfig(hidden=16, num_heads=2), *args)
    ref_h, ref_e = edge_attention(*args)
    assert torch.equal(h, ref_h) and torch.equal(e, ref_e)
    assert cuda_attention.edge_attention_forward.launches == 0
    with pytest.raises(ValueError, match="scatter"):
        _dispatch_attention(GTConfig(hidden=16, num_heads=2, attention_mode="gather",
                                     attention_impl="kernel"), *args)
