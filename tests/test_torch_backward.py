"""Parity of K2's plain version (``ops/attention.edge_attention_backward``)
with the JAX package's gradients: ``_bwd_kernel`` itself, run by the Pallas
interpreter through ``edge_attention_pallas``'s custom VJP, and jax's
autodiff of the jnp op; and of ``cuda_attention.EdgeAttention`` on CPU
tensors with torch's autograd of the plain forward.

The CUDA kernel runs only on the card: ``chip_smoke.py`` holds it against
the plain version tested here (f32 1e-4, bf16 3e-2, NaN-prefilled outputs,
an orphan node, ``de=None``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinteract_tpu.ops.attention import edge_attention as jax_edge_attention
from deepinteract_tpu.ops.pallas_attention import edge_attention_pallas
from deepinteract_tpu_torch.ops import attention as plain
from deepinteract_tpu_torch.ops import cuda_attention
from test_pallas_attention import _raw_inputs

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)  # the JAX package's gradient bar
FUNCTION_TOL = dict(rtol=1e-5, atol=1e-5)


def _torch(arrays, dtype=torch.float32):
    q, k, v, pe, nbr, mask = arrays
    f = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    return (f(q), f(k), f(v), f(pe), torch.from_numpy(nbr).to(torch.int32),
            torch.from_numpy(mask).float())


def _cotangents(shape_h, shape_e, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_h).astype(np.float32),
            rng.standard_normal(shape_e).astype(np.float32))


@pytest.mark.parametrize("with_de", [True, False], ids=["de", "de_none"])
@pytest.mark.parametrize("reference", ["pallas_interpret", "jnp"])
def test_backward_matches_jax_gradients(rng, reference, with_de):
    """The inputs of tests/test_pallas_attention.py::test_gradient_parity;
    h_out's cotangent always non-zero, e_out's non-zero or absent."""
    arrays = _raw_inputs(rng, b=1, n=32, k=6, h=2, d=8)
    q, k, v, pe, nbr, mask = arrays
    dh, de = _cotangents(q.shape, pe.shape, seed=1)
    if not with_de:
        de = np.zeros_like(de)

    def forward(q_, k_, v_, pe_):
        if reference == "jnp":
            return jax_edge_attention(q_, k_, v_, pe_, jnp.asarray(nbr), jnp.asarray(mask),
                                      mode="scatter")
        return edge_attention_pallas(q_, k_, v_, pe_, jnp.asarray(nbr), jnp.asarray(mask), True)

    _, vjp = jax.vjp(forward, *(jnp.asarray(a) for a in (q, k, v, pe)))
    ref = vjp((jnp.asarray(dh), jnp.asarray(de)))

    args = _torch(arrays)
    h, _, z = plain.edge_attention_forward(*args)
    ours = plain.edge_attention_backward(*args, h, z, torch.from_numpy(dh),
                                         torch.from_numpy(de) if with_de else None)
    for name, a, b in zip(("dq", "dk", "dv", "dpe"), ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)


def test_backward_traps():
    """A node without in-edges gets dq = 0 (its 1 / (z + eps) = 1e6 is
    never read), masked edges get dpe = 0, bf16 inputs give bf16 gradients
    that agree with the float32 computation."""
    rng = np.random.default_rng(3)
    q, k, v, pe, nbr, mask = _raw_inputs(rng, b=1, n=32, k=6, h=2, d=8)
    nbr[nbr == 7] = 8  # node 7 loses every in-edge
    args = _torch((q, k, v, pe, nbr, mask))
    h, _, z = plain.edge_attention_forward(*args)
    assert torch.all(z[0, 7] == 0)
    dh, de = (torch.from_numpy(a) for a in _cotangents(q.shape, pe.shape, seed=4))
    dq, dk, dv, dpe = plain.edge_attention_backward(*args, h, z, dh, de)
    assert torch.all(dq[0, 7] == 0)
    assert torch.all(dpe[~torch.from_numpy(mask)] == 0)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv, dpe))

    bf = _torch((q, k, v, pe, nbr, mask), torch.bfloat16)
    hb, _, zb = plain.edge_attention_forward(*bf)
    grads16 = plain.edge_attention_backward(*bf, hb, zb, dh, de.to(torch.bfloat16))
    ref32 = plain.edge_attention_backward(*(t.float() if t.is_floating_point() else t
                                            for t in bf), hb, zb, dh,
                                          de.to(torch.bfloat16).float())
    for a, b in zip(grads16, ref32):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b.to(torch.bfloat16).float().numpy(),
                                   rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("use_e_out", [True, False])
def test_edge_attention_function_matches_autograd_on_cpu(monkeypatch, use_e_out):
    """EdgeAttention on CPU tensors (the plain forward and the explicit
    backward) against torch's autograd of the plain forward. When e_out
    takes no part in the loss (the final GT layer), the backward sees
    de=None rather than a tensor of zeros."""
    seen = []
    original = cuda_attention.edge_attention_backward

    def recording(*args, **kwargs):
        seen.append(args[9])
        return original(*args, **kwargs)

    monkeypatch.setattr(cuda_attention, "edge_attention_backward", recording)
    arrays = _raw_inputs(np.random.default_rng(5), b=2, n=32, k=6, h=2, d=8)
    dh, de = (torch.from_numpy(a) for a in _cotangents(arrays[0].shape, arrays[3].shape, 6))
    grads = []
    for route in ("function", "autograd"):
        q, k, v, pe, nbr, mask = _torch(arrays)
        leaves = [t.requires_grad_(True) for t in (q, k, v, pe)]
        if route == "function":
            h, e = cuda_attention.EdgeAttention.apply(*leaves, nbr, mask)
        else:
            h, e, _ = plain.edge_attention_forward(*leaves, nbr, mask)
        loss = (h * dh).sum() + ((e * de).sum() if use_e_out else 0.0)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **FUNCTION_TOL)
    assert len(seen) == 1 and (seen[0] is not None) == use_e_out
    assert original.launches == 0
