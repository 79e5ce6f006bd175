"""Parity of the port's Geometric Transformer encoder with the JAX one on
carried weights, through the JAX package's jnp attention and through its
Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinteract_tpu.models.geometric_transformer import GeometricTransformer as JaxGT
from deepinteract_tpu.models.geometric_transformer import GTConfig as JaxGTConfig
from deepinteract_tpu.ops.pallas_attention import resolve_attention_impl
from deepinteract_tpu_torch.models.geometric_transformer import GeometricTransformer, GTConfig
from deepinteract_tpu_torch.weights import load_jax_variables
from torch_port_helpers import HEADS, HIDDEN, LIMIT, PAD, complexes, flax_random_apply

TOL = dict(rtol=1e-4, atol=1e-4)


def _run_both(impl="jnp", norm_type="batch", mode="scatter", hidden=HIDDEN, heads=HEADS,
              pad=PAD, seed=0, plain_edges=False):
    shape = dict(hidden=hidden, num_heads=heads, node_count_limit=LIMIT,
                 norm_type=norm_type, attention_mode=mode,
                 disable_geometric_mode=plain_edges)
    jcx, cx = complexes(seed=seed + 10, pad=pad)
    x = np.random.default_rng(seed).standard_normal((1, pad, hidden)).astype(np.float32)
    variables, (ref_nodes, ref_edges) = flax_random_apply(
        JaxGT(JaxGTConfig(dropout_rate=0.0, attention_impl=impl, **shape)),
        jcx.graph1, jnp.asarray(x), seed=seed, train=False)
    port = GeometricTransformer(GTConfig(**shape))
    load_jax_variables(port, variables)
    with torch.no_grad():
        nodes, edges = port.eval()(cx.graph1, torch.from_numpy(x))
    return (nodes, edges), (np.asarray(ref_nodes), np.asarray(ref_edges))


@pytest.mark.parametrize("norm_type,mode,plain_edges", [
    ("batch", "scatter", False), ("layer", "scatter", False), ("batch", "gather", False),
    ("batch", "scatter", True)], ids=["batch", "layer", "gather", "no_geometry"])
def test_encoder_matches_jax_jnp_attention(norm_type, mode, plain_edges):
    """``no_geometry`` is ``disable_geometric_mode`` (PlainEdgeModule)."""
    (nodes, edges), (ref_nodes, ref_edges) = _run_both("jnp", norm_type, mode,
                                                       plain_edges=plain_edges)
    np.testing.assert_allclose(nodes.numpy(), ref_nodes, **TOL)
    np.testing.assert_allclose(edges.numpy(), ref_edges, **TOL)


def test_encoder_matches_jax_pallas_interpret():
    """The JAX package routes tiny models (hidden < 64 or head dim < 16) to
    jnp, so this case takes hidden 64 / 4 heads at a 64-node bucket, where
    forced 'pallas' really runs the kernel (in the interpreter on CPU)."""
    impl, _ = resolve_attention_impl("scatter", "pallas", 64, batch=1, knn=6, hidden=64,
                                     num_heads=4, dtype=jnp.float32, backend="cpu")
    assert impl == "pallas"
    (nodes, edges), (ref_nodes, ref_edges) = _run_both("pallas", hidden=64, heads=4, pad=64,
                                                       seed=1)
    np.testing.assert_allclose(nodes.numpy(), ref_nodes, **TOL)
    np.testing.assert_allclose(edges.numpy(), ref_edges, **TOL)


def test_encoder_refuses_buckets_past_node_count_limit():
    _, cx = complexes(pad=PAD)
    port = GeometricTransformer(GTConfig(hidden=HIDDEN, num_heads=HEADS,
                                         node_count_limit=PAD - 1)).eval()
    with pytest.raises(ValueError, match="node_count_limit"):
        port(cx.graph1, torch.zeros(1, PAD, HIDDEN))
