"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages see the same inputs and the same weights: complexes come
from one numpy seed through each package's own generator, and weights are
one random JAX variables tree (fan-in-scaled, as
``training.import_torch.synthesize_reference_state_dict`` makes them)
carried into the port by ``weights.load_jax_variables``. The size is the
golden fixture's: hidden 16, 2 heads, kNN 6, 26x22 residues (padded to
32 so that masks matter), 2 decoder chunks of 16 channels.
"""

from __future__ import annotations

from collections.abc import Mapping

import jax
import numpy as np
import torch

from deepinteract_tpu.data.graph import stack_complexes as jax_stack
from deepinteract_tpu.data.synthetic import random_complex as jax_random_complex
from deepinteract_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from deepinteract_tpu.models.geometric_transformer import GTConfig as JaxGTConfig
from deepinteract_tpu.models.model import DeepInteract as JaxDeepInteract
from deepinteract_tpu.models.model import ModelConfig as JaxModelConfig
from deepinteract_tpu_torch.data.graph import stack_complexes
from deepinteract_tpu_torch.data.synthetic import random_complex
from deepinteract_tpu_torch.models.decoder import DecoderConfig
from deepinteract_tpu_torch.models.geometric_transformer import GTConfig
from deepinteract_tpu_torch.models.model import ModelConfig

HIDDEN, HEADS, KNN, N1, N2, PAD, LIMIT, CHUNKS = 16, 2, 6, 26, 22, 32, 64, 2

# The suite runs in several worker processes at once, and each one imports
# this module while collecting. torch's default of one intra-op thread per
# core then oversubscribes the machine: its spinning threads slow every
# other worker and the subprocesses their tests start. At these tensor
# sizes one thread is as fast.
torch.set_num_threads(1)


def jax_cfg(attention_impl: str = "jnp", norm_type: str = "batch",
            attention_mode: str = "scatter", limit: int = LIMIT,
            **decoder) -> JaxModelConfig:
    """The tiny JAX config. The decoder defaults to the plain masked
    formulation (``depad_stats=False``), which is the one the port
    implements; the JAX package's de-padded statistics agree with it only
    up to float association."""
    return JaxModelConfig(
        gnn=JaxGTConfig(hidden=HIDDEN, num_heads=HEADS, dropout_rate=0.0,
                        node_count_limit=limit, attention_impl=attention_impl,
                        norm_type=norm_type, attention_mode=attention_mode),
        decoder=JaxDecoderConfig(num_chunks=CHUNKS, num_channels=HIDDEN,
                                 **{"depad_stats": False, **decoder}))


def port_cfg(attention_impl: str = "auto", norm_type: str = "batch",
             attention_mode: str = "scatter", limit: int = LIMIT, **kw) -> ModelConfig:
    return ModelConfig(
        gnn=GTConfig(hidden=HIDDEN, num_heads=HEADS, node_count_limit=limit,
                     attention_impl=attention_impl, norm_type=norm_type,
                     attention_mode=attention_mode),
        decoder=DecoderConfig(num_chunks=CHUNKS, num_channels=HIDDEN), **kw)


def complexes(seed: int = 3, pad: int = PAD):
    """(JAX batch, port batch) of one synthetic complex from one seed."""
    jcx = jax_stack([jax_random_complex(N1, N2, np.random.default_rng(seed),
                                        n_pad1=pad, n_pad2=pad, knn=KNN)])
    cx = stack_complexes([random_complex(N1, N2, np.random.default_rng(seed),
                                         n_pad1=pad, n_pad2=pad, knn=KNN)])
    return jcx, cx


def _iter_leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _iter_leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def random_like(shapes, seed: int = 0) -> dict:
    """Random arrays in the structure of an abstract flax variables tree
    (``jax.eval_shape`` of an init: no compile): fan-in-scaled normal
    kernels (the scanned chunk axis is not fan-in), normal vectors, and
    positive running variances."""
    rng = np.random.default_rng(seed)
    out: dict = {}
    for path, leaf in _iter_leaves(shapes):
        value = rng.standard_normal(leaf.shape).astype(np.float32)
        if len(leaf.shape) >= 2:
            fan = leaf.shape[1:-1] if "chunks" in path else leaf.shape[:-1]
            value /= np.sqrt(max(int(np.prod(fan)), 1))
        if path[-1] == "var":
            value = np.abs(value) + 0.5
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def flax_random_apply(module, *args, seed: int = 0, **kwargs):
    """(random variables, module.apply(variables, *args)) for a flax module."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    variables = random_like(shapes, seed)
    return variables, module.apply(variables, *args, **kwargs)


def random_variables(jcfg: JaxModelConfig, jcx, seed: int = 0) -> dict:
    """Random variables of the whole JAX model for one complex batch."""
    model = JaxDeepInteract(jcfg)
    return random_like(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jcx.graph1, jcx.graph2, train=False)), seed)
