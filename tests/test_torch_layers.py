"""Parity of the port's building blocks (models/layers.py) with the flax
modules, on carried weights: MaskedBatchNorm in eval mode, ResBlock with
its one shared norm, MLP, and the 'layer' FeatureNorm with flax's eps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinteract_tpu.models import layers as jax_layers
from deepinteract_tpu_torch.models.layers import MLP, FeatureNorm, LayerNorm, MaskedBatchNorm, ResBlock
from deepinteract_tpu_torch.weights import load_jax_variables
from torch_port_helpers import flax_random_apply

TOL = dict(rtol=1e-5, atol=1e-5)
C = 16


def _x_mask(seed=0, shape=(2, 9, 5)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape + (C,)) * 2 + 1).astype(np.float32)
    mask = np.ones(shape, dtype=bool)
    mask[:, -3:] = False  # padded rows
    return x, mask


def _port(module, variables):
    load_jax_variables(module, variables)
    return module.eval()


def test_masked_batchnorm_eval_uses_running_stats_and_zeroes_pads():
    x, mask = _x_mask()
    variables, ref = flax_random_apply(jax_layers.MaskedBatchNorm(), jnp.asarray(x),
                                       jnp.asarray(mask), use_running_average=True)
    port = _port(MaskedBatchNorm(C), variables)
    assert port.eps == 1e-5
    out = port(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    assert torch.all(out[torch.from_numpy(~mask)] == 0)


def test_resblock_reuses_one_norm_three_times():
    x, mask = _x_mask(seed=1)
    variables, ref = flax_random_apply(jax_layers.ResBlock(C, "batch"), jnp.asarray(x),
                                       jnp.asarray(mask), train=False)
    port = _port(ResBlock(C, "batch"), variables)
    norms = [m for m in port.modules() if isinstance(m, MaskedBatchNorm)]
    assert len(norms) == 1
    out = port(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


def test_mlp_matches_flax():
    x, _ = _x_mask(seed=2)
    variables, ref = flax_random_apply(jax_layers.MLP(C, 0.0), jnp.asarray(x), train=False)
    out = _port(MLP(C), variables)(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("norm_type", ["batch", "layer"])
def test_feature_norm_matches_flax(norm_type):
    x, mask = _x_mask(seed=3)
    variables, ref = flax_random_apply(jax_layers.FeatureNorm(norm_type), jnp.asarray(x),
                                       jnp.asarray(mask), train=False)
    port = _port(FeatureNorm(norm_type, C), variables)
    if norm_type == "layer":
        assert isinstance(port, LayerNorm) and port.eps == 1e-6  # flax's, not torch's 1e-5
    out = port(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
