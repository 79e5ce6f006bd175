"""Train mode of the port's building blocks (models/layers.py) against the
flax modules on carried weights: MaskedBatchNorm's batch statistics,
running-statistics update and gradients, ResBlock's one norm updated three
times, and the explicit-generator Dropout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinteract_tpu.models import layers as jax_layers
from deepinteract_tpu_torch.models.layers import (Dropout, DropoutKey, MaskedBatchNorm, ResBlock,
                                                  dropout_rng)
from deepinteract_tpu_torch.weights import load_jax_variables
from torch_port_helpers import random_like

TOL = dict(rtol=1e-5, atol=1e-5)
C = 16


def _x_mask(seed=0, shape=(2, 9, 5)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape + (C,)) * 2 + 1).astype(np.float32)
    mask = np.ones(shape, dtype=bool)
    mask[:, -3:] = False  # padded rows
    return x, mask


def _flax_train(module, x, mask, seed, **kwargs):
    """(variables, output, updated batch_stats) of a train-mode flax apply
    on random variables."""
    args = (jnp.asarray(x), jnp.asarray(mask))
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    variables = random_like(shapes, seed)
    out, mutated = module.apply(variables, *args, mutable=["batch_stats"], **kwargs)
    return variables, out, mutated["batch_stats"]


def test_masked_batchnorm_train_matches_flax():
    x, mask = _x_mask()
    variables, ref, stats = _flax_train(jax_layers.MaskedBatchNorm(), x, mask, seed=1,
                                        use_running_average=False)
    port = MaskedBatchNorm(C)
    load_jax_variables(port, variables)
    out = port.train()(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(stats["mean"]), **TOL)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(stats["var"]), **TOL)
    assert torch.all(out[torch.from_numpy(~mask)] == 0)


def test_masked_batchnorm_train_gradients_flow_through_batch_statistics():
    x, mask = _x_mask(seed=2)
    module = jax_layers.MaskedBatchNorm()
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                jnp.asarray(mask), use_running_average=False))
    variables = random_like(shapes, 3)
    w = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def loss(params, x_):
        y, _ = module.apply({"params": params, "batch_stats": variables["batch_stats"]}, x_,
                            jnp.asarray(mask), use_running_average=False,
                            mutable=["batch_stats"])
        return jnp.sum(y * w)

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    port = MaskedBatchNorm(C)
    load_jax_variables(port, variables)
    xt = torch.from_numpy(x).requires_grad_(True)
    (port.train()(xt, torch.from_numpy(mask)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port.weight.grad.numpy(), np.asarray(g_params["scale"]), **TOL)
    np.testing.assert_allclose(port.bias.grad.numpy(), np.asarray(g_params["bias"]), **TOL)
    assert port.running_mean.grad_fn is None and port.running_var.grad_fn is None


def test_masked_batchnorm_train_count_is_n_valid_times_channels():
    """The JAX package's count (ROADMAP queue 3), reproduced on purpose:
    the per-channel sums are divided by n_valid * C, not n_valid, so a
    train-mode output is not zero-mean per channel (torch BatchNorm1d's
    would be)."""
    x, mask = _x_mask(seed=5)
    port = MaskedBatchNorm(C).train()
    y = port(torch.from_numpy(x), torch.from_numpy(mask))
    valid = torch.from_numpy(x[mask])                       # [n_valid, C]
    n_valid = valid.shape[0]
    mean = valid.sum(0) / (n_valid * C)
    var = ((valid - mean) ** 2).sum(0) / (n_valid * C)
    expected = (valid - mean) / torch.sqrt(var + 1e-5)
    np.testing.assert_allclose(y[torch.from_numpy(mask)].detach().numpy(), expected.numpy(),
                               **TOL)
    unbiased = var * (n_valid * C) / (n_valid * C - 1)
    np.testing.assert_allclose(port.running_var.numpy(), (0.9 + 0.1 * unbiased).numpy(), **TOL)
    bn = torch.nn.BatchNorm1d(C).train()
    assert not torch.allclose(y[torch.from_numpy(mask)], bn(valid), atol=1e-2)


def test_resblock_train_updates_its_one_norm_three_times():
    x, mask = _x_mask(seed=6)
    variables, ref, stats = _flax_train(jax_layers.ResBlock(C, "batch"), x, mask, seed=7,
                                        train=True)
    port = ResBlock(C, "batch")
    load_jax_variables(port, variables)
    out = port.train()(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    norm = port.shared_norm
    flax_stats = stats["shared_norm"]["MaskedBatchNorm_0"]
    np.testing.assert_allclose(norm.running_mean.numpy(), np.asarray(flax_stats["mean"]), **TOL)
    np.testing.assert_allclose(norm.running_var.numpy(), np.asarray(flax_stats["var"]), **TOL)


def test_dropout_draws_from_the_explicit_generator():
    """Train-mode dropout draws from the key ``dropout_rng`` sets (a
    ``DropoutKey`` of seed and step), never from torch's generators: the
    same key gives the same mask, another seed another."""
    x = torch.ones(64, 32)
    drop = Dropout(0.25)
    assert torch.equal(drop.eval()(x), x) and torch.equal(Dropout(0.0).train()(x), x)
    drop.train()
    with pytest.raises(RuntimeError, match="dropout_rng"):
        drop(x)

    def key(seed):
        return DropoutKey(torch.tensor(seed), torch.tensor(0))

    with dropout_rng(drop, key(3)):
        a = drop(x)
    with dropout_rng(drop, key(3)):
        b = drop(x)
    with dropout_rng(drop, key(4)):
        c = drop(x)
    assert drop.key is None  # set only inside the block
    assert torch.equal(a, b) and not torch.equal(a, c)
    # flax's rule: kept elements are scaled by 1 / (1 - p), the rest are 0.
    assert torch.equal(torch.unique(a), torch.tensor([0.0, 1.0 / 0.75]))
    assert 0.65 < (a > 0).float().mean().item() < 0.85
