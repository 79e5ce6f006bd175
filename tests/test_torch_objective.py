"""The port's objective and optimizer (training/objective.py,
training/optim.py) against the JAX package's: the two cross entropies with
and without class weights, and the optax chain (global-norm clip, AdamW,
cosine warm restarts, gradient accumulation, frozen prefixes) fed the same
gradient stream."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepinteract_tpu.training import objective as jax_objective
from deepinteract_tpu.training.optim import OptimConfig as JaxOptimConfig
from deepinteract_tpu.training.optim import cosine_warm_restarts as jax_schedule
from deepinteract_tpu.training.optim import make_optimizer
from deepinteract_tpu_torch.training import objective
from deepinteract_tpu_torch.training.optim import OptimConfig, Optimizer, cosine_warm_restarts

LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
PARAM_TOL = dict(rtol=1e-6, atol=1e-6)


def _logits_targets(seed=0, b=2, l1=7, l2=5):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, l1, l2, 2)) * 3).astype(np.float32)
    contact = (rng.random((b, l1, l2)) < 0.3).astype(np.int32)
    mask = np.ones((b, l1, l2), dtype=bool)
    mask[0, -2:] = False
    mask[1, :, -1] = False
    return logits, contact, mask


@pytest.mark.parametrize("weight_classes", [False, True])
def test_contact_loss_matches_jax(weight_classes):
    logits, contact, mask = _logits_targets()
    ref = jax_objective.contact_loss(jnp.asarray(logits), jnp.asarray(contact),
                                     jnp.asarray(mask), weight_classes)
    ours = objective.contact_loss(torch.from_numpy(logits), torch.from_numpy(contact).long(),
                                  torch.from_numpy(mask), weight_classes)
    np.testing.assert_allclose(ours.item(), float(ref), **LOSS_TOL)


@pytest.mark.parametrize("weight_classes", [False, True])
def test_example_gather_loss_matches_jax(weight_classes):
    logits, contact, _ = _logits_targets(seed=1)
    rng = np.random.default_rng(2)
    b, l1, l2 = contact.shape
    m = 12
    ii, jj = rng.integers(0, l1, (b, m)), rng.integers(0, l2, (b, m))
    labels = contact[np.arange(b)[:, None], ii, jj]
    examples = np.stack([ii, jj, labels], -1).astype(np.int32)
    example_mask = rng.random((b, m)) < 0.8
    ref = jax_objective.example_gather_loss(jnp.asarray(logits), jnp.asarray(examples),
                                            jnp.asarray(example_mask), weight_classes)
    ours = objective.example_gather_loss(torch.from_numpy(logits), torch.from_numpy(examples),
                                         torch.from_numpy(example_mask), weight_classes)
    np.testing.assert_allclose(ours.item(), float(ref), **LOSS_TOL)


def test_downsample_examples_keeps_positives_and_thins_negatives():
    rng = np.random.default_rng(3)
    labels = (rng.random((2, 400)) < 0.1).astype(np.int64)
    examples = torch.from_numpy(np.stack([np.zeros_like(labels)] * 2 + [labels], -1))
    mask = torch.ones(2, 400, dtype=torch.bool)
    mask[1, 300:] = False
    gen = torch.Generator().manual_seed(0)
    keep = objective.downsample_examples(examples, mask, pn_ratio=0.5, generator=gen)
    pos = (examples[..., 2] == 1) & mask
    assert torch.equal(keep & pos, pos) and not torch.any(keep & ~mask)
    neg_kept = (keep & ~pos).sum(-1).float()
    expected = pos.sum(-1).float() / 0.5  # num_pos / pn_ratio
    assert torch.all((neg_kept - expected).abs() < 0.35 * expected + 5)
    again = objective.downsample_examples(examples, mask, 0.5, torch.Generator().manual_seed(0))
    assert torch.equal(keep, again)


SHAPES = {"gnn": {"w": (3, 4), "b": (4,)}, "decoder": {"k": (5,)}}
# 5 epochs of 3 steps, restarts every 2 epochs: cycles start at 0, 6, 12.
SCHEDULE = dict(lr=1e-2, weight_decay=1e-2, grad_clip_norm=0.5, t0_epochs=2,
                steps_per_epoch=3, num_epochs=5)


def test_schedule_matches_optax_over_restarts():
    cfg = SCHEDULE
    ref = jax_schedule(JaxOptimConfig(**cfg))
    ours = cosine_warm_restarts(OptimConfig(**cfg))
    for step in range(20):
        np.testing.assert_allclose(cfg["lr"] * ours(step), float(ref(step)), rtol=1e-6)
    assert ours(0) == 1.0 and ours(6) == 1.0 and ours(12) == 1.0


@pytest.mark.parametrize("accumulate_steps,frozen", [(1, ()), (2, ()), (1, ("decoder",))],
                         ids=["plain", "accumulate_2", "frozen_decoder"])
def test_optimizer_matches_optax(accumulate_steps, frozen):
    """25 steps of one numpy gradient stream (some above the clip norm,
    some below) through optax make_optimizer and the port's Optimizer."""
    rng = np.random.default_rng(4)
    params = {top: {name: rng.standard_normal(shape).astype(np.float32)
                    for name, shape in leaves.items()} for top, leaves in SHAPES.items()}
    stream = [{top: {name: (rng.standard_normal(shape) * (0.05 if i % 3 else 1.0))
                     .astype(np.float32) for name, shape in leaves.items()}
               for top, leaves in SHAPES.items()} for i in range(25)]

    cfg = dict(SCHEDULE, accumulate_steps=accumulate_steps)
    tx = make_optimizer(JaxOptimConfig(**cfg), frozen_prefixes=frozen)
    jparams = {t: {n: jnp.asarray(a) for n, a in leaves.items()} for t, leaves in params.items()}
    opt_state = tx.init(jparams)

    module = torch.nn.Module()
    for top, leaves in params.items():
        module.add_module(top, torch.nn.ParameterDict(
            {n: torch.nn.Parameter(torch.from_numpy(a.copy())) for n, a in leaves.items()}))
    opt = Optimizer(module.named_parameters(), OptimConfig(**cfg), frozen_prefixes=frozen)

    moved = 0
    for grads in stream:
        updates, opt_state = tx.update(
            {t: {n: jnp.asarray(a) for n, a in leaves.items()} for t, leaves in grads.items()},
            opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, p in module.named_parameters():
            top, leaf = name.split(".")
            p.grad = torch.from_numpy(grads[top][leaf])
        moved += opt.update()
        for name, p in module.named_parameters():
            top, leaf = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[top][leaf]),
                                       err_msg=name, **PARAM_TOL)
    assert moved == 25 // accumulate_steps
    if frozen:
        np.testing.assert_array_equal(module.decoder.k.detach().numpy(), params["decoder"]["k"])
    assert opt.schedule.last_epoch == moved
