"""The port's step bodies against the JAX package's ``multi_train_step``
and ``multi_eval_step`` (training/steps.py): K = 3 stacked batches with
the guard on and the middle batch poisoned, with and without gradient
accumulation; the eval twin; the port's K-step run against K eager
``train_step`` calls (bitwise, dropout on); the on-device schedule and
clip; in-place state loads (the addresses a captured step graph keeps)
and checkpoints of the earlier optimizer layout. The card-only replay
checks are in ``test_torch_step_graphs.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepinteract_tpu.models.model import DeepInteract as JaxDeepInteract
from deepinteract_tpu.training.optim import OptimConfig as JaxOptimConfig
from deepinteract_tpu.training.optim import cosine_warm_restarts as jax_schedule
from deepinteract_tpu.training.optim import make_optimizer
from deepinteract_tpu.training.steps import TrainState as JaxTrainState
from deepinteract_tpu.training.steps import loss_and_updates as jax_loss_and_updates
from deepinteract_tpu.training.steps import multi_eval_step as jax_multi_eval_step
from deepinteract_tpu.training.steps import multi_train_step as jax_multi_train_step
from deepinteract_tpu.training.steps import stack_microbatches
from deepinteract_tpu_torch.models.layers import DropoutKey, dropout_rng
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.training.objective import contact_loss
from deepinteract_tpu_torch.training.optim import OptimConfig, cosine_warm_restarts_lr
from deepinteract_tpu_torch.training.steps import (create_train_state, multi_eval_step,
                                                   multi_train_step, train_step)
from deepinteract_tpu_torch.weights import load_jax_variables
from torch_port_helpers import complexes, jax_cfg, port_cfg, random_variables

K = 3
POISONED = 1  # the middle batch of the run
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
OPTIM = dict(lr=1e-2, steps_per_epoch=3, num_epochs=2, t0_epochs=1)
# Seeds of the 1e-7 weight moves that measure the reference's own spread.
# The spread of a parameter that AdamW moved on a noise-level gradient is
# a draw between 0 and 2 * lr, so two moves under-estimated it (ROADMAP
# queue 3): eight sample it.
MOVED_SEEDS = tuple(range(1, 9))


def _shallow(cfg):
    return dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn, num_layers=1),
                               decoder=dataclasses.replace(cfg.decoder, num_chunks=1))


def _poison(batch, nan):
    """The batch with NaN node features in chain 1 (either package)."""
    g = dataclasses.replace(batch.graph1, node_feats=nan(batch.graph1.node_feats))
    return dataclasses.replace(batch, graph1=g)


@pytest.fixture(scope="module")
def run():
    """K same-shape complexes in both packages (batch 1 each), the middle
    one poisoned with NaN, and one random variables tree."""
    pairs = [complexes(seed=s) for s in (61, 62, 63)]
    jax_batches = [p[0] for p in pairs]
    port_batches = [p[1] for p in pairs]
    jax_batches[POISONED] = _poison(jax_batches[POISONED],
                                    lambda x: jnp.full_like(x, jnp.nan))
    port_batches[POISONED] = _poison(port_batches[POISONED],
                                     lambda x: torch.full_like(x, float("nan")))
    jcfg = _shallow(jax_cfg())
    variables = random_variables(jcfg, pairs[0][0], seed=61)
    return jcfg, variables, jax_batches, port_batches


def _port_state(variables, accumulate=1, dropout=0.0, seed=42, **optim):
    cfg = _shallow(port_cfg())
    cfg = dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn, dropout_rate=dropout))
    model = DeepInteract(cfg)
    load_jax_variables(model, variables)
    return create_train_state(model, seed,
                              OptimConfig(**{**OPTIM, **optim}, accumulate_steps=accumulate))


def _jax_run(jcfg, variables, batches, accumulate):
    """The JAX multi_train_step (guard on) from ``variables``: the final
    params on the port's names, its [K] metrics, and the final counters."""
    if accumulate not in _JAX_STEPS:  # one model, chain and jit: one compile per chain
        _JAX_STEPS[accumulate] = (
            JaxDeepInteract(jcfg), make_optimizer(JaxOptimConfig(**OPTIM,
                                                                 accumulate_steps=accumulate)),
            jax.jit(lambda s, b: jax_multi_train_step(s, b, guard=True)))
    model, tx, step = _JAX_STEPS[accumulate]
    state = JaxTrainState.create(apply_fn=model.apply, params=variables["params"], tx=tx,
                                 batch_stats=variables["batch_stats"],
                                 dropout_rng=jax.random.PRNGKey(0),
                                 bad_steps=jnp.zeros((), jnp.int32))
    state, metrics = step(state, stack_microbatches(batches))
    ref = DeepInteract(_shallow(port_cfg()))
    load_jax_variables(ref, {"params": jax.tree_util.tree_map(np.asarray, state.params),
                             "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                   state.batch_stats)})
    return (ref.state_dict(), {k: np.asarray(v) for k, v in metrics.items()},
            (int(state.step), int(state.bad_steps)))


_JAX_STEPS = {}


def _jax_grads(jcfg, variables, batches):
    """The JAX train-mode gradient of each batch's loss at ``variables``,
    on the port's names (dropout is off in this config)."""
    if "grad" not in _JAX_STEPS:
        _JAX_STEPS["grad"] = (JaxDeepInteract(jcfg), jax.jit(jax.grad(
            lambda p, s, b: jax_loss_and_updates(p, s, b, False, jax.random.PRNGKey(0))[0])))
    model, grad = _JAX_STEPS["grad"]
    state = JaxTrainState.create(apply_fn=model.apply, params=variables["params"],
                                 tx=optax.identity(), batch_stats=variables["batch_stats"],
                                 dropout_rng=jax.random.PRNGKey(0),
                                 bad_steps=jnp.zeros((), jnp.int32))
    out = []
    for batch in batches:
        grads = grad(variables["params"], state, batch)
        ref = DeepInteract(_shallow(port_cfg()))
        load_jax_variables(ref, {"params": jax.tree_util.tree_map(np.asarray, grads),
                                 "batch_stats": variables["batch_stats"]})
        out.append({n: p.detach().clone() for n, p in ref.named_parameters()})
    return out


def _port_grads(variables, batches):
    """The port's train-mode gradient of each batch's loss at ``variables``."""
    out = []
    for batch in batches:
        model = _port_state(variables).model.train()
        with dropout_rng(model, DropoutKey(torch.tensor(0), torch.tensor(0))):
            contact_loss(model(batch.graph1, batch.graph2), batch.contact_map,
                         batch.pair_mask).backward()
        out.append({n: p.grad.detach().clone() for n, p in model.named_parameters()})
    return out


def _perturbed(variables, seed):
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1 + 1e-7 * rng.standard_normal(a.shape)).astype(np.float32),
        variables["params"])
    return dict(variables, params=params)


@pytest.mark.parametrize("accumulate", [1, 2], ids=["guard", "guard_accumulate_2"])
def test_multi_train_step_matches_jax(run, accumulate):
    """[K] loss 1e-5 and grad norm 1e-4 (NaN at the poisoned step), the
    guard's bad_step and bad_steps exact, the step and skip counters
    exact; each clean batch's gradient at the starting weights (under
    accumulation, the run's step gradients before AdamW) 1e-4 plus four
    times the reference's gradient spread; and the final parameters and
    batch statistics 1e-4 plus four times the reference's own float32
    spread, each spread the largest move over :data:`MOVED_SEEDS` (batch
    norms and AdamW on noise-level gradients: ROADMAP queue 3)."""
    jcfg, variables, jax_batches, port_batches = run
    ref, jm, (jstep, jbad) = _jax_run(jcfg, variables, jax_batches, accumulate)
    clean = [i for i in range(K) if i != POISONED]
    ref_grads = _jax_grads(jcfg, variables, [jax_batches[i] for i in clean])
    spread = dict.fromkeys(ref, 0.0)
    grad_spread = [dict.fromkeys(g, 0.0) for g in ref_grads]
    for seed in MOVED_SEEDS:
        moved_vars = _perturbed(variables, seed)
        moved = _jax_run(jcfg, moved_vars, jax_batches, accumulate)[0]
        for name in spread:
            spread[name] = max(spread[name], (moved[name] - ref[name]).abs().max().item())
        for bar, ref_g, got_g in zip(grad_spread, ref_grads, _jax_grads(
                jcfg, moved_vars, [jax_batches[i] for i in clean])):
            for name in bar:
                bar[name] = max(bar[name], (got_g[name] - ref_g[name]).abs().max().item())

    for i, ref_g, got_g, bar in zip(clean, ref_grads,
                                    _port_grads(variables, [port_batches[i] for i in clean]),
                                    grad_spread):
        for name, g in got_g.items():
            np.testing.assert_allclose(g.numpy(), ref_g[name].numpy(),
                                       err_msg=f"gradient of batch {i}: {name}",
                                       rtol=TOL["rtol"], atol=TOL["atol"] + 4 * bar[name])

    state = _port_state(variables, accumulate)
    got = {k: v.numpy() for k, v in multi_train_step(state, port_batches, guard=True).items()}
    np.testing.assert_allclose(got["loss"], jm["loss"], **LOSS_TOL)
    np.testing.assert_allclose(got["grad_norm"], jm["grad_norm"], **TOL)
    assert not np.isfinite(got["loss"][POISONED])
    np.testing.assert_array_equal(got["bad_step"], jm["bad_step"])
    np.testing.assert_array_equal(got["bad_steps"], jm["bad_steps"])
    assert (state.step, state.bad_steps) == (jstep, jbad) == (K - 1, 0)
    assert state.optimizer.schedule.last_epoch == (K - 1) // accumulate
    for name, value in state.model.state_dict().items():
        np.testing.assert_allclose(value.detach().numpy(), ref[name].numpy(), err_msg=name,
                                   rtol=TOL["rtol"], atol=TOL["atol"] + 4 * spread[name])


def test_multi_eval_step_matches_jax(run):
    """Loss, probabilities and logits of K eval batches at 1e-4."""
    jcfg, variables, jax_batches, port_batches = run
    clean = [b for i, b in enumerate(jax_batches) if i != POISONED]
    model = JaxDeepInteract(jcfg)
    jstate = JaxTrainState.create(apply_fn=model.apply, params=variables["params"],
                                  tx=optax.identity(), batch_stats=variables["batch_stats"],
                                  dropout_rng=jax.random.PRNGKey(0),
                                  bad_steps=jnp.zeros((), jnp.int32))
    ref = jax.jit(jax_multi_eval_step)(jstate, stack_microbatches(clean))
    got = multi_eval_step(_port_state(variables),
                          [b for i, b in enumerate(port_batches) if i != POISONED])
    for key in ("loss", "probs", "logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), err_msg=key, **TOL)


def test_multi_train_step_equals_eager_train_steps_bitwise(run):
    """Dropout 0.2, the guard on, the middle batch poisoned: the K-step run
    and K eager train_step calls give the same metrics and the same state,
    bitwise. The skipped step does not advance the step counter, so the
    step after it draws the skipped step's masks (JAX's fold_in of
    state.step)."""
    _, variables, _, port_batches = run
    a = _port_state(variables, dropout=0.2, seed=9)
    b = _port_state(variables, dropout=0.2, seed=9)
    multi = multi_train_step(a, port_batches, guard=True)
    eager = [train_step(b, batch, guard=True) for batch in port_batches]
    for name, column in multi.items():  # NaN equals NaN here: the poisoned step's loss
        np.testing.assert_array_equal(column.numpy(), np.float32([m[name] for m in eager]),
                                      err_msg=name)
    assert (a.step, a.bad_steps) == (b.step, b.bad_steps) == (K - 1, 0)
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), name
    for x, y in zip(a.optimizer.tensors(), b.optimizer.tensors()):
        assert torch.equal(x, y)


def test_device_schedule_matches_optax_over_restarts():
    """The rate computed on the device from AdamW's count against the JAX
    optax schedule over three restart cycles and past the last, within
    float32 rounding."""
    cfg = dict(lr=1e-2, t0_epochs=2, steps_per_epoch=3, num_epochs=6, eta_min=1e-4)
    ref = jax_schedule(JaxOptimConfig(**cfg))
    lr = cosine_warm_restarts_lr(OptimConfig(**cfg))
    steps = range(0, 22)
    got = [lr(torch.tensor(s, dtype=torch.int64)) for s in steps]
    assert all(g.dtype == torch.float32 and g.dim() == 0 for g in got)
    np.testing.assert_allclose([g.item() for g in got], [float(ref(s)) for s in steps],
                               rtol=2e-7, atol=0)


@pytest.mark.parametrize("scale", [0.5, 2.0], ids=["clipped", "unclipped"])
def test_clip_matches_the_jax_chain_above_and_below_the_norm(run, scale):
    """One train step with grad_clip_norm at half and at twice its
    gradient norm: AdamW's first moment after it, (1 - b1) times the
    clipped gradient, against the JAX package's optimizer chain
    (``make_optimizer``: clip_by_global_norm -> adamw) on the step's own
    gradients, leaf by leaf (the chain is elementwise but for the global
    norm). The parameters are no check here: Adam's first update is
    sign(g) * lr whatever the clip."""
    _, variables, _, port_batches = run
    clean = port_batches[0]
    probe = _port_state(variables)
    norm = train_step(probe, clean)["grad_norm"]
    state = _port_state(variables, grad_clip_norm=scale * norm)
    metrics = train_step(state, clean)
    assert metrics["grad_norm"] == norm
    names = [n for n, _ in state.model.named_parameters()]
    grads = {n: jnp.asarray(p.grad.numpy()) for n, p in state.model.named_parameters()}
    params = {n: jnp.asarray(p.detach().numpy()) for n, p in state.model.named_parameters()}
    tx = make_optimizer(JaxOptimConfig(**OPTIM, grad_clip_norm=scale * norm))
    _, opt_state = jax.jit(tx.update)(grads, tx.init(params), params)
    ref = optax.tree_utils.tree_get(opt_state, "mu")
    for name, mu in zip(names, state.optimizer.adamw.buffers()["mu"]):
        np.testing.assert_allclose(mu.numpy(), np.asarray(ref[name]), err_msg=name,
                                   rtol=1e-6, atol=1e-9)


def _addresses(state):
    return [t.data_ptr() for t in (*state.tensors(), state.optimizer.grads())]


def test_state_loads_keep_tensor_identity_and_read_the_earlier_layout(run):
    """``TrainState.load_state_dict`` and ``Optimizer.load_state_dict``
    write into the tensors they hold (a captured graph keeps their
    addresses), and a checkpoint in the earlier layout (a torch AdamW
    state with an int count, a LambdaLR schedule, a mid-accumulation
    accumulator) still loads."""
    _, variables, _, port_batches = run
    state = _port_state(variables, accumulate=2)
    train_step(state, port_batches[0], guard=True)
    before = _addresses(state)
    saved = {k: v for k, v in state.state_dict().items()}
    saved = torch.utils._pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, saved)
    fresh = _port_state(variables, accumulate=2)
    fresh_addresses = _addresses(fresh)
    fresh.load_state_dict(saved)
    assert _addresses(fresh) == fresh_addresses and _addresses(state) == before
    assert (fresh.step, fresh.optimizer.micro, fresh.optimizer.schedule.last_epoch) == (1, 1, 0)
    for x, y in zip(state.optimizer.tensors(), fresh.optimizer.tensors()):
        assert torch.equal(x, y)

    # The earlier layout, as torch.optim.AdamW + LambdaLR wrote it.
    params = fresh.optimizer.params
    rng = np.random.default_rng(3)
    mu = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)) for p in params]
    nu = [torch.from_numpy(rng.random(p.shape).astype(np.float32)) for p in params]
    acc = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)) for p in params]
    earlier = {"adamw": {"state": {0: {"count": 5, "mu": mu, "nu": nu}},
                         "param_groups": [{"lr": 1e-3, "weight_decay": 1e-2,
                                           "betas": (0.9, 0.999), "eps": 1e-8,
                                           "initial_lr": 1e-2,
                                           "params": list(range(len(params)))}]},
               "schedule": {"base_lrs": [1e-2], "last_epoch": 5, "_step_count": 6,
                            "_get_lr_called_within_step": False, "_last_lr": [1e-3],
                            "lr_lambdas": [None]},
               "acc": acc, "micro": 1, "frozen_prefixes": []}
    fresh.optimizer.load_state_dict(earlier)
    assert _addresses(fresh) == fresh_addresses
    st = fresh.optimizer.adamw.buffers()
    assert fresh.optimizer.schedule.last_epoch == 5 and fresh.optimizer.micro == 1
    assert all(torch.equal(a, b) for a, b in zip(st["mu"], mu))
    assert all(torch.equal(a, b) for a, b in zip(st["nu"], nu))
    assert fresh.optimizer.state_dict()["acc"] is not None
