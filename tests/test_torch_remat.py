"""Decoder remat (``DecoderConfig.remat`` / ``remat_policy``,
``DeepLabConfig.remat``, ``--remat``) against the JAX package's: one train
step of the dilated decoder (with regional attention), of DeepLab and of
tiled decoding under each policy against the JAX remat step (loss 1e-5,
gradients 1e-4; dropout 0, since the two packages draw different masks),
and the port's remat step against its own non-remat step, bitwise, with
dropout on. A recomputed block must draw no dropout mask: each tile's
forked generator is used once per dropout module and never in the
backward."""

import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch

from deepinteract_tpu.models.model import DeepInteract as JaxDeepInteract
from deepinteract_tpu.models.vision import DeepLabConfig as JaxDeepLabConfig
from deepinteract_tpu.training.steps import loss_and_updates
from deepinteract_tpu_torch.cli.args import build_parser, model_config_from_args
from deepinteract_tpu_torch.models import decoder, layers
from deepinteract_tpu_torch.models.decoder import remat_call
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.models.vision import DeepLabConfig
from deepinteract_tpu_torch.training.steps import create_train_state, train_step
from deepinteract_tpu_torch.weights import load_jax_variables
from torch_port_helpers import complexes, jax_cfg, port_cfg, random_variables

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
TINY_DEEPLAB = dict(stem_channels=4, stage_channels=(4, 8, 8, 8), stage_blocks=(1, 1, 1, 1),
                    aspp_rates=(2, 4, 6), decoder_channels=8, high_res_channels=4)
SHORT_DECODER = dict(num_chunks=1, dilation_cycle=(1, 2))
# name -> (remat policy, pad, residues per chain)
CASES = {
    "dilated_full": ("full", 32, (26, 22)),
    "dilated_convs": ("convs", 32, (26, 22)),
    "deeplab": ("full", 32, (26, 22)),
    "tiled_full": ("full", 64, (40, 36)),
    "tiled_convs": ("convs", 64, (40, 36)),
}


def _configs(name, remat=True, dropout=0.0):
    """(JAX config, port config): one layer-norm GT layer, a short decoder
    with regional attention, remat under the case's policy."""
    policy = CASES[name][0]
    jcfg = jax_cfg(norm_type="layer", use_attention=True, remat=remat, remat_policy=policy,
                   dropout_rate=dropout, **SHORT_DECODER)
    jcfg = dataclasses.replace(jcfg, gnn=dataclasses.replace(jcfg.gnn, num_layers=1,
                                                             dropout_rate=dropout))
    pcfg = port_cfg(norm_type="layer")
    pcfg = dataclasses.replace(
        pcfg, gnn=dataclasses.replace(pcfg.gnn, num_layers=1, dropout_rate=dropout),
        decoder=dataclasses.replace(pcfg.decoder, use_attention=True, remat=remat,
                                    remat_policy=policy, dropout_rate=dropout,
                                    **SHORT_DECODER))
    if name == "deeplab":
        jcfg = dataclasses.replace(jcfg, interact_module_type="deeplab", deeplab=JaxDeepLabConfig(
            remat=remat, dropout_rate=dropout, **TINY_DEEPLAB))
        pcfg = dataclasses.replace(pcfg, interact_module_type="deeplab", deeplab=DeepLabConfig(
            remat=remat, dropout_rate=dropout, **TINY_DEEPLAB))
    elif name.startswith("tiled"):
        jcfg = dataclasses.replace(jcfg, tile_pair_map=True, tile_size=32)
        pcfg = dataclasses.replace(pcfg, tile_pair_map=True, tile_size=32)
    return jcfg, pcfg


def _batch(name, seed):
    _, pad, (n1, n2) = CASES[name]
    return complexes(seed=seed, pad=pad, n1=n1, n2=n2)


# The JAX step each port case is held against: one compile per decoder kind,
# under one policy (the two policies compute the same function), so that
# both of the port's policies meet both of JAX's.
JAX_STEP_OF = {"dilated_full": "dilated_full", "dilated_convs": "dilated_full",
               "deeplab": "deeplab", "tiled_full": "tiled_convs", "tiled_convs": "tiled_convs"}


@functools.lru_cache(maxsize=None)
def _jax_remat_step(name):
    """(JAX config, carried variables, port batch, JAX loss, JAX grads)."""
    jcfg = _configs(name)[0]
    jcx, cx = _batch(name, seed=21)
    variables = random_variables(jcfg, jcx, seed=21)
    model = JaxDeepInteract(jcfg)

    def step(params, batch_stats, batch):
        state = types.SimpleNamespace(apply_fn=model.apply, batch_stats=batch_stats)
        return jax.value_and_grad(loss_and_updates, has_aux=True)(
            params, state, batch, False, jax.random.PRNGKey(0))

    (loss, _), grads = jax.jit(step)(variables["params"], variables.get("batch_stats", {}),
                                     jcx)
    return variables, cx, float(loss), grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_remat_train_step_matches_the_jax_remat_step(name):
    pcfg = _configs(name)[1]
    variables, cx, loss, grads = _jax_remat_step(JAX_STEP_OF[name])
    port = DeepInteract(pcfg)
    load_jax_variables(port, variables)
    metrics = train_step(create_train_state(port), cx)
    np.testing.assert_allclose(metrics["loss"], loss, **LOSS_TOL)
    ref = DeepInteract(pcfg)
    load_jax_variables(ref, {"params": grads})
    ref = ref.state_dict()
    for pname, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[pname].numpy(), err_msg=pname,
                                   **GRAD_TOL)


def _port_step(pcfg, variables, cx):
    model = DeepInteract(pcfg)
    load_jax_variables(model, variables)
    metrics = train_step(create_train_state(model, seed=3), cx)
    return metrics["loss"], {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_remat_step_equals_the_plain_step_bitwise_with_dropout(name, monkeypatch):
    """Dropout 0.2 in the encoder, the regional attention and the ASPP
    head; each dropout module draws once per decoder call (per tile when
    tiled) and never while a block is recomputed."""
    _, plain_cfg = _configs(name, remat=False, dropout=0.2)
    _, remat_cfg = _configs(name, remat=True, dropout=0.2)
    # Dropout leaves the parameter tree as it is: the JAX step's weights do.
    variables, cx, _, _ = _jax_remat_step(JAX_STEP_OF[name])
    draws = []
    forward = layers.Dropout.forward

    def counted(self, x):
        if self.training and self.p:
            draws.append(self.key.stream)
        return forward(self, x)

    monkeypatch.setattr(layers.Dropout, "forward", counted)
    loss_p, grads_p = _port_step(plain_cfg, variables, cx)
    plain_draws, draws[:] = list(draws), []
    loss_r, grads_r = _port_step(remat_cfg, variables, cx)
    assert loss_r == loss_p
    for pname, g in grads_p.items():
        assert torch.equal(grads_r[pname], g), pname
    # The same draws in the same order: none while a block is recomputed.
    assert draws == plain_draws
    if name.startswith("tiled"):
        # 2 x 2 tiles, each its own stream of the step's key, drawn by the
        # two regional attentions once each.
        tiles = [stream for stream in draws if stream != draws[0]]
        assert len(set(tiles)) == 4 and all(tiles.count(s) == 2 for s in set(tiles))


@pytest.mark.parametrize("policy", ["full", "convs"])
def test_remat_applies_only_with_grad(policy, monkeypatch):
    calls = []
    real = decoder.checkpoint
    monkeypatch.setattr(decoder, "checkpoint", lambda *a, **k: calls.append(k) or real(*a, **k))
    block = torch.nn.Linear(3, 3)
    x = torch.randn(2, 3, requires_grad=True)
    with torch.no_grad():
        assert torch.equal(remat_call(block, policy, x), block(x))
    assert not calls
    remat_call(block, policy, x).sum().backward()
    assert len(calls) == 1 and calls[0]["use_reentrant"] is False
    assert ("context_fn" in calls[0]) == (policy == "convs")


@pytest.mark.parametrize("flags", [["--remat"], ["--remat", "--remat_policy", "convs"], []])
def test_remat_flags_reach_both_decoders(flags):
    cfg = model_config_from_args(build_parser("x").parse_args(flags))
    remat = "--remat" in flags
    assert (cfg.decoder.remat, cfg.deeplab.remat) == (remat, remat)
    assert cfg.decoder.remat_policy == ("convs" if "convs" in flags else "full")
