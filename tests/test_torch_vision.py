"""The port's DeepLabV3+ decoder (models/vision.py) and DeepLab stem
(models/stem.py) against the JAX package on carried weights: the decoder
at output stride 8 and 16 with basic and bottleneck blocks, on the
factorized and the materialized stem, at odd sizes; padding invisible;
``_masked_resize`` and ``factorized_stem_conv`` alone; the resnet34 and
resnet50 zoo trees carried strictly. Sizes follow the JAX package's own
``tests/test_vision.py`` (``TINY``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinteract_tpu.models.stem import PairFactors as JaxPairFactors
from deepinteract_tpu.models.stem import factorized_stem_conv as jax_factorized_stem_conv
from deepinteract_tpu.models.vision import DeepLabConfig as JaxDeepLabConfig
from deepinteract_tpu.models.vision import DeepLabDecoder as JaxDeepLabDecoder
from deepinteract_tpu.models.vision import _masked_resize as jax_masked_resize
from deepinteract_tpu_torch.models.interaction import interaction_tensor
from deepinteract_tpu_torch.models.stem import DeepLabStemConv, PairFactors, factorized_stem_conv
from deepinteract_tpu_torch.models.vision import (DeepLabConfig, DeepLabDecoder, bilinear_resize,
                                                  _masked_resize)
from deepinteract_tpu_torch.weights import init_weights, load_jax_variables
from torch_port_helpers import random_like

TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_vision.py's padding bar
TIGHT = dict(rtol=1e-5, atol=1e-5)
TINY = dict(in_channels=12, num_classes=2, stem_channels=4, stage_channels=(4, 8, 8, 8),
            stage_blocks=(1, 1, 1, 1), aspp_rates=(2, 4, 6), decoder_channels=8,
            high_res_channels=4, dropout_rate=0.0)
# Odd sizes (37 x 23, padded to the output stride inside the decoder) with
# ragged chain masks.
H, W, VALID_H, VALID_W, C = 37, 23, 30, 20, 6
CASES = {"basic_os16": ("resnet18", (4, 8, 8, 8), 16),
         "bottleneck_os8": ("resnet50", (8, 8, 16, 16), 8),
         "basic_os8": ("resnet18", (4, 8, 8, 8), 8),
         "bottleneck_os16": ("resnet50", (8, 8, 16, 16), 16)}


def _chains(seed=0, h=H, w=W, valid_h=VALID_H, valid_w=VALID_W):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((1, h, C)).astype(np.float32)
    f2 = rng.standard_normal((1, w, C)).astype(np.float32)
    return f1, f2, (np.arange(h) < valid_h)[None], (np.arange(w) < valid_w)[None]


def jax_random_apply(module, *args, seed: int = 0):
    """(random variables, jitted module.apply): a jitted apply of these
    small decoders compiles faster than op-by-op dispatch runs."""
    variables = random_like(jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args)),
                            seed)
    return variables, jax.jit(module.apply)(variables, *args)


def _port_logits(dec, f1, f2, m1, m2, stem):
    t1, t2, tm1, tm2 = (torch.from_numpy(a) for a in (f1, f2, m1, m2))
    pm = tm1[:, :, None] & tm2[:, None, :]
    pair = PairFactors(t1, t2, tm1, tm2) if stem == "factorized" else interaction_tensor(t1, t2)
    with torch.no_grad():
        return dec(pair, pm).numpy()


@pytest.fixture(scope="module", params=sorted(CASES))
def carried(request):
    """(config kwargs, JAX variables, JAX logits, inputs) for one case."""
    encoder, stages, os_ = CASES[request.param]
    kw = dict(TINY, encoder_name=encoder, stage_channels=stages, output_stride=os_)
    inputs = _chains()
    factors = JaxPairFactors(*(jnp.asarray(a) for a in inputs))
    variables, ref = jax_random_apply(JaxDeepLabDecoder(JaxDeepLabConfig(**kw)), factors,
                                      factors.pair_mask(), seed=1)
    return kw, variables, np.asarray(ref), inputs


@pytest.mark.parametrize("stem", ["factorized", "materialized"])
def test_deeplab_decoder_matches_jax(carried, stem):
    kw, variables, ref, inputs = carried
    dec = DeepLabDecoder(DeepLabConfig(**kw))
    load_jax_variables(dec, variables)
    out = _port_logits(dec.eval(), *inputs, stem)
    assert out.shape == (1, H, W, 2)
    np.testing.assert_allclose(out, ref, **TOL)
    assert np.all(out[0, VALID_H:] == 0) and np.all(out[0, :, VALID_W:] == 0)


def test_padding_is_invisible():
    """The same valid content in a larger padded map: zero logits in the
    pad, the unpadded logits in the valid region (mask-renormalized
    upsampling, pad frontier included)."""
    dec = DeepLabDecoder(DeepLabConfig(**TINY))
    init_weights(dec, 0)
    dec.eval()
    small = _chains(seed=2, h=16, w=16, valid_h=16, valid_w=16)
    f1, f2, m1, m2 = _chains(seed=3, h=24, w=24, valid_h=16, valid_w=16)
    f1[0, :16], f2[0, :16] = small[0][0], small[1][0]
    for stem in ("factorized", "materialized"):
        ref = _port_logits(dec, *small, stem)
        big = _port_logits(dec, f1, f2, m1, m2, stem)
        assert np.all(big[0, 16:] == 0) and np.all(big[0, :, 16:] == 0)
        np.testing.assert_allclose(big[:, :16, :16], ref, **TOL)


@pytest.mark.parametrize("factor", [4, 2], ids=["x4_os16", "x2_os8"])
def test_masked_resize_matches_jax(factor):
    rng = np.random.default_rng(factor)
    y = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)  # NHWC
    mask = np.ones((2, 5, 7), np.float32)
    mask[0, 3:], mask[1, :, 4:] = 0.0, 0.0
    hw = (5 * factor, 7 * factor)
    ref = np.asarray(jax_masked_resize(jnp.asarray(y), jnp.asarray(mask), hw))
    out = _masked_resize(torch.from_numpy(y).permute(0, 3, 1, 2),
                         torch.from_numpy(mask)[:, None], hw)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, **TIGHT)


@pytest.mark.parametrize("src,dst", [((5, 7), (13, 50)), ((13, 9), (50, 33)),
                                     ((50, 33), (13, 9)), ((1, 3), (5, 7))],
                         ids=["up", "up_odd", "down_odd", "from_one"])
def test_resize_matrices_match_jax_image_resize(src, dst):
    """The interpolation-matrix resize against ``jax.image.resize(...,
    "bilinear")`` at odd sizes, both ways (shrinking antialiases), alone
    and masked: 1e-5."""
    rng = np.random.default_rng(sum(src + dst))
    y = rng.standard_normal((2, *src, 3)).astype(np.float32)  # NHWC
    ref = np.asarray(jax.image.resize(jnp.asarray(y), (2, *dst, 3), method="bilinear"))
    out = bilinear_resize(torch.from_numpy(y).permute(0, 3, 1, 2), dst)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, **TIGHT)
    mask = (rng.random((2, *src)) < 0.7).astype(np.float32)
    ref = np.asarray(jax_masked_resize(jnp.asarray(y), jnp.asarray(mask), dst))
    out = _masked_resize(torch.from_numpy(y).permute(0, 3, 1, 2),
                         torch.from_numpy(mask)[:, None], dst)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, **TIGHT)


def test_factorized_stem_conv_matches_jax():
    rng = np.random.default_rng(4)
    f1, f2, m1, m2 = _chains(seed=4, h=21, w=28, valid_h=17, valid_w=24)
    kernel = (rng.standard_normal((7, 7, 2 * C, 5)) / 20).astype(np.float32)  # HWIO
    ref = np.asarray(jax_factorized_stem_conv(
        JaxPairFactors(*(jnp.asarray(a) for a in (f1, f2, m1, m2))), jnp.asarray(kernel), 2))
    t1, t2, tm1, tm2 = (torch.from_numpy(a) for a in (f1, f2, m1, m2))
    weight = torch.from_numpy(kernel).permute(3, 2, 0, 1)
    out = factorized_stem_conv(PairFactors(t1, t2, tm1, tm2), weight, 2, torch.float32)
    assert out.shape == (1, 5, 11, 14)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, **TIGHT)
    # The same conv of the materialized masked tensor (the stem's other path).
    conv = DeepLabStemConv(2 * C, 5)
    with torch.no_grad():
        conv.weight.copy_(weight)
        pm = (tm1[:, :, None] & tm2[:, None, :]).float()
        mat = conv((interaction_tensor(t1, t2) * pm[..., None]).permute(0, 3, 1, 2))
    np.testing.assert_allclose(mat.numpy(), out.numpy(), **TIGHT)


@pytest.mark.parametrize("encoder", ["resnet34", "resnet50"])
def test_zoo_trees_carry_strictly(encoder):
    """The zoo's stage plans (3, 4, 6, 3 blocks) at narrow channels: every
    JAX leaf fills a port tensor and every port tensor is filled, at os 16
    and os 8 alike (one tree for both)."""
    narrow = (8, 8, 16, 16) if encoder == "resnet50" else (4, 8, 8, 8)
    kw = dict(TINY, encoder_name=encoder, stage_channels=narrow, stage_blocks=None)
    x = jnp.zeros((1, 32, 32, TINY["in_channels"]))
    shapes = jax.eval_shape(lambda: JaxDeepLabDecoder(JaxDeepLabConfig(**kw)).init(
        jax.random.PRNGKey(0), x, None))
    variables = random_like(shapes)
    for os_ in (16, 8):
        cfg = DeepLabConfig(**dict(kw, output_stride=os_))
        assert tuple(cfg.stage_blocks) == (3, 4, 6, 3)
        dec = DeepLabDecoder(cfg)
        load_jax_variables(dec, variables)
        assert len(dec.state_dict()) == sum(1 for _ in jax.tree_util.tree_leaves(variables))
    params = dict(variables["params"])
    params["ResNetEncoder_0"] = {k: v for k, v in params["ResNetEncoder_0"].items()
                                 if k != "stage2_block5"}
    with pytest.raises(KeyError, match="not filled"):
        load_jax_variables(DeepLabDecoder(DeepLabConfig(**kw)), {"params": params})


def test_config_derives_and_refuses():
    assert tuple(DeepLabConfig(encoder_name="resnet50").stage_channels) == (256, 512, 1024, 2048)
    assert tuple(DeepLabConfig(encoder_name="resnet152").stage_blocks) == (3, 8, 36, 3)
    assert dataclasses.replace(DeepLabConfig(), output_stride=8).output_stride == 8
    with pytest.raises(ValueError, match="8 or 16"):
        DeepLabConfig(output_stride=4)
    with pytest.raises(ValueError, match="unknown encoder"):
        DeepLabConfig(encoder_name="vgg7")
