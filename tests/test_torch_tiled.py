"""The port's tiled decoding (models/tiled.py) against the JAX package's
``tiled_decode`` on carried weights, for the dilated and the DeepLab
decoder on the factorized and the materialized stem; an all-padding tile
decodes to zeros; the model tiles only past ``tile_size``; ``tile_grid``
refuses lengths that are not multiples of the tile. Tile 32, as the JAX
package's ``tests/test_tiled_decoder.py``. Tiled logits differ from
untiled ones (each tile is its own map), so the reference is JAX tiled."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from deepinteract_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from deepinteract_tpu.models.decoder import InteractionDecoder as JaxInteractionDecoder
from deepinteract_tpu.models.tiled import tiled_decode as jax_tiled_decode
from deepinteract_tpu.models.vision import DeepLabConfig as JaxDeepLabConfig
from deepinteract_tpu.models.vision import DeepLabDecoder as JaxDeepLabDecoder
from deepinteract_tpu_torch.models import tiled
from deepinteract_tpu_torch.models.decoder import DecoderConfig, InteractionDecoder
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.models.tiled import tile_grid, tiled_decode
from deepinteract_tpu_torch.models.vision import DeepLabConfig, DeepLabDecoder
from deepinteract_tpu_torch.weights import init_weights, load_jax_variables
from torch_port_helpers import complexes, port_cfg, random_like

TILE = 32
TOL = dict(rtol=4e-4, atol=1e-4)  # tests/test_tiled_decoder.py:86
B, L1, L2, C = 1, 2 * TILE, 3 * TILE, 6
DILATED = dict(num_chunks=1, num_channels=8, in_channels=2 * C, dilation_cycle=(1, 2))
DEEPLAB = dict(in_channels=2 * C, num_classes=2, stem_channels=4, stage_channels=(4, 8, 8, 8),
               stage_blocks=(1, 1, 1, 1), aspp_rates=(2, 4, 6), decoder_channels=8,
               high_res_channels=4, dropout_rate=0.0)
DECODERS = {
    "dilated": (lambda: JaxInteractionDecoder(JaxDecoderConfig(**DILATED, depad_stats=False)),
                lambda: InteractionDecoder(DecoderConfig(**DILATED))),
    "deeplab": (lambda: JaxDeepLabDecoder(JaxDeepLabConfig(**DEEPLAB)),
                lambda: DeepLabDecoder(DeepLabConfig(**DEEPLAB))),
}


def _inputs(valid1=50, valid2=70, seed=0):
    """Chains with validity ending inside a tile (ragged across tiles)."""
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((B, L1, C)).astype(np.float32)
    f2 = rng.standard_normal((B, L2, C)).astype(np.float32)
    return f1, f2, (np.arange(L1) < valid1)[None], (np.arange(L2) < valid2)[None]


class JaxTiled(flax_nn.Module):
    decoder: str
    stem: str

    def setup(self):
        self.dec = DECODERS[self.decoder][0]()

    def __call__(self, f1, f2, m1, m2):
        return jax_tiled_decode(self.dec, f1, f2, m1, m2, tile=TILE, stem=self.stem)


def _port_tiled(dec, inputs, stem):
    with torch.no_grad():
        return tiled_decode(dec, *(torch.from_numpy(a) for a in inputs), TILE, stem).numpy()


@pytest.fixture(scope="module", params=sorted(DECODERS))
def carried(request):
    """(decoder name, JAX tiled module's variables, port decoder)."""
    module = JaxTiled(request.param, "materialized")
    variables = random_like(jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                               *_inputs())), seed=2)
    dec = DECODERS[request.param][1]()
    load_jax_variables(dec, {"params": variables["params"]["dec"]})
    return request.param, variables, dec.eval()


@pytest.mark.parametrize("stem", ["factorized", "materialized"])
def test_tiled_decode_matches_jax(carried, stem):
    name, variables, dec = carried
    inputs = _inputs()
    ref = np.asarray(jax.jit(JaxTiled(name, stem).apply)(variables, *inputs))
    out = _port_tiled(dec, inputs, stem)
    assert out.shape == (B, L1, L2, 2)
    np.testing.assert_allclose(out, ref, **TOL)
    assert np.all(out[:, 50:] == 0) and np.all(out[:, :, 70:] == 0)


def test_all_padding_tile_decodes_to_zeros(carried):
    """Chain 1 valid only in its first tile: the second tile row is all
    padding (masked norms clamp the count at 1) and decodes to zeros."""
    _, _, dec = carried
    out = _port_tiled(dec, _inputs(valid1=20), "factorized")
    assert np.all(np.isfinite(out))
    assert np.all(out[:, TILE:] == 0) and np.any(out[:, :20, :70] != 0)


def test_tiling_engages_only_past_tile_size(monkeypatch):
    calls = []
    monkeypatch.setattr("deepinteract_tpu_torch.models.model.tiled_decode",
                        lambda *a, **k: calls.append(a[-2]) or tiled.tiled_decode(*a, **k))
    base = port_cfg()
    untiled = DeepInteract(base)
    init_weights(untiled, 1)
    tiled_model = DeepInteract(dataclasses.replace(base, tile_pair_map=True, tile_size=TILE))
    tiled_model.load_state_dict(untiled.state_dict())
    _, one_tile = complexes(seed=4, pad=TILE)
    _, two_tiles = complexes(seed=4, pad=2 * TILE, n1=40, n2=36)  # valid map on four tiles
    with torch.no_grad():
        a = tiled_model.eval()(one_tile.graph1, one_tile.graph2)
        b = untiled.eval()(one_tile.graph1, one_tile.graph2)
        assert calls == [] and torch.equal(a, b)
        out = tiled_model(two_tiles.graph1, two_tiles.graph2)
        assert calls == [TILE] and out.shape == (1, 2 * TILE, 2 * TILE, 2)
        assert not torch.allclose(out, untiled(two_tiles.graph1, two_tiles.graph2), atol=1e-3)


def test_tile_grid_refuses_lengths_off_the_tile():
    assert tile_grid(64, 96, 32) == (2, 3)
    with pytest.raises(ValueError, match="multiples of the tile size 32"):
        tile_grid(60, 96, 32)
    with pytest.raises(ValueError, match="multiples"):
        tile_grid(64, 100, 32)
