"""Parity of the port's interaction decoder with the JAX one on carried
weights, from the JAX package's scanned and unrolled parameter trees, on
padded pair masks; the factorized and materialized stems agree; and the
weight loader refuses trees that do not fit.

The port implements the plain masked formulation, so the JAX side runs
with ``depad_stats=False``: on fan-in-scaled random weights the JAX
package's default de-padded statistics (single-pass variance) can fall
outside the 1e-4 bar against its own plain path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinteract_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from deepinteract_tpu.models.decoder import InteractionDecoder as JaxDecoder
from deepinteract_tpu.models.stem import PairFactors as JaxPairFactors
from deepinteract_tpu_torch.models.decoder import DecoderConfig, InteractionDecoder
from deepinteract_tpu_torch.models.interaction import interaction_tensor
from deepinteract_tpu_torch.models.stem import PairFactors
from deepinteract_tpu_torch.weights import load_jax_variables
from torch_port_helpers import CHUNKS, HIDDEN, flax_random_apply

TOL = dict(rtol=1e-4, atol=1e-4)
N1, N2, P1, P2 = 26, 22, 32, 32


def _features(seed=0, p1=P1, p2=P2):
    rng = np.random.default_rng(seed)
    f1 = np.zeros((1, p1, HIDDEN), np.float32)
    f2 = np.zeros((1, p2, HIDDEN), np.float32)
    f1[0, :N1] = rng.standard_normal((N1, HIDDEN))
    f2[0, :N2] = rng.standard_normal((N2, HIDDEN))
    m1, m2 = np.arange(p1) < N1, np.arange(p2) < N2
    return f1, f2, m1[None], m2[None]


def _port_decoder(variables):
    dec = InteractionDecoder(DecoderConfig(num_chunks=CHUNKS, in_channels=2 * HIDDEN,
                                           num_channels=HIDDEN))
    load_jax_variables(dec, variables)
    return dec.eval()


def _port_logits(dec, f1, f2, m1, m2, stem="factorized"):
    t1, t2 = torch.from_numpy(f1), torch.from_numpy(f2)
    pm = torch.from_numpy(m1[:, :, None] & m2[:, None, :])
    pair = PairFactors(t1, t2) if stem == "factorized" else interaction_tensor(t1, t2)
    with torch.no_grad():
        return dec(pair, pm).numpy()


def _jax_run(scan_chunks, seed=0):
    f1, f2, m1, m2 = _features(seed)
    cfg = JaxDecoderConfig(num_chunks=CHUNKS, in_channels=2 * HIDDEN, num_channels=HIDDEN,
                           scan_chunks=scan_chunks, depad_stats=False)
    factors = JaxPairFactors(*(jnp.asarray(a) for a in (f1, f2, m1, m2)))
    variables, ref = flax_random_apply(JaxDecoder(cfg), factors, factors.pair_mask(),
                                       seed=seed, train=False)
    return variables, np.asarray(ref), (f1, f2, m1, m2)


@pytest.mark.parametrize("scan_chunks", [True, False], ids=["scanned_tree", "unrolled_tree"])
def test_decoder_matches_jax(scan_chunks):
    variables, ref, inputs = _jax_run(scan_chunks)
    if scan_chunks:
        assert "chunks" in variables["params"]["base_resnet"]
    dec = _port_decoder(variables)
    out = _port_logits(dec, *inputs)
    np.testing.assert_allclose(out, ref, **TOL)
    assert out.shape == (1, P1, P2, 2)
    assert np.all(out[0, N1:] == 0) and np.all(out[0, :, N2:] == 0)  # masked logits


def test_factorized_and_materialized_stems_agree_and_padding_is_invisible():
    variables, _, inputs = _jax_run(scan_chunks=True, seed=1)
    dec = _port_decoder(variables)
    fact = _port_logits(dec, *inputs, stem="factorized")
    mat = _port_logits(dec, *inputs, stem="materialized")
    np.testing.assert_allclose(fact, mat, rtol=1e-5, atol=1e-5)
    wider = _port_logits(dec, *_features(seed=1, p1=48, p2=40))
    np.testing.assert_allclose(wider[0, :N1, :N2], fact[0, :N1, :N2], rtol=1e-5, atol=1e-5)


def test_loader_refuses_missing_and_unknown_keys():
    variables, _, _ = _jax_run(scan_chunks=False)
    dec = InteractionDecoder(DecoderConfig(num_chunks=CHUNKS, in_channels=2 * HIDDEN,
                                           num_channels=HIDDEN))
    params = dict(variables["params"])
    params["base_resnet"] = dict(params["base_resnet"])
    dropped = params["base_resnet"].pop("block_1_8")
    with pytest.raises(KeyError, match="not filled"):
        load_jax_variables(dec, {"params": params})
    params["base_resnet"]["block_1_8"] = dropped
    params["mystery_layer"] = {"kernel": np.zeros((1, 1, 2, 2), np.float32)}
    with pytest.raises(KeyError, match="mystery_layer"):
        load_jax_variables(dec, {"params": params})
