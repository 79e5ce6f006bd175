"""The model configurations beyond the flagship against the JAX package:
the DeepLabV3+ decoder, tiled decoding, the GCN encoder and regional
attention. Each is built from the same CLI flags in both packages (the
port's ``model_config_from_args`` against JAX ``configs_from_args``),
run on the same complex and carried weights, and compared on the full
forward and on ``cli.predict --device cpu``; one train step with the
DeepLab decoder and one with tiled decoding (dropout 0) against JAX's
loss and gradients."""

import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch

from deepinteract_tpu.cli.args import build_parser as jax_build_parser
from deepinteract_tpu.cli.args import configs_from_args
from deepinteract_tpu.data.graph import stack_complexes as jax_stack_complexes
from deepinteract_tpu.data.io import load_complex_npz as jax_load_complex_npz
from deepinteract_tpu.data.io import save_complex_npz as jax_save_complex_npz
from deepinteract_tpu.data.io import to_paired_complex as jax_to_paired_complex
from deepinteract_tpu.data.synthetic import random_raw_complex as jax_random_raw_complex
from deepinteract_tpu.models.model import DeepInteract as JaxDeepInteract
from deepinteract_tpu.models.vision import DeepLabConfig as JaxDeepLabConfig
from deepinteract_tpu.training.steps import loss_and_updates
from deepinteract_tpu_torch.cli import predict as port_predict
from deepinteract_tpu_torch.cli.args import build_parser, model_config_from_args
from deepinteract_tpu_torch.data.graph import stack_complexes
from deepinteract_tpu_torch.data.io import load_complex_npz, to_paired_complex
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.models.vision import DeepLabConfig
from deepinteract_tpu_torch.training.steps import create_train_state, train_step
from deepinteract_tpu_torch.weights import load_jax_variables, save_npz
from torch_port_helpers import (CHUNKS, HEADS, HIDDEN, KNN, complexes, jax_cfg, port_cfg,
                                random_variables)

TOL = dict(rtol=1e-4, atol=1e-4)
PROB_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# One GT layer: the encoder is held against JAX elsewhere, and each layer
# adds to JAX's compile here.
SMALL = ["--num_gnn_layers", "1", "--num_gnn_hidden_channels", str(HIDDEN),
         "--num_gnn_attention_heads", str(HEADS), "--num_interact_layers", str(CHUNKS),
         "--num_interact_hidden_channels", str(HIDDEN)]
# name -> (flags, residues per chain). The tiled complex pads to 512 x 256:
# two 256 x 256 tiles, the CLI's tile size.
CONFIGS = {
    "deeplab": (["--interact_module_type", "deeplab", "--deeplab_encoder", "resnet18"], (26, 22)),
    "tiled": (["--tile_pair_map"], (300, 200)),
    "gcn": (["--gnn_layer_type", "gcn"], (26, 22)),
    "attention": (["--use_interact_attention"], (26, 22)),
}


def _jax_config(flags):
    # The port implements the decoder's plain masked statistics
    # (ROADMAP queue 3), which the JAX package runs under --no_depad_stats.
    args = jax_build_parser("test").parse_args(SMALL + flags + ["--no_depad_stats"])
    return configs_from_args(args)[0]


def _port_config(flags):
    return model_config_from_args(build_parser("test").parse_args(SMALL + flags))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request, tmp_path_factory):
    """One configuration: its flags, a complex npz, carried JAX variables
    and the JAX logits on the complex's default buckets."""
    flags, (n1, n2) = CONFIGS[request.param]
    work = tmp_path_factory.mktemp(request.param)
    raw = jax_random_raw_complex(n1, n2, np.random.default_rng(7), knn=KNN)
    npz = str(work / "complex.npz")
    jax_save_complex_npz(npz, raw["graph1"], raw["graph2"], raw["examples"], "c7")
    batch = jax_stack_complexes([jax_to_paired_complex(jax_load_complex_npz(npz))])
    model = JaxDeepInteract(_jax_config(flags))
    variables = random_variables(model.cfg, batch, seed=7)
    logits = jax.jit(lambda v, g1, g2: model.apply(v, g1, g2, train=False))(
        variables, batch.graph1, batch.graph2)
    return request.param, flags, (n1, n2), npz, variables, np.asarray(logits), work


def test_full_forward_matches_jax(case):
    name, flags, _, npz, variables, ref, _ = case
    cfg = _port_config(flags)
    model = DeepInteract(cfg)
    load_jax_variables(model, variables)
    batch = stack_complexes([to_paired_complex(load_complex_npz(npz))])
    with torch.no_grad():
        out, reps = model.eval()(batch.graph1, batch.graph2, return_representations=True)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert (reps["graph1_edge_feats"] is None) == (name == "gcn")
    if name == "tiled":
        assert out.shape == (1, 512, 256, 2) and max(out.shape[1:3]) > cfg.tile_size


def test_predict_cli_on_cpu_matches_jax_softmax(case):
    name, flags, (n1, n2), npz, variables, logits, work = case
    weights = work / "weights.npz"
    save_npz(str(weights), variables)
    out_dir = work / "out"
    rc = port_predict.main(["--input_npz", npz, "--output_dir", str(out_dir), "--weights",
                            str(weights), "--device", "cpu", *SMALL, *flags])
    assert rc == 0
    ref = np.asarray(jax.nn.softmax(logits, axis=-1))[0, :n1, :n2, 1]
    np.testing.assert_allclose(np.load(out_dir / "contact_prob_map.npy"), ref, **PROB_TOL)
    written = {p.stem for p in out_dir.iterdir()}
    edges = {"graph1_edge_feats", "graph2_edge_feats"}
    assert written >= {"contact_prob_map", "graph1_node_feats", "graph2_node_feats"}
    assert (edges & written == set()) == (name == "gcn")


@pytest.mark.parametrize("flags", [
    [], *[flags for flags, _ in CONFIGS.values()],
    ["--interact_module_type", "deeplab", "--deeplab_output_stride", "8",
     "--deeplab_encoder", "resnet50", "--dropout_rate", "0.1"],
    ["--disable_geometric_mode", "--use_interact_attention", "--tile_pair_map",
     "--interaction_stem", "materialized", "--compute_dtype", "bfloat16"],
], ids=lambda flags: " ".join(flags) or "defaults")
def test_flags_parse_to_the_jax_config_fields(flags):
    port, ref = _port_config(flags), _jax_config(flags)
    for field in ("gnn_layer_type", "interact_module_type", "tile_pair_map", "tile_size",
                  "interaction_stem", "num_classes", "num_node_input_feats"):
        assert getattr(port, field) == getattr(ref, field), field
    for sub in ("gnn", "decoder", "deeplab"):
        for f in dataclasses.fields(getattr(port, sub)):
            if f.name != "attention_impl":  # the port's kernel routing
                assert getattr(getattr(port, sub), f.name) == getattr(getattr(ref, sub), f.name), \
                    f"{sub}.{f.name}"


def test_unknown_configurations_raise():
    with pytest.raises(ValueError, match="gnn_layer_type"):
        dataclasses.replace(port_cfg(), gnn_layer_type="gat")
    with pytest.raises(ValueError, match="interact_module_type"):
        dataclasses.replace(port_cfg(), interact_module_type="unet")
    with pytest.raises(SystemExit):
        build_parser("test").parse_args(["--gnn_layer_type", "gat"])


# ---------------------------------------------------------------------------
# One train step against JAX
# ---------------------------------------------------------------------------

TINY_DEEPLAB = dict(stem_channels=4, stage_channels=(4, 8, 8, 8), stage_blocks=(1, 1, 1, 1),
                    aspp_rates=(2, 4, 6), decoder_channels=8, high_res_channels=4,
                    dropout_rate=0.0)
STEP_CONFIGS = {
    # name -> (model config kwargs for both packages, pad, residues per chain)
    "deeplab": (dict(interact_module_type="deeplab"), 32, (26, 22)),
    "tiled": (dict(tile_pair_map=True, tile_size=32), 64, (40, 36)),
}
SHORT_DECODER = dict(num_chunks=1, dilation_cycle=(1, 2))


def _step_configs(name):
    kw, _, _ = STEP_CONFIGS[name]
    jcfg = jax_cfg(norm_type="layer", **SHORT_DECODER)
    jcfg = dataclasses.replace(jcfg, gnn=dataclasses.replace(jcfg.gnn, num_layers=1))
    pcfg = port_cfg(norm_type="layer")
    pcfg = dataclasses.replace(pcfg, gnn=dataclasses.replace(pcfg.gnn, dropout_rate=0.0,
                                                             num_layers=1),
                               decoder=dataclasses.replace(pcfg.decoder, **SHORT_DECODER))
    if name == "deeplab":
        jcfg = dataclasses.replace(jcfg, deeplab=JaxDeepLabConfig(**TINY_DEEPLAB), **kw)
        pcfg = dataclasses.replace(pcfg, deeplab=DeepLabConfig(**TINY_DEEPLAB), **kw)
    else:
        jcfg, pcfg = dataclasses.replace(jcfg, **kw), dataclasses.replace(pcfg, **kw)
    return jcfg, pcfg


@functools.lru_cache(maxsize=None)
def _jax_step_fn(name):
    model = JaxDeepInteract(_step_configs(name)[0])

    def step(params, batch_stats, batch):
        state = types.SimpleNamespace(apply_fn=model.apply, batch_stats=batch_stats)
        return jax.value_and_grad(loss_and_updates, has_aux=True)(
            params, state, batch, False, jax.random.PRNGKey(0))

    return jax.jit(step)


@pytest.mark.parametrize("name", sorted(STEP_CONFIGS))
def test_train_step_matches_jax(name):
    """Loss within 1e-5 and every gradient within 1e-4, with layer norms in
    the encoder (well conditioned, as tests/test_torch_steps.py) and
    dropout 0."""
    jcfg, pcfg = _step_configs(name)
    _, pad, (n1, n2) = STEP_CONFIGS[name]
    jcx, cx = complexes(seed=12, pad=pad, n1=n1, n2=n2)
    variables = random_variables(jcfg, jcx, seed=12)
    (loss, _), grads = _jax_step_fn(name)(variables["params"], variables.get("batch_stats", {}),
                                          jcx)
    port = DeepInteract(pcfg)
    load_jax_variables(port, variables)
    metrics = train_step(create_train_state(port), cx)
    np.testing.assert_allclose(metrics["loss"], float(loss), **LOSS_TOL)
    ref = DeepInteract(pcfg)
    load_jax_variables(ref, {"params": grads})
    ref = ref.state_dict()
    for pname, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[pname].numpy(), err_msg=pname,
                                   **GRAD_TOL)
