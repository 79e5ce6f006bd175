"""The port's reference-checkpoint importer (``training/import_torch.py``,
``weights.jax_variable_shapes``, ``cli/import_checkpoint.py``) against the
JAX package's: the same variables tree from the same reference state dict,
the golden fixture's reference logits through the port, the same
synthesized reference layout, strictness, and the CLIs end to end on the
CPU (import, then ``cli.predict --ckpt_name``, ``cli.test`` on a ``.ckpt``
and ``cli.train --fine_tune``)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from deepinteract_tpu.training.import_torch import convert_state_dict as jax_convert
from deepinteract_tpu.training.import_torch import (
    synthesize_reference_state_dict as jax_synthesize)
from deepinteract_tpu_torch.cli import import_checkpoint as import_cli
from deepinteract_tpu_torch.cli import predict as predict_cli
from deepinteract_tpu_torch.cli import test as test_cli
from deepinteract_tpu_torch.cli import train as train_cli
from deepinteract_tpu_torch.cli.args import model_config_from_args
from deepinteract_tpu_torch.cli.predict import load_model, predict_complex
from deepinteract_tpu_torch.data.datasets import DIPSDataset
from deepinteract_tpu_torch.data.graph import ProteinGraph
from deepinteract_tpu_torch.data.io import load_complex_npz, save_complex_npz
from deepinteract_tpu_torch.data.loader import BucketedLoader
from deepinteract_tpu_torch.data.synthetic import random_raw_complex, write_tiny_npz_dataset
from deepinteract_tpu_torch.models.decoder import DecoderConfig
from deepinteract_tpu_torch.models.geometric_transformer import GTConfig
from deepinteract_tpu_torch.models.model import DeepInteract, ModelConfig
from deepinteract_tpu_torch.training.import_torch import (convert_state_dict,
                                                          synthesize_reference_state_dict)
from deepinteract_tpu_torch.training.loop import Trainer
from deepinteract_tpu_torch.weights import _iter_leaves, load_jax_variables
from test_golden_parity import _load_fixture
from torch_port_helpers import complexes, jax_cfg, port_cfg

MODEL = ["--num_gnn_hidden_channels", "16", "--num_gnn_attention_heads", "2",
         "--num_interact_layers", "2", "--num_interact_hidden_channels", "16"]
CPU = ["--device", "cpu"]


def _configs(variant):
    """(JAX config, port config) of one importable configuration."""
    jcfg, pcfg = jax_cfg(), port_cfg()
    if variant == "layer_norm":
        jcfg, pcfg = jax_cfg(norm_type="layer"), port_cfg(norm_type="layer")
    elif variant == "gcn_attention":
        jcfg = dataclasses.replace(jax_cfg(use_attention=True), gnn_layer_type="gcn")
        pcfg = dataclasses.replace(pcfg, gnn_layer_type="gcn", decoder=dataclasses.replace(
            pcfg.decoder, use_attention=True))
    return jcfg, pcfg


def _flat(tree):
    return {path: np.asarray(leaf) for path, leaf in _iter_leaves(tree)}


@functools.lru_cache(maxsize=None)
def _jax_reference(variant):
    """(reference state dict, JAX variables, JAX report) of one variant:
    the JAX package's synthesizer and importer, each sizing its tree with
    ``jax.eval_shape``."""
    jcfg, _ = _configs(variant)
    jcx, _ = complexes(seed=11)
    sd = jax_synthesize(jcfg, jcx, seed=11)
    return (sd, *jax_convert(sd, jcfg, jcx))


@pytest.mark.parametrize("variant", ["batch_norm", "layer_norm", "gcn_attention"])
def test_convert_state_dict_gives_the_jax_tree_bitwise(variant):
    sd, ref, ref_report = _jax_reference(variant)
    got, report = convert_state_dict(sd, _configs(variant)[1])
    ref, got = _flat(ref), _flat(got)
    assert got.keys() == ref.keys()
    for path, value in ref.items():
        assert got[path].dtype == value.dtype and np.array_equal(got[path], value), path
    assert (report.consumed, report.ignored, report.unconsumed) == (
        ref_report.consumed, ref_report.ignored, ref_report.unconsumed)


@pytest.mark.parametrize("variant", ["batch_norm", "gcn_attention"])
def test_synthesized_reference_state_dict_has_the_jax_keys_and_shapes(variant):
    ref = _jax_reference(variant)[0]
    got = synthesize_reference_state_dict(_configs(variant)[1], seed=12)
    assert got.keys() == ref.keys()
    assert all(np.shape(got[k]) == np.shape(ref[k]) for k in ref)


def _golden_model():
    sd, cx, ref_logits, meta = _load_fixture()
    cfg = ModelConfig(
        gnn=GTConfig(hidden=meta["hidden"], num_heads=meta["heads"],
                     node_count_limit=meta["limit"]),
        decoder=DecoderConfig(num_chunks=meta["num_chunks"], num_channels=meta["hidden"]))
    return sd, cx, ref_logits, cfg


def _golden_graphs(cx):
    return [ProteinGraph(**{name: torch.from_numpy(np.asarray(getattr(g, name)))
                            for name in ProteinGraph.__dataclass_fields__})
            for g in (cx.graph1, cx.graph2)]


def test_golden_reference_state_dict_through_the_port_importer():
    """The reference pipeline's own weights and logits: the port's
    importer, then the port's model, within 1e-4."""
    sd, cx, ref_logits, cfg = _golden_model()
    variables, report = convert_state_dict(sd, cfg)
    assert not report.unconsumed and len(report.consumed) + len(report.ignored) == len(sd)
    model = DeepInteract(cfg)
    load_jax_variables(model, variables)
    with torch.no_grad():
        out = model.eval()(*_golden_graphs(cx)).permute(0, 3, 1, 2).numpy()
    np.testing.assert_allclose(out, ref_logits, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fault", ["missing", "unmapped"])
def test_strict_import_raises(fault):
    sd, _, _, cfg = _golden_model()
    if fault == "missing":
        sd.pop("interact_module.phase2_conv.weight")
        match = "absent"
    else:
        sd["interact_module.extra_head.weight"] = np.zeros(3, np.float32)
        match = "not mapped"
    with pytest.raises(KeyError, match=match):
        convert_state_dict(sd, cfg)
    variables, report = convert_state_dict(sd, cfg, strict=False)
    assert report.unconsumed == (["interact_module.extra_head.weight"]
                                 if fault == "unmapped" else [])


def test_importer_refuses_deeplab():
    with pytest.raises(ValueError, match="dilated"):
        convert_state_dict({}, dataclasses.replace(port_cfg(), interact_module_type="deeplab"))


def _write_ckpt(path, sd, hparams):
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()},
                "hyper_parameters": hparams}, str(path))


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """A reference ``.ckpt`` of the tiny model (its width from the
    Lightning hyper_parameters), imported by the CLI."""
    root = tmp_path_factory.mktemp("import")
    args = train_cli.parse_args(MODEL + CPU)
    sd = synthesize_reference_state_dict(model_config_from_args(args), seed=13)
    ckpt = root / "LitGINI.ckpt"
    _write_ckpt(ckpt, sd, {"num_gnn_hidden_channels": 16, "num_gnn_attention_heads": 2,
                           "num_interact_layers": 2, "num_interact_hidden_channels": 16,
                           "gnn_layer_type": "geotran", "interact_module_type": "dilated"})
    assert import_cli.main(["--ckpt", str(ckpt), "--out_dir", str(root / "imported"),
                            *CPU]) == 0
    write_tiny_npz_dataset(str(root / "dips"), n_complexes=3)
    model = import_cli.imported_model(sd, model_config_from_args(args), log=lambda s: None)
    return root, ckpt, model.eval()


def test_import_cli_then_predict_ckpt_name(imported, tmp_path):
    root, _, model = imported
    raw = random_raw_complex(30, 24, np.random.default_rng(13))
    npz = tmp_path / "c.npz"
    save_complex_npz(str(npz), raw["graph1"], raw["graph2"], raw["examples"], "c")
    assert predict_cli.main(["--input_npz", str(npz), "--output_dir", str(tmp_path / "out"),
                             "--ckpt_name", str(root / "imported"), *MODEL, *CPU]) == 0
    ref = predict_complex(load_complex_npz(str(npz)), model, "cpu")["contact_prob_map"]
    assert np.array_equal(np.load(tmp_path / "out" / "contact_prob_map.npy"), ref)


def test_test_cli_takes_a_reference_ckpt_directly(imported, tmp_path):
    root, ckpt, model = imported
    metrics = test_cli.run(test_cli.parse_args([
        "--dips_root", str(root / "dips"), "--ckpt_name", str(ckpt), "--csv_out",
        str(tmp_path / "top.csv"), *MODEL, *CPU]))
    ref = Trainer(model).evaluate(Trainer(model).init_state(),
                                  BucketedLoader(DIPSDataset(str(root / "dips"), "test")),
                                  stage="test")
    assert metrics.keys() == ref.keys()
    assert all(np.isclose(metrics[k], v, rtol=0, atol=0, equal_nan=True)
               for k, v in ref.items())


def test_fine_tune_from_the_imported_directory(imported, tmp_path):
    root, _, model = imported
    args = train_cli.parse_args(["--dips_root", str(root / "dips"), "--num_epochs", "1",
                                 "--fine_tune", "--ckpt_name", str(root / "imported"),
                                 "--ckpt_dir", str(tmp_path / "ft"), "--log_every", "0",
                                 *MODEL, *CPU])
    trainer_model = DeepInteract(model_config_from_args(args))
    state = Trainer(trainer_model).init_state(fine_tune_from=str(root / "imported"))
    for name, tensor in model.state_dict().items():
        assert torch.equal(state.model.state_dict()[name], tensor), name
    history, test = train_cli.run(args)
    assert history[0]["train_steps"] > 0 and np.isfinite(history[0]["train_loss"])


def test_hparams_fill_defaults_and_explicit_flags_win():
    parser_args = ["--num_gnn_hidden_channels", "32"]
    from deepinteract_tpu_torch.cli.args import build_parser
    parser = build_parser("x")
    args = parser.parse_args(parser_args)
    import_cli.apply_hparams(args, {"num_gnn_hidden_channels": 16,
                                    "num_gnn_attention_heads": 8,
                                    "gnn_layer_type": "GCN"}, parser, log=lambda s: None)
    assert (args.num_gnn_hidden_channels, args.num_gnn_attention_heads,
            args.gnn_layer_type) == (32, 8, "gcn")


def test_golden_checkpoint_through_the_clis(tmp_path):
    """The golden state dict as a Lightning ``.ckpt`` -> ``cli.import_checkpoint``
    -> the ``cli.predict --ckpt_name`` loader, on the fixture's graphs."""
    sd, cx, ref_logits, cfg = _golden_model()
    ckpt = tmp_path / "golden.ckpt"
    _write_ckpt(ckpt, sd, {})
    flags = ["--num_gnn_hidden_channels", "16", "--num_gnn_attention_heads", "2",
             "--num_interact_layers", "2", "--num_interact_hidden_channels", "16",
             "--node_count_limit", "32"]
    assert import_cli.main(["--ckpt", str(ckpt), "--out_dir", str(tmp_path / "imp"),
                            *flags, *CPU]) == 0
    model = load_model(model_config_from_args(predict_cli_args(flags)), "cpu",
                       ckpt_name=str(tmp_path / "imp"))
    with torch.no_grad():
        out = model(*_golden_graphs(cx)).permute(0, 3, 1, 2).numpy()
    np.testing.assert_allclose(out, ref_logits, rtol=1e-4, atol=1e-4)


def predict_cli_args(flags):
    from deepinteract_tpu_torch.cli.args import build_parser
    return build_parser("x").parse_args(flags)
