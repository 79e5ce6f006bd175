"""The port's full model and predict entry point against the JAX package:
the forward on carried weights, the golden fixture's reference logits, the
split encode/decode, ``cli.predict`` on the CPU (also with
``--input_indep``), its refusal without a GPU, and the rule that the port
imports neither jax nor the JAX package."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from deepinteract_tpu.data.io import save_complex_npz as jax_save_complex_npz
from deepinteract_tpu.data.synthetic import random_raw_complex as jax_random_raw_complex
from deepinteract_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from deepinteract_tpu.models.geometric_transformer import GTConfig as JaxGTConfig
from deepinteract_tpu.models.model import DeepInteract as JaxDeepInteract
from deepinteract_tpu.models.model import ModelConfig as JaxModelConfig
from deepinteract_tpu.training.import_torch import convert_state_dict
from deepinteract_tpu_torch.cli import predict as port_predict
from deepinteract_tpu_torch.constants import NODE_COUNT_LIMIT
from deepinteract_tpu_torch.data.graph import ProteinGraph
from deepinteract_tpu_torch.models.decoder import DecoderConfig
from deepinteract_tpu_torch.models.geometric_transformer import GTConfig
from deepinteract_tpu_torch.models.model import DeepInteract, ModelConfig
from deepinteract_tpu_torch.weights import init_weights, load_jax_variables, save_npz
from test_golden_parity import _load_fixture
from torch_port_helpers import (CHUNKS, HEADS, HIDDEN, KNN, complexes, jax_cfg, port_cfg,
                                random_variables)

TOL = dict(rtol=1e-4, atol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def carried():
    """One complex and one random variables tree, in both packages."""
    jcx, cx = complexes(seed=5)
    variables = random_variables(jax_cfg(), jcx, seed=5)
    model = DeepInteract(port_cfg())
    load_jax_variables(model, variables)
    return jcx, cx, variables, model.eval()


def test_full_forward_matches_jax(carried):
    jcx, cx, variables, model = carried
    ref = JaxDeepInteract(jax_cfg()).apply(variables, jcx.graph1, jcx.graph2, train=False)
    with torch.no_grad():
        out = model(cx.graph1, cx.graph2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_split_encode_decode_equals_forward(carried):
    _, cx, _, model = carried
    with torch.no_grad():
        whole = model(cx.graph1, cx.graph2)
        f1, _ = model.encode(cx.graph1)
        f2, _ = model.encode(cx.graph2)
        split = model.decode(f1, f2, cx.graph1.node_mask, cx.graph2.node_mask)
    assert torch.equal(whole, split)


def test_golden_fixture_reference_logits():
    """The reference pipeline's own weights and logits
    (tests/golden/full_model_parity.npz): state dict -> JAX variables
    (training.import_torch) -> the port."""
    sd, cx, ref_logits, meta = _load_fixture()
    jcfg = JaxModelConfig(
        gnn=JaxGTConfig(num_layers=2, hidden=meta["hidden"], num_heads=meta["heads"],
                        dropout_rate=0.0, node_count_limit=meta["limit"],
                        attention_impl="jnp"),
        decoder=JaxDecoderConfig(num_chunks=meta["num_chunks"], num_channels=meta["hidden"]))
    variables, report = convert_state_dict(sd, jcfg, cx)
    assert not report.unconsumed
    model = DeepInteract(ModelConfig(
        gnn=GTConfig(hidden=meta["hidden"], num_heads=meta["heads"],
                     node_count_limit=meta["limit"]),
        decoder=DecoderConfig(num_chunks=meta["num_chunks"], num_channels=meta["hidden"])))
    load_jax_variables(model, variables)

    def graph(g):
        return ProteinGraph(**{name: torch.from_numpy(np.asarray(getattr(g, name)))
                               for name in ProteinGraph.__dataclass_fields__})

    g1, g2 = graph(cx.graph1), graph(cx.graph2)
    assert g1.nbr_idx.shape == (1, 26, KNN)
    with torch.no_grad():
        out = model.eval()(g1, g2).permute(0, 3, 1, 2).numpy()
    np.testing.assert_allclose(out, ref_logits, **TOL)


def test_predict_cli_on_cpu_matches_jax_softmax(tmp_path):
    """``cli.predict --device cpu --weights`` against the JAX predict path
    (default 64/64 bucketing, softmax, depad) on the same npz and weights.
    Both models keep the default node_count_limit, which the CLI uses."""
    from deepinteract_tpu.data.graph import stack_complexes
    from deepinteract_tpu.data.io import load_complex_npz, to_paired_complex

    raw = jax_random_raw_complex(26, 22, np.random.default_rng(7), knn=KNN)
    npz = tmp_path / "complex.npz"
    jax_save_complex_npz(str(npz), raw["graph1"], raw["graph2"], raw["examples"], "c7")
    batch = stack_complexes([to_paired_complex(load_complex_npz(str(npz)))])
    jcfg = jax_cfg(limit=NODE_COUNT_LIMIT)
    variables = random_variables(jcfg, batch, seed=7)
    logits = JaxDeepInteract(jcfg).apply(variables, batch.graph1, batch.graph2, train=False)
    ref = np.asarray(jax.nn.softmax(logits, axis=-1))[0, :26, :22, 1]

    weights = tmp_path / "weights.npz"
    save_npz(str(weights), variables)
    out_dir = tmp_path / "out"
    rc = port_predict.main([
        "--input_npz", str(npz), "--output_dir", str(out_dir), "--weights", str(weights),
        "--device", "cpu", "--num_gnn_hidden_channels", str(HIDDEN),
        "--num_gnn_attention_heads", str(HEADS), "--num_interact_layers", str(CHUNKS),
        "--num_interact_hidden_channels", str(HIDDEN)])
    assert rc == 0
    probs = np.load(out_dir / "contact_prob_map.npy")
    assert probs.shape == (26, 22)
    np.testing.assert_allclose(probs, ref, rtol=1e-5, atol=1e-5)
    for name in port_predict.REPRESENTATIONS:
        n = 26 if name.startswith("graph1") else 22
        assert np.load(out_dir / f"{name}.npy").shape[:2] in ((n, HIDDEN), (n, KNN))


def test_predict_cli_input_indep_matches_jax(tmp_path):
    """``cli.predict --input_indep`` (every input feature zeroed, the
    reference's control; F8) against the JAX predict path's
    ``to_paired_complex(raw, input_indep=True)`` on the same npz and
    weights: the written node and edge representations within 1e-4, and
    the contact map within 1e-4 plus four times the reference's own
    float32 spread. With every feature zero all nodes of a chain encode
    alike, so the pair map entering the decoder is constant and its first
    instance norm divides rounding noise by sqrt(eps) = 1e-3: the control's
    map is float32 noise in both packages (ROADMAP queue 3)."""
    from deepinteract_tpu.data.graph import stack_complexes
    from deepinteract_tpu.data.io import load_complex_npz, to_paired_complex

    raw = jax_random_raw_complex(26, 22, np.random.default_rng(9), knn=KNN)
    npz = tmp_path / "complex.npz"
    jax_save_complex_npz(str(npz), raw["graph1"], raw["graph2"], raw["examples"], "c9")
    batch = stack_complexes([to_paired_complex(load_complex_npz(str(npz)), input_indep=True)])
    jcfg = jax_cfg(limit=NODE_COUNT_LIMIT)
    variables = random_variables(jcfg, batch, seed=9)
    apply = jax.jit(lambda v: JaxDeepInteract(jcfg).apply(
        v, batch.graph1, batch.graph2, train=False, return_representations=True))

    def probs_of(v):
        logits, reps = apply(v)
        return np.asarray(jax.nn.softmax(logits, axis=-1))[0, :26, :22, 1], reps

    ref, reps = probs_of(variables)
    spread = 0.0
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        moved = jax.tree_util.tree_map(lambda a: np.asarray(a) * (
            1 + 1e-7 * rng.standard_normal(a.shape)).astype(np.float32), variables["params"])
        spread = max(spread, float(np.abs(probs_of(dict(variables, params=moved))[0]
                                          - ref).max()))

    weights = tmp_path / "weights.npz"
    save_npz(str(weights), variables)
    out_dir = tmp_path / "out"
    assert port_predict.main([
        "--input_npz", str(npz), "--output_dir", str(out_dir), "--weights", str(weights),
        "--input_indep", "--device", "cpu", "--num_gnn_hidden_channels", str(HIDDEN),
        "--num_gnn_attention_heads", str(HEADS), "--num_interact_layers", str(CHUNKS),
        "--num_interact_hidden_channels", str(HIDDEN)]) == 0
    for name, n in (("graph1_node_feats", 26), ("graph2_edge_feats", 22)):
        np.testing.assert_allclose(np.load(out_dir / f"{name}.npy"),
                                   np.asarray(reps[name])[0, :n], rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(np.load(out_dir / "contact_prob_map.npy"), ref, rtol=1e-4,
                               atol=1e-4 + 4 * spread)


def test_predict_refuses_to_run_without_gpu_unless_asked(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the refusal needs one without")
    rc = port_predict.main(["--input_npz", str(tmp_path / "x.npz"),
                            "--output_dir", str(tmp_path)])
    assert rc != 0
    assert "--device cpu" in capsys.readouterr().err


def test_seeded_init_is_deterministic_with_negative_positive_class_bias():
    a, b = DeepInteract(port_cfg()), DeepInteract(port_cfg())
    init_weights(a, 3)
    init_weights(b, 3)
    for (name, ta), tb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(ta, tb), name
    assert a.decoder.phase2_conv.bias.tolist() == [0.0, -7.0]
    _, cx = complexes(seed=8)
    with torch.no_grad():
        probs = torch.softmax(a.eval()(cx.graph1, cx.graph2), -1)[..., 1]
    assert torch.isfinite(probs).all()


def test_bfloat16_policy_runs_on_cpu(carried):
    _, cx, variables, _ = carried
    model = DeepInteract(port_cfg(compute_dtype="bfloat16"))
    load_jax_variables(model, variables)
    with torch.no_grad():
        logits, reps = model.eval()(cx.graph1, cx.graph2, return_representations=True)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    assert reps["graph1_node_feats"].dtype == torch.bfloat16


# The training lifecycle's, the model configurations', serving's, the
# split-phase subsystems', the fleet's, the training input path's, the
# featurization front end's, the ops tooling's, data-parallel training's and the
# serving mesh's modules, named so that the check below fails if one of them stops
# being importable on its own.
LIFECYCLE_MODULES = tuple(f"deepinteract_tpu_torch.{m}" for m in (
    "robustness.faults", "robustness.artifacts", "robustness.preemption",
    "training.checkpoint", "training.lr_finder", "cli.test",
    "models.vision", "models.tiled", "models.stem",
    "obs.metrics", "obs.spans", "obs.heartbeat", "robustness.retry",
    "training.import_torch", "training.supervisor", "cli.import_checkpoint",
    "serving.cache", "serving.admission", "serving.scheduler", "serving.graphs",
    "serving.engine", "serving.server", "obs.reqtrace", "cli.serve",
    "screening.scoring", "screening.embcache", "screening.manifest", "screening.library",
    "screening.runner", "data.packed", "calibration.calibrator", "index.format",
    "index.prefilter", "index.builder", "index.funnel", "assembly.runner",
    "cli.screen", "cli.index", "cli.query", "cli.assemble", "cli.calibrate",
    "serving.fleet", "serving.router", "serving.autoscaler", "serving.worker_stub",
    "obs.expfmt", "data.loader", "data.pipeline", "training.loop", "training.wandb_logger",
    "cli.train", "training.steps", "training.optim", "training.step_graphs",
    "robustness.guards", "models.layers",
    "pipeline.pdb", "pipeline.native", "pipeline.residue_features", "pipeline.postprocess",
    "pipeline.pair", "data.analysis", "data.convert", "cli.build_dataset", "cli.analyze",
    "obs.device", "obs.attribution", "obs.kernelquery", "cli.attribute", "cli.fsck",
    "parallel.multihost", "parallel.mesh", "parallel.train", "parallel.pair",
    "parallel.launch", "serving.group"))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import deepinteract_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, pair_shard_check, serve_mesh_check\n"
        f"missing = [m for m in {LIFECYCLE_MODULES!r} if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'flax'))"
        " or m == 'deepinteract_tpu' or m.startswith('deepinteract_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"
