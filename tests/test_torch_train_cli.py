"""``python -m deepinteract_tpu_torch.cli.train`` end to end on the CPU at
the tiny size, on a ``write_tiny_npz_dataset`` tree, its refusal to run
without a GPU unless asked for the CPU, and its default test CSV against
the JAX CLI's."""

import ast
import math
import os

import pytest
import torch

from deepinteract_tpu_torch.cli import train as train_cli
from deepinteract_tpu_torch.data.synthetic import write_tiny_npz_dataset
from deepinteract_tpu_torch.weights import load_jax_variables

TINY = ["--num_gnn_hidden_channels", "16", "--num_gnn_attention_heads", "2",
        "--num_interact_layers", "2", "--num_interact_hidden_channels", "16"]


def test_train_cli_one_epoch_on_cpu(tmp_path, capsys):
    write_tiny_npz_dataset(str(tmp_path / "dips"))
    csv = tmp_path / "test_top_metrics.csv"
    rc = train_cli.main(["--dips_root", str(tmp_path / "dips"), "--num_epochs", "1",
                         "--device", "cpu", "--log_every", "1", "--weight_classes",
                         "--test_csv", str(csv), "--ckpt_dir", str(tmp_path / "ckpt"), *TINY])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    steps = [line for line in lines if line.startswith("epoch 0 step")]
    assert len(steps) == 5  # five train complexes, batch 1
    (epoch_line,) = [line for line in lines if line.startswith("epoch 0: ")]
    val = dict(kv.split("=") for kv in epoch_line.split()[2:])
    assert math.isfinite(float(val["train_loss"])) and math.isfinite(float(val["val_ce"]))
    test = ast.literal_eval(lines[-1])
    assert math.isfinite(test["test_ce"]) and 0.0 <= test["med_test_auroc"] <= 1.0
    assert csv.read_text().splitlines()[1].endswith(",c0")


def test_train_cli_history_and_early_stop(tmp_path):
    """run() returns one history entry per epoch; patience 1 with a
    min_delta no epoch can beat stops after the second epoch."""
    write_tiny_npz_dataset(str(tmp_path), n_complexes=2)
    args = train_cli.parse_args(["--dips_root", str(tmp_path), "--num_epochs", "4",
                                 "--patience", "1", "--min_delta", "1e9", "--device", "cpu",
                                 "--ckpt_dir", str(tmp_path / "ckpt"), *TINY])
    history, test = train_cli.run(args)
    assert [h["epoch"] for h in history] == [0, 1]
    assert all(h["train_steps"] == 2 and h["train_skipped_steps"] == 0 for h in history)
    assert set(test) >= {"test_ce", "med_test_top_10_prec", "med_test_auroc"}


def test_train_cli_refuses_without_gpu_unless_asked(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the refusal needs one without")
    rc = train_cli.main(["--dips_root", str(tmp_path)])
    assert rc != 0
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    [], ["--pos_prob_threshold", "0.3", "--no_nonfinite_guard", "--max_bad_steps", "4",
         "--heartbeat_seconds", "2.5"]], ids=["defaults", "set"])
def test_guard_and_heartbeat_flags_parse_to_the_jax_fields(flags):
    """--pos_prob_threshold, --no_nonfinite_guard, --max_bad_steps and
    --heartbeat_seconds reach the same LoopConfig fields in both packages."""
    from deepinteract_tpu.cli.args import build_parser as jax_build_parser
    from deepinteract_tpu.cli.args import configs_from_args

    from deepinteract_tpu_torch.cli.args import loop_config_from_args

    ref = configs_from_args(jax_build_parser("x").parse_args(flags))[2]
    got = loop_config_from_args(train_cli.parse_args(flags))
    fields = ("pos_prob_threshold", "nonfinite_guard", "max_bad_steps", "heartbeat_seconds")
    assert [getattr(got, f) for f in fields] == [getattr(ref, f) for f in fields]


def test_deterministic_flag_holds_for_the_run_only(tmp_path, monkeypatch):
    """``--deterministic`` turns deterministic algorithms on around the run
    (and sets cuBLAS's workspace), then restores the caller's setting."""
    write_tiny_npz_dataset(str(tmp_path / "dips"), n_complexes=2)
    seen = []
    real_run = train_cli._run
    monkeypatch.setattr(train_cli, "_run", lambda args: seen.append(
        torch.are_deterministic_algorithms_enabled()) or real_run(args))
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    args = train_cli.parse_args(["--dips_root", str(tmp_path / "dips"), "--num_epochs", "1",
                                 "--ckpt_dir", str(tmp_path / "ck"), "--deterministic",
                                 "--log_every", "0", "--device", "cpu", *TINY])
    train_cli.run(args)
    assert seen == [True] and not torch.are_deterministic_algorithms_enabled()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"


def test_train_cli_writes_the_test_csv_where_the_jax_cli_does(tmp_path, monkeypatch):
    """Without ``--test_csv``, ``cli.train`` writes the test split's
    per-target top-k CSV to ``test_top_metrics.csv`` in the working
    directory, as the JAX CLI does (F9). With the fit skipped and the same
    random weights in both packages, its rows are those of the JAX
    ``Trainer.evaluate`` CSV on the same test split: the same header,
    indices and targets, every value within 1e-4."""
    import dataclasses

    import jax
    import numpy as np

    from deepinteract_tpu.cli.args import build_parser as jax_build_parser
    from deepinteract_tpu.cli.args import configs_from_args
    from deepinteract_tpu.data.datasets import PICPDataModule
    from deepinteract_tpu.data.loader import BucketedLoader
    from deepinteract_tpu.models.model import DeepInteract as JaxDeepInteract
    from deepinteract_tpu.training.loop import Trainer as JaxTrainer
    from deepinteract_tpu.training.steps import TrainState as JaxTrainState
    from torch_port_helpers import complexes, random_variables

    root = tmp_path / "dips"
    write_tiny_npz_dataset(str(root))
    work = tmp_path / "work"
    work.mkdir()
    jcfg, optim_cfg, loop_cfg = configs_from_args(jax_build_parser("x").parse_args(TINY))
    jcfg = dataclasses.replace(jcfg, decoder=dataclasses.replace(jcfg.decoder,
                                                                 depad_stats=False))
    variables = random_variables(jcfg, complexes(seed=21)[0], seed=21)

    monkeypatch.chdir(work)
    monkeypatch.setattr(train_cli, "init_weights",
                        lambda model, seed: load_jax_variables(model, variables))
    monkeypatch.setattr(train_cli.Trainer, "fit", lambda self, state, *a, **kw: (state, []))
    assert train_cli.main(["--dips_root", str(root), "--num_epochs", "1", "--device", "cpu",
                           "--ckpt_dir", str(tmp_path / "ckpt"), *TINY]) == 0
    port_rows = [row.split(",") for row in (work / "test_top_metrics.csv").read_text()
                 .splitlines()]

    model = JaxDeepInteract(jcfg)
    state = JaxTrainState.create(apply_fn=model.apply, params=variables["params"],
                                 tx=__import__("optax").identity(),
                                 batch_stats=variables["batch_stats"],
                                 dropout_rng=jax.random.PRNGKey(0))
    test_loader = BucketedLoader(PICPDataModule(dips_root=str(root)).test, batch_size=1)
    trainer = JaxTrainer(model, loop_cfg, optim_cfg, log_fn=lambda s: None)
    trainer.evaluate(state, test_loader, stage="test", targets=test_loader.targets(),
                     csv_path=str(tmp_path / "jax.csv"))
    jax_rows = [row.split(",") for row in (tmp_path / "jax.csv").read_text().splitlines()]
    assert port_rows[0] == jax_rows[0] and len(port_rows) == len(jax_rows) > 1
    for got, ref in zip(port_rows[1:], jax_rows[1:]):
        assert (got[0], got[-1]) == (ref[0], ref[-1])
        np.testing.assert_allclose([float(x or "nan") for x in got[1:-1]],
                                   [float(x or "nan") for x in ref[1:-1]], rtol=1e-4,
                                   atol=1e-4, err_msg=got[-1])
