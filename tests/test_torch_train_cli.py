"""``python -m deepinteract_tpu_torch.cli.train`` end to end on the CPU at
the tiny size, on a ``write_tiny_npz_dataset`` tree, and its refusal to
run without a GPU unless asked for the CPU."""

import ast
import math

import pytest
import torch

from deepinteract_tpu_torch.cli import train as train_cli
from deepinteract_tpu_torch.data.synthetic import write_tiny_npz_dataset

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
