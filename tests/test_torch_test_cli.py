"""The port's checkpoint-consuming CLIs on the CPU at the tiny size:
``cli.train --ckpt_dir`` (preempted through the fault plan, resumed,
fine-tuned, ``--find_lr``, the lifecycle flags), ``cli.test --ckpt_name`` against
``Trainer.evaluate`` of the restored state, ``cli.predict --ckpt_name``
against the restored model in memory, and their refusals."""

import numpy as np
import pytest
import torch

from deepinteract_tpu_torch.cli import predict as predict_cli
from deepinteract_tpu_torch.cli import test as test_cli
from deepinteract_tpu_torch.cli import train as train_cli
from deepinteract_tpu_torch.cli.args import loop_config_from_args, model_config_from_args
from deepinteract_tpu_torch.data.datasets import DIPSDataset
from deepinteract_tpu_torch.data.io import save_complex_npz
from deepinteract_tpu_torch.data.loader import BucketedLoader
from deepinteract_tpu_torch.data.synthetic import random_raw_complex, write_tiny_npz_dataset
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.robustness import faults
from deepinteract_tpu_torch.training.checkpoint import CheckpointConfig, Checkpointer
from deepinteract_tpu_torch.training.loop import LoopConfig, Trainer

MODEL = ["--num_gnn_hidden_channels", "16", "--num_gnn_attention_heads", "2",
         "--num_interact_layers", "2", "--num_interact_hidden_channels", "16"]
TINY = MODEL + ["--log_every", "0"]
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _clean_fault_state(monkeypatch):
    monkeypatch.delenv("DI_FAULTS", raising=False)
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny dataset and a 2-epoch ``cli.train`` run that checkpointed into
    ckpt/."""
    root = tmp_path_factory.mktemp("lifecycle")
    write_tiny_npz_dataset(str(root / "dips"), n_complexes=3)
    rc = train_cli.main(["--dips_root", str(root / "dips"), "--num_epochs", "2",
                         "--ckpt_dir", str(root / "ckpt"), *TINY, *CPU])
    assert rc == 0
    return root


def _restored_model(root):
    args = train_cli.parse_args(["--dips_root", str(root / "dips"), *TINY, *CPU])
    model = DeepInteract(model_config_from_args(args))
    Checkpointer(CheckpointConfig(directory=str(root / "ckpt"))).restore(
        model, which="best", partial=True)
    return model


def test_test_cli_equals_evaluate_of_the_restored_best_state(trained, tmp_path, capsys):
    csv = tmp_path / "top.csv"
    argv = ["--dips_root", str(trained / "dips"), "--ckpt_name", str(trained / "ckpt"),
            "--csv_out", str(csv), *TINY, *CPU]
    got = test_cli.run(test_cli.parse_args(argv))
    trainer = Trainer(_restored_model(trained), LoopConfig())
    loader = BucketedLoader(DIPSDataset(str(trained / "dips"), "test"))
    ref = trainer.evaluate(trainer.init_state(), loader, stage="test")
    assert got.keys() == ref.keys() and "test_ce" in got
    for key, value in ref.items():
        assert got[key] == value or (np.isnan(got[key]) and np.isnan(value)), key
    assert test_cli.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == f"wrote {csv}"
    assert [line.split(":")[0] for line in lines[:-1]] == sorted(ref)
    assert csv.read_text().splitlines()[1].endswith(",c0")


def test_predict_ckpt_name_equals_the_restored_model(trained, tmp_path):
    raw = random_raw_complex(26, 22, np.random.default_rng(2), knn=6)
    npz = tmp_path / "x.npz"
    save_complex_npz(str(npz), raw["graph1"], raw["graph2"], raw["examples"], "x")
    rc = predict_cli.main(["--input_npz", str(npz), "--output_dir", str(tmp_path / "out"),
                           "--ckpt_name", str(trained / "ckpt"), *MODEL, *CPU])
    assert rc == 0
    got = np.load(tmp_path / "out" / "contact_prob_map.npy")
    ref = predict_cli.predict_complex(predict_cli.load_complex_npz(str(npz)),
                                      _restored_model(trained), "cpu")["contact_prob_map"]
    assert got.shape == (26, 22) and np.array_equal(got, ref)
    with pytest.raises(SystemExit):
        predict_cli.main(["--input_npz", str(npz), "--ckpt_name", str(trained / "ckpt"),
                          "--weights", "w.npz", *MODEL, *CPU])


def test_train_cli_preempted_then_resumed_equals_the_uninterrupted_run(trained, tmp_path,
                                                                        capsys, monkeypatch):
    """DI_FAULTS preempts before epoch 1's second batch: the run prints the
    preempted line and exits 0; ``--resume`` finishes it, and its last/
    step equals the uninterrupted run's bitwise."""
    argv = ["--dips_root", str(trained / "dips"), "--num_epochs", "2",
            "--ckpt_dir", str(tmp_path), "--save_every_steps", "1", *TINY, *CPU]
    monkeypatch.setenv("DI_FAULTS", "train.sigterm=@5")
    faults.configure(None)
    assert train_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "training preempted (injected SIGTERM (fault plan)); checkpoint state is " \
           "flushed — rerun with --resume" in out
    monkeypatch.delenv("DI_FAULTS")
    faults.reset()
    assert train_cli.main(argv + ["--resume"]) == 0
    assert "resumed from epoch 1, batch 1" in capsys.readouterr().out
    ours = Checkpointer(CheckpointConfig(directory=str(tmp_path))).restore(None, which="last")
    ref = Checkpointer(CheckpointConfig(directory=str(trained / "ckpt"))).restore(
        None, which="last")
    for part in ("model", "optimizer"):
        assert torch.equal(torch.cat([t.flatten() for t in _tensors(ours[part])]),
                           torch.cat([t.flatten() for t in _tensors(ref[part])])), part


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree.float()]
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def test_train_cli_fine_tune_and_find_lr(trained, tmp_path, capsys):
    """--fine_tune from the trained checkpoint with --find_lr: the
    decoder's parameters stay as restored, the encoder moves, and the LR
    suggestion is printed; --fine_tune without --ckpt_name is an error."""
    rc = train_cli.main(["--dips_root", str(trained / "dips"), "--num_epochs", "1",
                         "--ckpt_dir", str(tmp_path), "--fine_tune", "--ckpt_name",
                         str(trained / "ckpt"), "--find_lr", *TINY, *CPU])
    assert rc == 0
    assert "lr_find suggestion:" in capsys.readouterr().out
    tuned = Checkpointer(CheckpointConfig(directory=str(tmp_path))).restore(None)["model"]
    source = _restored_model(trained).state_dict()
    for name, value in source.items():
        if name.startswith("decoder.") and not name.endswith(("running_mean", "running_var")):
            assert torch.equal(tuned[name], value), name
    assert any(not torch.equal(tuned[name], value) for name, value in source.items()
               if not name.startswith("decoder."))
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--fine_tune", *CPU])


def test_train_flags_reach_the_loop_config():
    args = train_cli.parse_args(["--stochastic_weight_avg", "--max_hours", "0.5",
                                 "--sync_checkpoint", "--no_preemption_guard",
                                 "--save_every_steps", "3", "--metric_to_track", "val_auroc",
                                 "--ckpt_dir", "d", "--data_skip_budget", "2"])
    cfg = loop_config_from_args(args)
    assert (cfg.swa, cfg.max_time_seconds, cfg.async_checkpoint, cfg.preemption_guard,
            cfg.save_every_steps, cfg.metric_to_track, cfg.ckpt_dir) == (
                True, 1800.0, False, False, 3, "val_auroc", "d")
    assert args.data_skip_budget == 2
    defaults = loop_config_from_args(train_cli.parse_args([]))
    assert (defaults.ckpt_dir, defaults.async_checkpoint, defaults.preemption_guard) == (
        "checkpoints", True, True)


def test_test_cli_refuses_a_reference_checkpoint(trained, tmp_path):
    """A reference ``model.ckpt`` is imported now (tests/test_torch_import.py);
    one that the safe ``torch.load`` cannot read is refused."""
    (tmp_path / "model.ckpt").write_bytes(b"not a checkpoint")
    with pytest.raises(SystemExit, match="weights_only"):
        test_cli.main(["--dips_root", str(trained / "dips"), "--ckpt_name", str(tmp_path),
                       *TINY, *CPU])


@pytest.mark.parametrize("cli", ["test", "predict"])
def test_checkpoint_clis_refuse_without_gpu_unless_asked(tmp_path, capsys, cli):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the refusal needs one without")
    if cli == "test":
        rc = test_cli.main(["--dips_root", str(tmp_path), "--ckpt_name", str(tmp_path)])
    else:
        rc = predict_cli.main(["--input_npz", str(tmp_path / "x.npz"),
                               "--ckpt_name", str(tmp_path)])
    assert rc != 0
    assert "--device cpu" in capsys.readouterr().err

