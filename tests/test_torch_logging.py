"""The port's metric writers (training/wandb_logger.py, cli/args.py's
make_metric_writer and default_experiment_name) against the JAX
package's: mirrors of ``tests/test_logging.py`` with ``wandb`` stubbed
(it is not installed), each call sequence checked on both packages."""

import builtins
import sys
import types

import numpy as np
import pytest

from deepinteract_tpu.cli import args as jax_args
from deepinteract_tpu.training import wandb_logger as jax_wandb_logger
from deepinteract_tpu_torch.cli import args as port_args
from deepinteract_tpu_torch.cli import train as train_cli
from deepinteract_tpu_torch.training import wandb_logger

PACKAGES = [wandb_logger, jax_wandb_logger]


def _install_fake_wandb():
    calls = {"init": [], "log": [], "images": [], "finished": [], "artifacts": [],
             "logged_artifacts": []}
    mod = types.ModuleType("wandb")

    class _Run:
        id = "abc123"

        def finish(self):
            calls["finished"].append(True)

        def log_artifact(self, artifact, aliases=None):
            calls["logged_artifacts"].append((artifact.dirs, tuple(aliases)))

    class _Image:
        def __init__(self, arr):
            calls["images"].append(np.asarray(arr).shape)

    class _Artifact:
        def __init__(self, name, type):
            calls["artifacts"].append((name, type))
            self.dirs = []

        def add_dir(self, d):
            self.dirs.append(d)

    def init(**kwargs):
        calls["init"].append(kwargs)
        return _Run()

    def log(payload, step=None):
        calls["log"].append((payload, step))

    mod.init, mod.log, mod.Image, mod.Artifact = init, log, _Image, _Artifact
    sys.modules["wandb"] = mod
    return calls


@pytest.fixture(autouse=True)
def _no_wandb_left_behind():
    yield
    sys.modules.pop("wandb", None)


def _writer_calls(pkg, tmp_path):
    calls = _install_fake_wandb()
    w = pkg.make_wandb_writer("proj", run_name="run1", config={"lr": 1e-3})
    assert w is not None
    w.add_scalar("val_ce", 0.5, 3)
    w.add_image("map", np.zeros((4, 5, 1), np.uint8), 2, dataformats="HWC")
    w.add_image("map_chw", np.zeros((1, 4, 5), np.uint8), 2, dataformats="CHW")
    w.log_checkpoint_artifact(str(tmp_path))
    w.close()
    return calls


def test_wandb_writer_protocol_matches_jax(tmp_path):
    calls = _writer_calls(wandb_logger, tmp_path)
    assert calls["init"] == [{"project": "proj", "config": {"lr": 1e-3}, "name": "run1"}]
    assert calls["log"][0] == ({"val_ce": 0.5}, 3)
    assert calls["images"] == [(4, 5, 1), (4, 5, 1)]  # CHW arrives as HWC
    assert calls["artifacts"] == [("model-abc123", "model")]
    assert calls["logged_artifacts"] == [([str(tmp_path)], ("best", "latest"))]
    assert calls["finished"] == [True]
    ref = _writer_calls(jax_wandb_logger, tmp_path)
    assert {k: v for k, v in calls.items() if k != "log"} == \
        {k: v for k, v in ref.items() if k != "log"}
    assert [step for _, step in calls["log"]] == [step for _, step in ref["log"]]


@pytest.mark.parametrize("pkg", PACKAGES, ids=["port", "jax"])
def test_missing_wandb_degrades_to_none(pkg, monkeypatch, caplog):
    sys.modules.pop("wandb", None)
    real_import = builtins.__import__

    def block_wandb(name, *a, **k):
        if name == "wandb":
            raise ImportError("No module named 'wandb'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", block_wandb)
    with caplog.at_level("WARNING"):
        assert pkg.make_wandb_writer("proj") is None
    assert any("wandb is not installed" in r.message for r in caplog.records)


@pytest.mark.parametrize("pkg", PACKAGES, ids=["port", "jax"])
def test_fanout_writer(pkg):
    class Rec:
        def __init__(self):
            self.scalars, self.images = [], []

        def add_scalar(self, tag, value, step):
            self.scalars.append((tag, value, step))

        def add_image(self, tag, img, step, dataformats="HWC"):
            self.images.append((tag, step, dataformats))

    a, b = Rec(), Rec()
    fan = pkg.FanoutWriter([a, None, b])
    fan.add_scalar("x", 1.0, 0)
    fan.add_image("m", np.zeros((2, 2, 1)), 1)
    fan.log_checkpoint_artifact("/nowhere")  # writers without artifacts are passed over
    fan.close()
    assert a.scalars == b.scalars == [("x", 1.0, 0)]
    assert a.images == b.images == [("m", 1, "HWC")]


def test_registry_writer_mirrors_scalars():
    from deepinteract_tpu_torch.obs import metrics as obs_metrics

    wandb_logger.RegistryWriter().add_scalar("val_ce", 0.25, 7)
    reg = obs_metrics.get_registry()
    assert reg.gauge("di_train_metric", labelnames=("metric",)).value(metric="val_ce") == 0.25
    assert reg.gauge("di_train_last_epoch").value() == 7.0


def test_cli_writer_composition(tmp_path):
    """--use_wandb and --tb_log_dir give a fan-out of both, in the JAX
    CLI's order; one flag gives that writer alone; none gives None."""
    _install_fake_wandb()
    argv = ["--use_wandb", "--tb_log_dir", str(tmp_path / "tb")]
    ours = port_args.make_metric_writer(train_cli.parse_args(argv))
    ref = jax_args.make_metric_writer(jax_args.build_parser("t").parse_args(argv))
    assert isinstance(ours, wandb_logger.FanoutWriter) and len(ours.writers) == 2
    assert [type(w).__name__ for w in ours.writers] == [type(w).__name__ for w in ref.writers]
    ours.add_scalar("loss", 1.0, 0)
    ours.close()
    ref.close()
    only_tb = port_args.make_metric_writer(train_cli.parse_args(["--tb_log_dir",
                                                                 str(tmp_path / "tb2")]))
    assert type(only_tb).__name__ == "SummaryWriter"
    only_tb.close()
    assert port_args.make_metric_writer(train_cli.parse_args([])) is None


@pytest.mark.parametrize("argv", [[], ["--experiment_name", "custom"],
                                  ["--batch_size", "2", "--num_gnn_layers", "3",
                                   "--num_interact_hidden_channels", "64"]])
def test_experiment_name_convention(argv):
    ours = port_args.default_experiment_name(train_cli.parse_args(argv))
    assert ours == jax_args.default_experiment_name(jax_args.build_parser("t").parse_args(argv))
    if not argv:
        assert ours == "LitGINI-b1-gl2-n128-e128-il14-i128"
