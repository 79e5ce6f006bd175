"""Metric writers: Weights & Biases, the telemetry registry, and fan-out.

Port of ``deepinteract_tpu/training/wandb_logger.py``. The trainer's
writer protocol is two methods, ``add_scalar(tag, value, step)`` and
``add_image(tag, img, step, dataformats)`` (``training/loop.py``: the epoch
scalars and the viz images), which a TensorBoard ``SummaryWriter`` already
has; :class:`WandbWriter` adapts ``wandb.log`` to it, :class:`RegistryWriter`
mirrors every scalar into the process's metric registry, and
:class:`FanoutWriter` broadcasts to several writers.

``wandb`` is optional: :func:`make_wandb_writer` returns None with a
warning when it is missing or its init fails, as the JAX package does.
Restoring a checkpoint artifact needs the network and is not ported.
"""

from __future__ import annotations

import logging
from typing import Optional

logger = logging.getLogger(__name__)


class WandbWriter:
    """The writer protocol over ``wandb.log``."""

    def __init__(self, project: str, run_name: Optional[str] = None,
                 config: Optional[dict] = None, mode: Optional[str] = None):
        import wandb  # optional dependency

        self._wandb = wandb
        kwargs = {"project": project, "config": config or {}}
        if run_name:
            kwargs["name"] = run_name
        if mode:
            kwargs["mode"] = mode  # 'offline' under --offline
        self.run = wandb.init(**kwargs)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._wandb.log({tag: value}, step=step)

    def add_image(self, tag: str, img, step: int, dataformats: str = "HWC") -> None:
        if dataformats == "CHW":  # wandb.Image takes HWC arrays
            img = img.transpose(1, 2, 0)
        self._wandb.log({tag: self._wandb.Image(img)}, step=step)

    def log_checkpoint_artifact(self, ckpt_dir: str, aliases=("best", "latest")) -> None:
        """Upload a checkpoint directory as the run's ``model-<run_id>``
        artifact (the convention of Lightning's ``WandbLogger(log_model=True)``)."""
        artifact = self._wandb.Artifact(f"model-{self.run.id}", type="model")
        artifact.add_dir(ckpt_dir)
        self.run.log_artifact(artifact, aliases=list(aliases))

    def close(self) -> None:
        self.run.finish()


class RegistryWriter:
    """Every scalar into the ``di_train_metric{metric=...}`` gauge and its
    step into ``di_train_last_epoch`` (``obs/metrics.py``), so the last
    epoch's metrics can be read without a logging backend. Images are not
    mirrored."""

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        from deepinteract_tpu_torch.obs import metrics as obs_metrics

        obs_metrics.gauge("di_train_metric", "Last logged value of each trainer scalar",
                          labelnames=("metric",)).set(float(value), metric=tag)
        obs_metrics.gauge("di_train_last_epoch",
                          "Epoch of the last logged scalar").set(float(step))

    def add_image(self, tag, img, step, dataformats="HWC") -> None:
        pass


class FanoutWriter:
    """Writer calls broadcast to several writers; ``None`` entries are
    dropped, so one configured writer sees the calls it would alone."""

    def __init__(self, writers):
        self.writers = [w for w in writers if w is not None]

    def add_scalar(self, tag, value, step):
        for w in self.writers:
            w.add_scalar(tag, value, step)

    def add_image(self, tag, img, step, dataformats="HWC"):
        for w in self.writers:
            w.add_image(tag, img, step, dataformats=dataformats)

    def log_checkpoint_artifact(self, ckpt_dir, aliases=("best", "latest")):
        for w in self.writers:
            if hasattr(w, "log_checkpoint_artifact"):
                w.log_checkpoint_artifact(ckpt_dir, aliases=aliases)

    def close(self):
        for w in self.writers:
            if hasattr(w, "close"):
                w.close()


def make_wandb_writer(project: str, run_name: Optional[str] = None,
                      config: Optional[dict] = None,
                      offline: bool = False) -> Optional[WandbWriter]:
    """A :class:`WandbWriter`, or None with a warning when ``wandb`` is
    missing or its init fails."""
    try:
        return WandbWriter(project, run_name, config, mode="offline" if offline else None)
    except ImportError:
        logger.warning("wandb is not installed; --use_wandb ignored (TensorBoard logging "
                       "via --tb_log_dir still works)")
        return None
    except Exception as exc:  # an init or network failure must not end training
        logger.warning("wandb.init failed (%s); continuing without W&B", exc)
        return None
