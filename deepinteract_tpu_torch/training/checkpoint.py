"""Checkpoints: best-k by the tracked metric, the last epoch, the newest
mid-epoch position; verified restore with a last-good walk.

Port of ``deepinteract_tpu/training/checkpoint.py`` over plain step
directories in place of orbax: ``<root>/{best,last,mid}/<step>/``.

* ``best/`` keeps the top ``save_top_k`` steps by the tracked metric (mode
  'min' iff its name contains 'ce'; a missing or non-finite value ranks
  worst), ``last/`` keeps the newest step and ``mid/`` the newest
  intra-epoch save. Retention follows orbax's: a step at or below a
  root's newest retained step is not saved again, ``best/`` ranks by a
  stable sort (a tie keeps the later step), and the newest step has no
  protection from its rank.
* ``mid/`` step numbers are resume positions: ``epoch * 10**8 + batch``
  (:func:`encode_midepoch_step`, :func:`decode_position`); ``best/`` and
  ``last/`` steps are epoch boundaries (the step is the epoch to resume
  at).
* A step is written into ``<root>/<step>.<pid>.tmp/``: the payload
  (``state.pt``, ``torch.save`` of a state dict on the CPU), then the
  commit marker (``_CHECKPOINT_METADATA``: the step and its metrics, the
  counterpart of orbax's), then one ``rename`` to ``<step>/``, and then
  its tree integrity sidecar (``<step>.integrity.json``,
  ``robustness/artifacts.py``). A step directory without the marker is a
  torn save.
* :meth:`Checkpointer.restore` verifies a step before ``torch.load``
  reads it (``weights_only=True``, mapped onto the target's device, so a
  step written on the GPU restores on the CPU and the other way round).
  Without an explicit ``step`` it walks the candidates: verified steps
  before sidecar-less ones, a corrupt step quarantined aside
  (``<step>.corrupt-<ts>``) and the next one tried. An explicit ``step``
  that is corrupt raises :class:`CorruptArtifact` instead.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import shutil
from typing import Dict, List, Optional, Tuple

import torch

from deepinteract_tpu_torch.robustness import artifacts, faults
from deepinteract_tpu_torch.robustness.artifacts import CorruptArtifact, StaleArtifact

logger = logging.getLogger(__name__)

CHECKPOINT_KIND = artifacts.CHECKPOINT_KIND
COMMIT_MARKER = "_CHECKPOINT_METADATA"
PAYLOAD = "state.pt"
ROOTS = ("best", "last", "mid")
MIDEPOCH_STRIDE = 10 ** 8


def encode_midepoch_step(epoch: int, batch_index: int) -> int:
    if not 0 <= batch_index < MIDEPOCH_STRIDE:
        raise ValueError(f"batch_index {batch_index} outside [0, {MIDEPOCH_STRIDE})")
    return int(epoch) * MIDEPOCH_STRIDE + int(batch_index)


def decode_position(which: Optional[str], step: int) -> Tuple[int, int]:
    """Step -> (resume epoch, resume batch): ``mid/`` steps carry both,
    ``best/`` and ``last/`` steps are epoch boundaries."""
    if which == "mid":
        return int(step) // MIDEPOCH_STRIDE, int(step) % MIDEPOCH_STRIDE
    return int(step), 0


def metric_mode(metric_name: str) -> str:
    """'min' iff the tracked metric's name contains 'ce'."""
    return "min" if "ce" in metric_name else "max"


def _device_of(target) -> torch.device:
    model = getattr(target, "model", target)
    if isinstance(model, torch.nn.Module):
        return next(model.parameters()).device
    return torch.device("cpu")


def _apply(target, payload: Dict, partial: bool) -> None:
    """Load ``payload`` into ``target``: a train state (everything, or its
    model only with ``partial``), a module (its part of the payload), or
    None (nothing)."""
    if target is None:
        return
    if isinstance(target, torch.nn.Module):
        target.load_state_dict(payload["model"])
    elif partial:
        target.model.load_state_dict(payload["model"])
    else:
        target.load_state_dict(payload)


@dataclasses.dataclass
class CheckpointConfig:
    directory: str
    metric_to_track: str = "val_ce"
    save_top_k: int = 3


class Checkpointer:
    """The three roots (``ROOTS``) under ``cfg.directory``; see the module
    docstring."""

    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        # What the last restore() loaded: the walk may land on an older step
        # than latest_step(), and the resume position follows the restored
        # state.
        self.last_restored_step: Optional[int] = None
        self.last_restored_which: Optional[str] = None
        self.root = os.path.abspath(cfg.directory)
        self._sign = 1.0 if metric_mode(cfg.metric_to_track) == "max" else -1.0
        for name in ROOTS:
            os.makedirs(self._dir(name), exist_ok=True)
        # Startup sweep of what killed writers left: step tmp directories and
        # sidecar tmps. The root is shared (trainer_state.json lives in it),
        # so only names this class writes are touched.
        artifacts.sweep_tmp(self.root, prefix="trainer_state.json")
        for name in ROOTS:
            d = self._dir(name)
            artifacts.sweep_tmp(d, contains=artifacts.SIDECAR_SUFFIX + ".")
            for entry in os.listdir(d):
                if entry.endswith(artifacts.TMP_SUFFIX) and os.path.isdir(os.path.join(d, entry)):
                    shutil.rmtree(os.path.join(d, entry), ignore_errors=True)

    # -- layout --------------------------------------------------------------

    def _dir(self, which: str) -> str:
        return os.path.join(self.root, which)

    def step_dir(self, which: str, step: int) -> str:
        return os.path.join(self._dir(which), str(int(step)))

    def steps(self, which: str) -> List[int]:
        """Retained steps of a root, ascending (quarantined and tmp entries
        are not steps)."""
        try:
            names = os.listdir(self._dir(which))
        except OSError:
            return []
        return sorted(int(n) for n in names
                      if n.isdigit() and os.path.isdir(os.path.join(self._dir(which), n)))

    def _metrics(self, which: str, step: int) -> Optional[Dict[str, float]]:
        try:
            with open(os.path.join(self.step_dir(which, step), COMMIT_MARKER)) as f:
                return json.load(f).get("metrics")
        except (OSError, ValueError):
            return None

    def _score(self, metrics: Dict[str, float]) -> float:
        v = metrics.get(self.cfg.metric_to_track, math.nan)
        # Non-finite or missing ranks worst after the sign flip: a NaN
        # val_ce or a +inf val_auroc is never "best".
        return self._sign * v if math.isfinite(v) else -math.inf

    def _ranked_best(self) -> List[int]:
        """best/ steps with metrics, worst first (a stable sort of the
        ascending steps: among equal scores the later step ranks higher)."""
        scored = [(s, m) for s in self.steps("best")
                  for m in [self._metrics("best", s)] if m is not None]
        return [s for s, m in sorted(scored, key=lambda sm: self._score(sm[1]))]

    # -- saving --------------------------------------------------------------

    def _write_step(self, which: str, step: int, payload: Dict,
                    metrics: Optional[Dict[str, float]]) -> None:
        retained = self.steps(which)
        if retained and retained[-1] >= step:
            return
        final = self.step_dir(which, step)
        tmp = f"{final}.{os.getpid()}{artifacts.TMP_SUFFIX}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, PAYLOAD), "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, COMMIT_MARKER), "w") as f:
            json.dump({"step": int(step), "metrics": metrics}, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)
        artifacts.fsync_dir(self._dir(which))
        try:
            artifacts.write_tree_sidecar(final, CHECKPOINT_KIND,
                                         extra={"step": int(step), "which": which})
        except OSError as exc:  # a full disk leaves the step unverified, not lost
            logger.warning("could not write integrity sidecar for %s: %s", final, exc)
        self._retain(which)

    def _retain(self, which: str) -> None:
        steps = self.steps(which)
        k = self.cfg.save_top_k
        if which == "best":
            ranked = self._ranked_best()
            if len(steps) <= k:
                keep = set(steps)
            elif k == 0:
                keep = set()
            else:  # the k best; steps without metrics stay (orbax's BestN)
                keep = set(ranked[-k:]) | (set(steps) - set(ranked))
        else:
            keep = set(steps[-1:])
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.step_dir(which, s), ignore_errors=True)
                sidecar = artifacts.sidecar_path(self.step_dir(which, s))
                if os.path.exists(sidecar):
                    os.unlink(sidecar)

    def save(self, step: int, state: Dict, metrics: Dict) -> None:
        """An epoch-boundary save of the state dict ``state`` (tensors on
        the CPU) as ``step``, into best/ (ranked by ``metrics``) and last/."""
        clean = {k: float(v) for k, v in metrics.items()
                 if isinstance(v, (int, float)) and not isinstance(v, bool)}
        self._write_step("best", step, state, clean)
        self._write_step("last", step, state, None)

    def save_midepoch(self, epoch: int, batch_index: int, state: Dict) -> None:
        """An intra-epoch save into mid/ only (best/ needs a metric; last/
        keeps its epoch-boundary meaning); the step encodes the position."""
        self._write_step("mid", encode_midepoch_step(epoch, batch_index), state, None)

    def wait(self) -> None:
        """Saves here are synchronous; this writes the sidecars a failed
        write left out and drops sidecars whose step is gone."""
        for which in ROOTS:
            d = self._dir(which)
            for s in self.steps(which):
                if not os.path.exists(artifacts.sidecar_path(self.step_dir(which, s))):
                    try:
                        artifacts.write_tree_sidecar(self.step_dir(which, s), CHECKPOINT_KIND,
                                                     extra={"step": s, "which": which})
                    except OSError as exc:
                        logger.warning("could not write integrity sidecar for %s: %s",
                                       self.step_dir(which, s), exc)
            for name in os.listdir(d):
                if name.endswith(artifacts.SIDECAR_SUFFIX) and not os.path.exists(
                        os.path.join(d, name[:-len(artifacts.SIDECAR_SUFFIX)])):
                    os.unlink(os.path.join(d, name))

    def close(self) -> None:
        self.wait()

    # -- queries -------------------------------------------------------------

    def best_step(self) -> Optional[int]:
        ranked = self._ranked_best()
        return ranked[-1] if ranked else None

    def latest_step(self) -> Optional[int]:
        for which in ("last", "best"):
            steps = self.steps(which)
            if steps:
                return steps[-1]
        return None

    def has_restorable(self) -> bool:
        """Any retained step in mid/, last/ or best/ (the --resume probe)."""
        return bool(self.steps("mid")) or self.latest_step() is not None

    # -- restoring -----------------------------------------------------------

    def _verify_step(self, step_dir: str) -> str:
        """'verified', or 'unverified' (no sidecar), or raises on positive
        evidence of corruption."""
        if faults.fire("checkpoint.restore"):
            raise CorruptArtifact(step_dir, "injected checkpoint.restore fault")
        if not os.path.isdir(step_dir):
            raise FileNotFoundError(step_dir)
        if not os.path.exists(os.path.join(step_dir, COMMIT_MARKER)):
            raise CorruptArtifact(step_dir, f"torn save: {COMMIT_MARKER} missing")
        manifest = artifacts.verify_tree(step_dir, kind=CHECKPOINT_KIND, require_sidecar=False)
        return "verified" if manifest is not None else "unverified"

    def _restore_candidates(self, which: str) -> List[Tuple[str, int]]:
        """(root, step) in walk order: the requested root newest first, then
        the sibling; 'best' leads with the metric-best step; 'mid' (the
        resume entry) merges all roots by decoded position, newest first,
        preferring mid/ over last/ over best/ at one position."""
        if which == "mid":
            rank = {"mid": 2, "last": 1, "best": 0}
            cands = [(name, s) for name in ROOTS for s in self.steps(name)]
            return sorted(cands, key=lambda c: (decode_position(*c), rank[c[0]]), reverse=True)
        best = self.steps("best")[::-1]
        last = self.steps("last")[::-1]
        if which == "last":
            return [("last", s) for s in last] + [("best", s) for s in best]
        top = self.best_step()
        if top is not None:
            best = [top] + [s for s in best if s != top]
        return [("best", s) for s in best] + [("last", s) for s in last]

    def _load(self, which: str, step: int, target, partial: bool) -> Dict:
        payload = torch.load(os.path.join(self.step_dir(which, step), PAYLOAD),
                             map_location=_device_of(target), weights_only=True)
        _apply(target, payload, partial)
        self.last_restored_step, self.last_restored_which = int(step), which
        return payload

    def restore(self, target=None, step: Optional[int] = None, which: str = "best",
                partial: bool = False) -> Dict:
        """Load a step into ``target`` (a ``TrainState``; with ``partial``
        its model only; or an ``nn.Module``, which takes the model part) and
        return the loaded state dict. A load error after verification
        propagates: it means the target does not match the saved state,
        and quarantining would empty the root one healthy step at a time."""
        if step is not None:
            root = which if which in ROOTS else "last"
            step_dir = self.step_dir(root, step)
            try:
                self._verify_step(step_dir)
            except (CorruptArtifact, StaleArtifact) as exc:
                artifacts.quarantine(step_dir, CHECKPOINT_KIND, exc.reason)
                raise CorruptArtifact(step_dir, f"requested step {step} is corrupt "
                                                f"({exc.reason}); quarantined")
            payload = self._load(root, step, target, partial)
            self.last_restored_which = which
            return payload
        unverified = []
        candidates = self._restore_candidates(which)
        for name, s in candidates:
            step_dir = self.step_dir(name, s)
            try:
                status = self._verify_step(step_dir)
            except FileNotFoundError:
                continue
            except (CorruptArtifact, StaleArtifact) as exc:
                artifacts.quarantine(step_dir, CHECKPOINT_KIND, exc.reason)
                continue
            if status == "unverified":
                unverified.append((name, s))
                continue
            return self._restored(name, s, target, partial, candidates)
        for name, s in unverified:
            logger.warning("restoring UNVERIFIED checkpoint %s (no integrity sidecar)",
                           self.step_dir(name, s))
            return self._restored(name, s, target, partial, candidates)
        raise FileNotFoundError(
            f"no restorable checkpoint under {self.cfg.directory} ({which}): every retained "
            "step was missing or corrupt (quarantined: see *.corrupt-* aside)")

    def _restored(self, name: str, step: int, target, partial: bool, candidates) -> Dict:
        payload = self._load(name, step, target, partial)
        if candidates[0] != (name, step):
            logger.warning("checkpoint fallback: restored %s/%s instead of the newest candidate "
                           "%s/%s (corrupt steps quarantined along the walk)", name, step,
                           *candidates[0])
        return payload
