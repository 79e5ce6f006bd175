"""The training loop: epochs, validation, early stopping, checkpoints,
resume, SWA, dispatch runs, the input pipeline and telemetry.

Port of ``deepinteract_tpu/training/loop.py``: a
:class:`Trainer` that runs train epochs of :func:`~.steps.train_step`
under the non-finite guard, evaluates the reference's metric suite
(median over complexes; L = n1 + n2 at validation, min(n1, n2) at test)
after each epoch, and stops early on the tracked metric (patience 5,
min_delta 5e-6, mode 'min' iff the name contains 'ce').

Dispatch: consecutive same-shape batches form runs of up to
``steps_per_dispatch`` K (:func:`_shape_runs`). A run of exactly K
batches is one dispatch: one placement, then
:func:`~.steps.multi_train_step`, which on the card replays the key's
train-step graph K times (``training/step_graphs.py``: one CUDA graph of
the whole step per bucket key, captured at the key's first dispatch) and
on the CPU runs the same step body K times. Nothing is read on the host
inside a run: its [K] metrics are copied to pinned host memory without
blocking, and read after the next dispatch has been enqueued, as the JAX
loop defers its scanned dispatch's fetch; then they are logged in plan
order (loss ledger, skipped steps, heartbeat, ``log_every`` lines, the
``max_bad_steps`` abort, which therefore lands one dispatch late, as in
JAX). A mid-epoch save, the end of the epoch, a preemption and any other
exception flush the pending run first. A shorter run (a remainder, a
shape change, K = 1) is dispatched batch by batch, each step a replay of
the same graph and its metrics read right after it. The preemption poll,
the mid-epoch save check (position = batches dispatched), the profile
tick and the ``step`` span happen once per dispatch. Evaluation groups
same-shape runs of ``eval_batches_per_dispatch``, replays the key's eval
graph per batch into the run's [K] outputs and copies them to the host
once. ``LoopConfig.step_graphs=False`` runs the bodies eagerly on the
card instead (the reference the graphs are checked against).

Placement (``data/pipeline.py``): inline at the dispatch site, or with
``device_prefetch`` on the placement thread (pinned memory, a side CUDA
stream, an event per run), at most the loader's ``prefetch`` runs ahead.

With ``LoopConfig.ckpt_dir`` it checkpoints (``training/checkpoint.py``):
epoch ``e``'s end is saved as step ``e + 1`` into best/ and last/, and the
``trainer_state.json`` sidecar holds the early-stopping counters (and the
epoch's telemetry) as of that boundary; ``save_every_steps`` adds
mid-epoch saves to mid/ with the loader cursor in the sidecar.
``fit(resume=True)`` restores the newest position and reproduces the
uninterrupted run. A preemption (SIGTERM, or the ``train.sigterm`` fault
site) stops the loop before the next dispatch, drains the save in flight
and raises ``TrainingPreempted``. SWA averages the parameters of the last
epochs and refreshes the batch statistics. With ``heartbeat_seconds`` a
heartbeat file (``obs/heartbeat.py``) beats from a daemon thread, and the
loop stamps its progress on every train step, eval dispatch, epoch
boundary and mid-epoch save: the signal the training supervisor
(``training/supervisor.py``) reads to tell a hung run from a live one.

Telemetry: phases run inside ``obs/spans.py`` spans (epoch -> step ->
{data_wait, h2d, device_step}, plus eval and checkpoint), written to
``<ckpt_dir>/obs/events.jsonl`` with ``span_log``; each epoch's
``tele_*`` decomposition goes into the history and the sidecar; the
``di_train_*_total`` counters count steps, skips, aborts and epochs; the
epoch scalars go through the metric writer and the registry
(``training/wandb_logger.py``), with contact-map images every
``viz_every_n_epochs``; ``profile_dir`` captures train dispatches
``[1, 1 + profile_steps)`` with ``torch.profiler`` as a phase-labeled
Chrome trace, attributed on the spot into the ``di_train_profile_*``
gauges (``obs/attribution.py``). An abort on ``max_bad_steps`` writes a
diagnostics JSON first.

Data parallel (``mesh``, a ``parallel.mesh.DataMesh``; the JAX trainer
with a mesh): every rank runs this loop on its slice of the same global
plan, and each train step is the global batch's (``parallel/train.py``).
Rank 0 alone keeps the checkpointer, the sidecar, the span log, the
metric writer and the visualisations; every rank beats its own
``heartbeat_p{rank}.json``. A resume restores on rank 0 and broadcasts
the scalars, the partial epoch's loss ledger and the state, written in
place into the tensors the captured graphs address. Preemption is agreed
at epoch boundaries by an all-gather of the local flag (a rank-local
raise would strand its peers in the next collective); evaluation stays
replicated, and its first batch and the loader's length are checked
across ranks. SWA refreshes the batch statistics over the global batch.

Data sources are callables ``epoch -> iterable of PairedComplex`` (the
loader re-shuffles per epoch) or plain sequences of padded batches.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from deepinteract_tpu_torch.data.graph import PairedComplex
from deepinteract_tpu_torch.data.pipeline import BatchPlacement, placed_runs, tensors
from deepinteract_tpu_torch.models.layers import DropoutKey, dropout_rng
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.obs import metrics as obs_metrics
from deepinteract_tpu_torch.obs import spans as obs_spans
from deepinteract_tpu_torch.obs.heartbeat import Heartbeat
from deepinteract_tpu_torch.parallel import multihost
from deepinteract_tpu_torch.parallel.mesh import DataMesh, data_parallel
from deepinteract_tpu_torch.parallel.pair import pair_sharded
from deepinteract_tpu_torch.robustness import artifacts, faults
from deepinteract_tpu_torch.robustness.guards import (NonFiniteTrainingError,
                                                      dump_diagnostics, summarize_batch)
from deepinteract_tpu_torch.robustness.preemption import PreemptionGuard, TrainingPreempted
from deepinteract_tpu_torch.training import metrics as M
from deepinteract_tpu_torch.training.checkpoint import (CheckpointConfig, Checkpointer,
                                                        decode_position, metric_mode)
from deepinteract_tpu_torch.training.optim import OptimConfig
from deepinteract_tpu_torch.training.step_graphs import StepGraphs
from deepinteract_tpu_torch.training.steps import (TrainState, create_train_state, eval_step,
                                                   multi_eval_step, multi_train_step)
from deepinteract_tpu_torch.training.wandb_logger import FanoutWriter, RegistryWriter

DataSource = Union[Sequence[PairedComplex], Callable[[int], Iterable[PairedComplex]]]
SIDECAR_KIND = "trainer-state"

_STEPS_TOTAL = obs_metrics.counter(
    "di_train_steps_total", "Train steps whose metrics reached the host")
_SKIPPED_TOTAL = obs_metrics.counter(
    "di_train_skipped_steps_total", "Optimizer updates skipped by the non-finite guard")
_NONFINITE_ABORTS = obs_metrics.counter(
    "di_train_nonfinite_aborts_total",
    "Runs aborted after max_bad_steps consecutive non-finite steps")
_EPOCHS_TOTAL = obs_metrics.counter("di_train_epochs_total", "Completed training epochs")


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    num_epochs: int = 50
    metric_to_track: str = "val_ce"
    patience: int = 5
    min_delta: float = 5e-6
    ckpt_dir: Optional[str] = None
    save_top_k: int = 3
    seed: int = 42
    weight_classes: bool = False
    pos_prob_threshold: float = 0.5
    log_every: int = 100
    max_time_seconds: Optional[float] = None
    # Stochastic weight averaging: the running mean of the parameters of
    # each epoch from ceil(swa_epoch_start * epochs) on replaces the
    # trained ones when the loop ends.
    swa: bool = False
    swa_epoch_start: float = 0.8
    # Skip the optimizer update of a step whose loss or gradients are not
    # finite, and abort after max_bad_steps consecutive skips.
    nonfinite_guard: bool = True
    max_bad_steps: int = 10
    # SIGTERM/SIGINT handlers around fit: stop before the next step, flush
    # the newest checkpoint, raise TrainingPreempted.
    preemption_guard: bool = True
    # Mid-epoch save cadence in train steps (0: epoch boundaries only).
    save_every_steps: int = 0
    # Write the epoch-boundary save on a worker thread while the next
    # epoch trains. The state is copied to host memory first, on the loop's
    # thread, so the JAX package's fallback for a device snapshot that
    # exhausts device memory has no counterpart here.
    async_checkpoint: bool = True
    # Write <ckpt_dir>/obs/heartbeat_p{rank}.json every N seconds from a
    # daemon thread (0: no heartbeat): host, span path, progress step and time.
    heartbeat_seconds: float = 0.0
    # Log predicted and true contact-map images of the first validation
    # complex to the metric writer every N epochs (0: off).
    viz_every_n_epochs: int = 0
    # Train steps per dispatch: a run of this many consecutive same-shape
    # batches is placed once and stepped as one dispatch; shorter runs go
    # batch by batch. 1: one dispatch per step.
    steps_per_dispatch: int = 1
    # Eval batches per dispatch: same-shape runs whose outputs reach the
    # host in one copy. 1: batch by batch.
    eval_batches_per_dispatch: int = 8
    # Write the phase spans to <ckpt_dir>/obs/events.jsonl (when ckpt_dir is
    # set and no sink is configured already).
    span_log: bool = True
    # Capture a torch.profiler trace of train dispatches [1, 1 +
    # profile_steps) of the run (dispatch 0 pays the warm-up) into
    # profile_dir, with the spans as profiler ranges. None: off.
    profile_dir: Optional[str] = None
    profile_steps: int = 3
    # Place each run on the placement thread (pinned memory, a side CUDA
    # stream) while the previous dispatch runs, at most the loader's
    # prefetch depth of runs ahead. Values are unchanged.
    device_prefetch: bool = False
    # On the card, replay one CUDA graph of the train step and one of the
    # eval step per bucket key (training/step_graphs.py); False runs the
    # same step bodies eagerly. Ignored on the CPU, which runs them eagerly.
    step_graphs: bool = True


class EarlyStopping:
    """Stop after ``patience`` consecutive epochs without an improvement
    of at least ``min_delta``. A non-finite value counts against patience
    and never becomes the best."""

    def __init__(self, mode: str, patience: int, min_delta: float):
        self.mode = mode
        self.patience = patience
        self.min_delta = min_delta
        self.best = math.inf if mode == "min" else -math.inf
        self.stale_epochs = 0

    def update(self, value: float) -> bool:
        """Record one epoch's value; True when training should stop."""
        improved = math.isfinite(value) and (
            value < self.best - self.min_delta if self.mode == "min"
            else value > self.best + self.min_delta)
        if improved:
            self.best = value
            self.stale_epochs = 0
        else:
            self.stale_epochs += 1
        return self.stale_epochs >= self.patience


@dataclasses.dataclass
class ResumeCursor:
    """Where a resumed fit starts: the epoch and batch decoded from the
    restored step, and, in mid-epoch, the interrupted epoch's loss ledger
    and skip counts from the sidecar."""
    epoch: int = 0
    batch: int = 0
    skips_used: int = 0
    skipped_steps: int = 0
    losses: List[float] = dataclasses.field(default_factory=list)


class _Fetch:
    """A dispatch's [K] step metrics on their way to the host: on the card
    a non-blocking copy into pinned memory behind an event, read by
    :meth:`rows` (the dispatch's one host read, made once the next
    dispatch is enqueued); on the CPU the values themselves."""

    def __init__(self, metrics: Dict[str, torch.Tensor]):
        self.names = list(metrics)
        values = torch.stack(list(metrics.values()), dim=1)
        self.event = None
        if values.is_cuda:
            self.host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
            self.host.copy_(values, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = values

    def rows(self) -> List[Dict[str, float]]:
        """One metrics dict per step, in order (waits for the copy)."""
        if self.event is not None:
            self.event.synchronize()
        return [dict(zip(self.names, row)) for row in self.host.tolist()]


def _iter_data(data: DataSource, epoch: int) -> Iterable[PairedComplex]:
    return data(epoch) if callable(data) else data


def _shape_runs(items: Iterable[PairedComplex], k: int):
    """Consecutive same-shape batches (every tensor's shape equal) in runs
    of up to ``k``. Runs shorter than ``k`` (remainders, shape changes, or
    ``k == 1``) are dispatched batch by batch by the callers."""
    buffer: List[PairedComplex] = []
    buffer_key = None
    for item in items:
        key = tuple(tuple(t.shape) for t in tensors(item))
        if buffer and key != buffer_key:
            yield buffer
            buffer = []
        buffer_key = key
        buffer.append(item)
        if len(buffer) == k:
            yield buffer
            buffer = []
    if buffer:
        yield buffer


def _complex_ce(logits: np.ndarray, examples: np.ndarray, mask: np.ndarray) -> float:
    """Per-complex cross entropy over its example list."""
    ex = examples[mask]
    sel = logits[ex[:, 0], ex[:, 1]]  # [M, 2]
    sel = sel - sel.max(axis=-1, keepdims=True)
    logp = sel - np.log(np.sum(np.exp(sel), axis=-1, keepdims=True))
    return float(-np.mean(logp[np.arange(len(ex)), ex[:, 2]]))


def host_snapshot(state: TrainState) -> Dict:
    """``state.state_dict()`` with every tensor copied to host memory: what
    a checkpoint writes, safe from the next step's in-place updates."""
    def copy(value):
        if isinstance(value, torch.Tensor):
            return value.detach().to("cpu", copy=True)
        if isinstance(value, dict):
            return {k: copy(v) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return type(value)(copy(v) for v in value)
        return value
    return copy(state.state_dict())


def sidecar_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "trainer_state.json")


def write_sidecar(ckpt_dir: str, payload: Dict[str, Any]) -> None:
    """The loop's bookkeeping beside the checkpoint roots, with an
    integrity sidecar. ``json`` writes a fresh stopper's +-inf as
    ``Infinity`` (the JAX package's encoding, which both read back)."""
    artifacts.atomic_write_artifact(sidecar_path(ckpt_dir), json.dumps(payload), SIDECAR_KIND)


def read_sidecar(ckpt_dir: str) -> Optional[Dict[str, Any]]:
    """None when absent or corrupt (a corrupt one is quarantined): the
    restored step is the source of truth, and without the sidecar a resume
    only loses the early-stopping counters and the partial epoch's loss
    ledger."""
    path = sidecar_path(ckpt_dir)
    if not os.path.exists(path):
        return None
    try:
        raw = artifacts.verify_read(path, kind=SIDECAR_KIND, require_sidecar=False)
        return json.loads(raw.decode("utf-8"))
    except (artifacts.ArtifactError, UnicodeDecodeError, ValueError) as exc:
        artifacts.quarantine(path, SIDECAR_KIND, str(exc))
        return None
    except OSError:
        return None


class _Saver:
    """Epoch-boundary saves: synchronous, or (``async_``) on one worker
    thread with at most one save in flight; a worker's error re-raises at
    the next submit or drain."""

    def __init__(self, ckpt: Checkpointer, async_: bool):
        self.ckpt = ckpt
        self.pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-save") \
            if async_ else None
        self.pending: Optional[Future] = None

    def submit(self, step: int, state: TrainState, metrics: Dict) -> None:
        self.drain()
        snapshot = host_snapshot(state)  # before the next step moves the weights
        if self.pool is None:
            self.ckpt.save(step, snapshot, metrics)
        else:
            self.pending = self.pool.submit(self.ckpt.save, step, snapshot, dict(metrics))

    def drain(self) -> None:
        if self.pending is not None:
            pending, self.pending = self.pending, None
            pending.result()

    def close(self) -> None:
        try:
            self.drain()
        finally:
            if self.pool is not None:
                self.pool.shutdown(wait=True)


class Trainer:
    """Runs train and validation epochs of a :class:`DeepInteract` on the
    device its parameters are on. ``metric_writer`` (``add_scalar`` /
    ``add_image``: a TensorBoard writer, :class:`~.wandb_logger.WandbWriter`
    or a fan-out of them) receives the epoch scalars and viz images.
    ``mesh`` makes the train steps data-parallel over its ranks."""

    def __init__(self, model: DeepInteract, loop_cfg: LoopConfig = LoopConfig(),
                 optim_cfg: Optional[OptimConfig] = None,
                 log_fn: Callable[[str], None] = print, metric_writer=None,
                 mesh: Optional[DataMesh] = None):
        self.model = model
        self.mesh = mesh
        self.rank = 0 if mesh is None else mesh.rank
        self.world = 1 if mesh is None else mesh.world
        self.cfg = loop_cfg
        self.optim_cfg = optim_cfg or OptimConfig()
        self.log = log_fn
        self.metric_writer = metric_writer
        # Epoch scalars reach the registry too, whatever writer is set.
        self._scalar_writer = FanoutWriter([metric_writer, RegistryWriter()])
        # The guard of the running fit (None outside fit or when off).
        self._preempt: Optional[PreemptionGuard] = None
        # Train steps run by this trainer (a resumed fit runs only the
        # steps after its checkpoint).
        self.steps_run = 0
        # The running fit's heartbeat (None outside fit or when off).
        self._heartbeat: Optional[Heartbeat] = None
        # --profile_dir window: train dispatches [1, 1 + profile_steps) of
        # the run (the dispatch count is run-wide, not per epoch).
        self._profiler = None
        self._profile_started = False
        self._profile_done = loop_cfg.profile_dir is None
        self._profile_remaining = 0
        self._profile_device: Optional[torch.device] = None
        self._dispatch_count = 0
        # The placement stage of the running fit (_install_device_prefetch):
        # inline, the placement thread's, and its depth (0: inline).
        self._placement: Optional[BatchPlacement] = None
        self._prefetch_placement: Optional[BatchPlacement] = None
        self._prefetch_depth = 0
        # The step graphs of the state being trained (on the card, with
        # LoopConfig.step_graphs): built at its first dispatch.
        self._graphs: Optional[StepGraphs] = None

    def step_graphs(self, state: TrainState) -> Optional[StepGraphs]:
        """The step-graph inventory of ``state`` (a new one for a new
        state), or None on the CPU or with ``step_graphs`` off."""
        if not self.cfg.step_graphs or next(state.model.parameters()).device.type != "cuda":
            return None
        if self._graphs is None or self._graphs.state is not state:
            self._graphs = StepGraphs(state, self.cfg.weight_classes, self.cfg.nonfinite_guard,
                                      self.mesh)
        return self._graphs

    def _progress(self, **fields) -> None:
        if self._heartbeat is not None:
            self._heartbeat.progress(**fields)

    def init_state(self, fine_tune_from: Optional[str] = None) -> TrainState:
        """The train state around the model's current weights, seeded (for
        dropout) from ``LoopConfig.seed``. ``fine_tune_from`` (a checkpoint
        directory) restores the model from its best/ step and freezes the
        decoder, the reference's fine-tune mode."""
        state = create_train_state(self.model, self.cfg.seed, self.optim_cfg,
                                   frozen_prefixes=("decoder",) if fine_tune_from else ())
        if fine_tune_from:
            Checkpointer(CheckpointConfig(directory=fine_tune_from)).restore(
                state, which="best", partial=True)
        return state

    def evaluate(self, state: TrainState, data: DataSource, stage: str = "val",
                 targets: Optional[List[str]] = None,
                 csv_path: Optional[str] = None) -> Dict[str, float]:
        """The reference metric suite over ``data``, median over complexes
        (``{stage}_ce`` is the mean), with ``stage`` picking the L
        convention. Same-shape runs of ``eval_batches_per_dispatch``
        batches are evaluated back to back (on the card, each a replay of
        its key's eval graph) and their probabilities and logits copied to
        the host at once; each complex's metrics read its own batch's
        slice. ``csv_path`` writes the per-target top-k CSV."""
        per_complex: List[Dict[str, float]] = []

        def consume(batch: PairedComplex, probs: np.ndarray, logits: np.ndarray) -> None:
            for b in range(probs.shape[0]):
                examples = batch.examples[b].numpy()
                mask = batch.example_mask[b].numpy()
                pos_probs, labels = M.gather_pair_predictions(probs[b], examples, mask)
                per_complex.append(M.complex_metrics(
                    pos_probs, labels, int(batch.graph1.num_nodes[b]),
                    int(batch.graph2.num_nodes[b]), stage=stage,
                    threshold=self.cfg.pos_prob_threshold,
                    ce=_complex_ce(logits[b], examples, mask)))

        k = max(1, self.cfg.eval_batches_per_dispatch)
        device = next(state.model.parameters()).device
        graphs = self.step_graphs(state)
        checked = self.world <= 1
        for run in _shape_runs(_iter_data(data, 0), k):
            if not checked:
                checked = True
                self._check_ranks_agree(data, run[0])
            self._check_preempt()
            # Eval dispatches are progress too: a long validation must not
            # read as a hung step loop to the supervisor.
            self._progress(phase=f"eval:{stage}")
            groups = [[b] for b in run] if len(run) < max(k, 2) else [run]
            for group in groups:
                outs = multi_eval_step(state, [b.to(device) for b in group],
                                       self.cfg.weight_classes, graphs, self.mesh)
                # [K, 2, B, L1, L2, 2]: the group's probabilities and logits
                # in one copy.
                host = torch.stack([outs["probs"], outs["logits"]], dim=1).float().cpu().numpy()
                for j, batch in enumerate(group):
                    consume(batch, host[j, 0], host[j, 1])
        if csv_path:
            names = targets or [f"complex_{i}" for i in range(len(per_complex))]
            M.write_topk_csv(per_complex, names, csv_path)
        return {(f"med_{stage}_{k[4:]}" if k.startswith("med_") else f"{stage}_{k}"): v
                for k, v in M.aggregate_median(per_complex).items()}

    def _check_ranks_agree(self, data: DataSource, batch: PairedComplex) -> None:
        """Evaluation is replicated: every rank must feed the same batches.
        Checked on the first batch with the loader's length, on every rank
        (a collective of the host group): ranks with different lengths would
        otherwise leave the loop at different points."""
        sizer = getattr(data, "num_batches", None)
        try:
            n_batches = float(sizer() if callable(sizer) else len(data))  # type: ignore[arg-type]
        except TypeError:
            n_batches = -1.0  # an unsized source: the first batch only
        cm = batch.contact_map
        multihost.assert_same_across_hosts(
            [float(batch.graph1.num_nodes.sum()), float(batch.graph2.num_nodes.sum()),
             *map(float, cm.shape), float(cm.sum()), n_batches],
            "evaluate: ranks fed different first batches or loader lengths - the eval "
            "loaders must be the same (unsharded) on every rank")

    def _check_preempt(self, epoch_boundary: bool = False) -> None:
        """The preemption poll: at every dispatch for one process; with
        several, only at epoch boundaries and by an all-gather of the local
        flag, so every rank raises together."""
        if self._preempt is None:
            return
        if self.world > 1:
            if not epoch_boundary:
                return
            if multihost.any_across_hosts(self._preempt.requested) and \
                    not self._preempt.requested:
                self._preempt.request("preemption requested on a peer rank")
        self._preempt.check()

    def _epoch_source(self, data: DataSource, epoch: int, start_batch: int, skips_used: int):
        """The epoch's batches from a mid-epoch cursor: a loader with a
        cursor skips the paid prefix unloaded, any other source loads and
        drops it."""
        if not start_batch and not skips_used:
            return iter(_iter_data(data, epoch))
        if callable(getattr(data, "iter_epoch", None)):
            return data.iter_epoch(epoch, start_batch=start_batch, skips_used=skips_used)
        source = iter(_iter_data(data, epoch))
        for _ in range(start_batch):
            next(source, None)
        return source

    def _install_device_prefetch(self, train_data: DataSource, device: torch.device) -> None:
        """This fit's placement stage, and its mode logged once: inline,
        or with ``device_prefetch`` on the placement thread at most the
        source's ``prefetch`` depth of runs ahead (2 for a source without
        one; a loader with ``prefetch=0`` keeps placement inline)."""
        k = max(1, self.cfg.steps_per_dispatch)
        self._placement = BatchPlacement(device, k, transfer=False)
        self._prefetch_placement = None
        depth = 0
        if self.cfg.device_prefetch:
            depth_attr = getattr(train_data, "prefetch", None)
            depth = 2 if depth_attr is None else max(0, int(depth_attr))
            if depth == 0:
                self.log("device_prefetch requested but the data source's prefetch depth is "
                         "0 (read-ahead disabled) - placement stays inline; raise the "
                         "loader's prefetch to enable double-buffering")
            else:
                self._prefetch_placement = BatchPlacement(device, k, transfer=True)
        self._prefetch_depth = depth
        if depth:
            self.log(f"input pipeline: placement mode {self._placement.mode}, double-buffered "
                     f"on the placement thread (depth {depth})")
        else:
            why = "source prefetch depth 0" if self.cfg.device_prefetch else \
                "device_prefetch off"
            self.log(f"input pipeline: placement mode {self._placement.mode}, inline ({why})")

    @staticmethod
    def _epoch_telemetry(stats: Dict[str, float], ckpt_s: float, eval_s: float,
                         epoch_s: float) -> Dict[str, float]:
        """Seconds per phase and their fractions of the epoch wall. The
        phases are not exhaustive (SWA, viz and logging are the rest).
        With device_prefetch, h2d counts the placement thread's seconds,
        which overlap the steps; the stall left on the critical path is
        data_wait."""
        wall = max(epoch_s, 1e-9)
        data_s = float(stats.get("data_wait_s", 0.0))
        h2d_s = float(stats.get("h2d_s", 0.0))
        device_s = float(stats.get("device_s", 0.0))
        return {
            "tele_data_wait_s": data_s, "tele_h2d_s": h2d_s, "tele_device_s": device_s,
            "tele_checkpoint_s": float(ckpt_s), "tele_eval_s": float(eval_s),
            "tele_data_wait_frac": data_s / wall, "tele_h2d_frac": h2d_s / wall,
            "tele_device_frac": device_s / wall,
            "tele_checkpoint_frac": float(ckpt_s) / wall,
            "tele_eval_frac": float(eval_s) / wall,
        }

    def _profile_tick(self, device: torch.device) -> None:
        """Before every train dispatch: open the ``torch.profiler`` window
        at the run's second dispatch and close it after ``profile_steps``
        dispatches; the spans are profiler ranges meanwhile."""
        if self._profile_done:
            return
        if self._profiler is None:
            if self._dispatch_count >= 1:
                from torch._C._profiler import _ExperimentalConfig
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(ProfilerActivity.CUDA)
                # All threads: the placement thread's copies are in the window.
                self._profiler = profile(
                    activities=activities,
                    experimental_config=_ExperimentalConfig(profile_all_threads=True))
                self._profiler.start()
                obs_spans.set_profiler_annotations(True)
                self._profile_started = True
                self._profile_remaining = max(1, self.cfg.profile_steps)
                self._profile_device = device
                self.log(f"profiling {self._profile_remaining} train dispatch(es) into "
                         f"{self.cfg.profile_dir}")
            return
        self._profile_remaining -= 1
        if self._profile_remaining <= 0:
            self._stop_profile()

    def _stop_profile(self) -> None:
        """Close the window (idempotent; fit's finally calls it on every
        exit path), export its Chrome trace into ``profile_dir`` and
        attribute it."""
        if self._profiler is not None:
            profiler, self._profiler = self._profiler, None
            obs_spans.set_profiler_annotations(False)
            if self._profile_device.type == "cuda":
                torch.cuda.synchronize(self._profile_device)
            profiler.stop()
            os.makedirs(self.cfg.profile_dir, exist_ok=True)
            path = os.path.join(self.cfg.profile_dir, "trace.json")
            t0 = time.perf_counter()
            profiler.export_chrome_trace(path)
            self.log(f"profile trace written to {path} ({time.perf_counter() - t0:.1f} s)")
            self._attribute_profile()
        if self.cfg.profile_dir and not self._profile_started and not self._profile_done:
            self.log(f"profile_dir={self.cfg.profile_dir}: the run ended before its second "
                     "train dispatch - nothing was captured")
        self._profile_done = True

    def _attribute_profile(self) -> None:
        """Parse the window's trace into the device-time gauges: device
        time per train dispatch (``device_step``'s attributed time over
        its windows) and in the whole window, in unrounded seconds. As in
        the JAX trainer, a trace that cannot be parsed is logged and
        never ends the run that just profiled."""
        try:
            from deepinteract_tpu_torch.obs import attribution as obs_attr
            from deepinteract_tpu_torch.obs import device as obs_device

            trace = obs_device.load_profile(self.cfg.profile_dir)
            agg = obs_attr.aggregate_ops(trace, top_n=3)
            step = obs_attr.phase_totals(trace)[0].get("device_step")
            dispatches = step.instances if step else max(1, self.cfg.profile_steps)
            per_dispatch_s = (step.device_us if step else trace.total_device_us) / dispatches / 1e6
            total_s = trace.total_device_us / 1e6
            obs_metrics.gauge(
                "di_train_profile_device_seconds_per_dispatch",
                "Measured device time per train dispatch over the last "
                "--profile_dir window").set(per_dispatch_s)
            obs_metrics.gauge(
                "di_train_profile_device_total_seconds",
                "Total device time inside the last --profile_dir "
                "window").set(total_s)
            top = ", ".join(
                f"{op['opcode']} {op['total_ms']:.2f}ms ({op['share']:.0%})"
                for op in agg["top_ops"][:3])
            self.log(
                f"profile attribution: {total_s * 1e3:.2f} ms device time over "
                f"{dispatches} dispatch(es) ({per_dispatch_s * 1e3:.2f} ms/dispatch); "
                f"top ops: {top}; full report: python -m "
                f"deepinteract_tpu_torch.cli.attribute --profile_dir {self.cfg.profile_dir}")
        except Exception as exc:  # noqa: BLE001 - advisory, as in the JAX trainer
            self.log(f"profile attribution skipped: {exc}")

    def _train_epoch(self, state: TrainState, data: DataSource, epoch: int,
                     losses: List[float], stats: Dict[str, float], start_batch: int = 0,
                     skips_used: int = 0, save_fn=None) -> None:
        """One epoch of train dispatches, appending to ``losses`` (which
        holds the paid batches' losses when resuming mid-epoch) and adding
        skipped steps and the data_wait, h2d and device seconds to
        ``stats``; ``save_fn(state, batches_dispatched)`` runs at the first
        dispatch boundary ``save_every_steps`` steps after the last save."""
        cfg = self.cfg
        k = max(1, cfg.steps_per_dispatch)
        device = next(state.model.parameters()).device
        step_idx = start_batch  # batches stepped, the resume cursor's position
        since_save = 0
        for key in ("skipped_steps", "data_wait_s", "h2d_s", "device_s"):
            stats.setdefault(key, 0)
        # Abort-diagnostics context: the last steps' metrics and the last
        # two dispatched runs.
        recent_metrics = collections.deque(maxlen=32)
        recent_runs = collections.deque(maxlen=2)

        def log_step(m: Dict[str, float]) -> None:
            nonlocal step_idx
            step_idx += 1
            _STEPS_TOTAL.inc()
            self._progress(step=step_idx, epoch=epoch)
            losses.append(m["loss"])
            recent_metrics.append({"loss": m["loss"], "grad_norm": m["grad_norm"]})
            if "bad_step" in m:
                if m["bad_step"] > 0:
                    stats["skipped_steps"] += 1
                    _SKIPPED_TOTAL.inc()
                    self.log(f"epoch {epoch} step {step_idx}: non-finite loss/grads "
                             f"(loss={m['loss']}) - optimizer update skipped "
                             f"({stats['skipped_steps']} this epoch)")
                consecutive = int(m["bad_steps"])
                if 0 < consecutive and consecutive >= cfg.max_bad_steps:
                    self._abort_nonfinite(epoch, step_idx, consecutive, recent_metrics,
                                          recent_runs)
            if cfg.log_every and step_idx % cfg.log_every == 0:
                self.log(f"epoch {epoch} step {step_idx}: loss={m['loss']:.4f} "
                         f"grad_norm={m['grad_norm']:.4f}")

        def instrumented(items):
            """The per-batch fault probes (free without a fault plan). The
            sigterm probe only requests preemption, which is polled at the
            next dispatch boundary."""
            for batch in items:
                if faults.fire("train.sigterm") and self._preempt is not None:
                    self._preempt.request("injected SIGTERM (fault plan)")
                if faults.fire("training.step_crash"):
                    raise RuntimeError("injected training.step_crash fault (fault plan)")
                if faults.fire("training.hang"):
                    _simulate_hang(self.log)
                yield faults.maybe_poison("train.nan_batch", batch)

        def maybe_midsave() -> None:
            nonlocal since_save
            if save_fn is not None and 0 < cfg.save_every_steps <= since_save:
                flush()  # the cursor's loss ledger covers every saved step
                save_fn(state, step_idx)
                since_save = 0

        graphs = self.step_graphs(state)
        guard = cfg.nonfinite_guard

        def dispatch(batches: List[PairedComplex]) -> _Fetch:
            """K steps (graph replays on the card) and the start of their
            metrics' copy to the host; nothing waits here."""
            self.steps_run += len(batches)
            return _Fetch(multi_train_step(state, batches, cfg.weight_classes, guard, graphs,
                                           self.mesh))

        pending: Optional[_Fetch] = None  # the last full run, read after the next dispatch

        def flush() -> None:
            nonlocal pending
            if pending is None:
                return
            fetch, pending = pending, None
            # The read blocks until the run's steps are done: device time.
            t0 = time.perf_counter()
            rows = fetch.rows()
            stats["device_s"] += time.perf_counter() - t0
            for m in rows:
                log_step(m)

        if self._placement is None:  # outside fit
            self._install_device_prefetch(data, device)
        placement = self._placement
        overlap = self._prefetch_depth > 0
        source = _shape_runs(instrumented(self._epoch_source(data, epoch, start_batch,
                                                             skips_used)), k)
        run_iter = (placed_runs(source, self._prefetch_placement, self._prefetch_depth)
                    if overlap else source)
        try:
            while True:
                # data_wait: the host blocked on the next (placed) run.
                t_wait = time.perf_counter()
                item = next(run_iter, None)
                waited = time.perf_counter() - t_wait
                stats["data_wait_s"] += waited
                if item is None:
                    break
                pr = item if overlap else None
                run = pr.host if pr is not None else item
                obs_spans.emit("data_wait", waited, n=len(run))
                self._check_preempt()
                recent_runs.append(run)
                if pr is not None:
                    per_batch = pr.kind == "per_batch"
                    # The training stream waits on the run's copies.
                    placed = self._prefetch_placement.ready(pr)
                else:
                    per_batch = len(run) < max(k, 2)
                if per_batch:
                    flush()
                    for j, host_batch in enumerate(run):
                        # Each batch is its own dispatch, its metrics read
                        # right after it.
                        self._profile_tick(device)
                        with obs_spans.span("step", step_num=self._dispatch_count, n=1):
                            if pr is not None:
                                batch, h2d_s = placed[j], pr.h2d_s[j]
                                obs_spans.emit("h2d", h2d_s)
                            else:
                                with obs_spans.span("h2d") as h2d_span:
                                    batch = placement.place_batch(host_batch)
                                h2d_s = h2d_span.dur_s
                            with obs_spans.span("device_step") as dev_span:
                                (m,) = dispatch([batch]).rows()
                                log_step(m)
                        stats["h2d_s"] += h2d_s
                        stats["device_s"] += dev_span.dur_s
                        self._dispatch_count += 1
                        since_save += 1
                        maybe_midsave()
                    continue
                # A full run: one placement, K steps, one dispatch.
                self._profile_tick(device)
                with obs_spans.span("step", step_num=self._dispatch_count, n=len(run)):
                    if pr is not None:
                        batches, h2d_s = placed, pr.h2d_s[0]
                        obs_spans.emit("h2d", h2d_s, n=len(run))
                    else:
                        with obs_spans.span("h2d") as h2d_span:
                            batches = placement.ready(placement.place_run(run))
                        h2d_s = h2d_span.dur_s
                    with obs_spans.span("device_step") as dev_span:
                        fetch = dispatch(batches)
                stats["h2d_s"] += h2d_s
                stats["device_s"] += dev_span.dur_s
                flush()  # the previous run's metrics, after this run is enqueued
                pending = fetch
                self._dispatch_count += 1
                since_save += len(run)
                maybe_midsave()
            flush()
        except BaseException:
            flush()  # the pending run's steps are in the state: log them
            raise
        finally:
            # Stops the placement and loader threads on every exit path.
            run_iter.close()

    def _abort_nonfinite(self, epoch: int, step: int, consecutive: int, recent_metrics,
                         recent_runs) -> None:
        """Write the diagnostics JSON (the last steps' loss and grad norm,
        a summary of the last two runs' batches) into ckpt_dir, or the
        working directory (rank 0 only: every rank reads the same global
        counts and aborts at the same step), and raise
        NonFiniteTrainingError."""
        cfg = self.cfg
        path = None
        if self.rank == 0:
            path = dump_diagnostics(cfg.ckpt_dir or ".", {
                "epoch": epoch, "step": step, "consecutive_bad_steps": consecutive,
                "max_bad_steps": cfg.max_bad_steps, "recent_metrics": list(recent_metrics),
                "recent_batches": [summarize_batch(b) for run in recent_runs for b in run]})
        _NONFINITE_ABORTS.inc()
        raise NonFiniteTrainingError(
            f"aborting: {consecutive} consecutive non-finite train steps (epoch {epoch}, "
            f"step {step}, max_bad_steps={cfg.max_bad_steps})"
            + (f"; diagnostics: {path}" if path else ""), diagnostics_path=path)

    def _make_midsave(self, ckpt: Checkpointer, saver: _Saver, epoch: int,
                      stopper: EarlyStopping, losses: List[float], stats: Dict[str, float],
                      data: DataSource, base_skips: int):
        """The mid-epoch save: the state into mid/ at the position reached,
        then the sidecar's cursor (loss ledger, skip ledger), so a resume
        lands on the next batch with this epoch's metrics intact."""
        skips_fn = getattr(data, "skips_before", None)

        def midsave(state: TrainState, batches_done: int) -> None:
            saver.drain()  # the boundary save in flight shares the retention of last/
            with obs_spans.span("midepoch_checkpoint", epoch=epoch, batch=batches_done):
                ckpt.save_midepoch(epoch, batches_done, host_snapshot(state))
            skips = int(skips_fn(batches_done)) if callable(skips_fn) else base_skips
            write_sidecar(self.cfg.ckpt_dir, {
                "epoch": epoch, "stopper_best": stopper.best,
                "stopper_stale": stopper.stale_epochs,
                "cursor": {"epoch": epoch, "batch_index": int(batches_done),
                           "opt_step": int(state.step), "seed": self.cfg.seed,
                           "skips_used": skips, "skipped_steps": int(stats["skipped_steps"]),
                           "loss_ledger": [float(x) for x in losses]}})
            self._progress(phase="midepoch_checkpoint", epoch=epoch)

        return midsave

    def _share_resume(self, state: TrainState, stopper: EarlyStopping,
                      cursor: ResumeCursor, restored: bool) -> ResumeCursor:
        """Rank 0's resume on every rank: the scalars and the partial
        epoch's loss ledger over the host group, then, when a checkpoint
        was restored, every state tensor broadcast in place (the step graphs
        keep addressing them)."""
        vec = multihost.broadcast_floats(
            [float(restored), cursor.epoch, stopper.best, stopper.stale_epochs, cursor.batch,
             cursor.skips_used, cursor.skipped_steps, len(cursor.losses)])
        stopper.best, stopper.stale_epochs = vec[2], int(vec[3])
        n = int(vec[7])
        losses = multihost.broadcast_floats(cursor.losses if self.rank == 0 else [0.0] * n) \
            if n else []
        if vec[0]:
            self.mesh.broadcast_(state.tensors() + [state.seed_t])
        return ResumeCursor(int(vec[1]), int(vec[4]), int(vec[5]), int(vec[6]), losses)

    def _resume(self, ckpt: Checkpointer, state: TrainState,
                stopper: EarlyStopping) -> ResumeCursor:
        """Restore the newest position (mid/, last/ or best/, verified,
        walking back past corrupt steps) into ``state`` and the stopper;
        the position comes from the step actually restored."""
        ckpt.restore(state, which="mid")
        epoch, batch = decode_position(ckpt.last_restored_which, ckpt.last_restored_step)
        cursor = ResumeCursor(epoch, batch)
        sidecar = read_sidecar(self.cfg.ckpt_dir)
        # A sidecar of another epoch (killed between the save and its
        # write) is ignored: the restored step is the source of truth.
        if sidecar and int(sidecar.get("epoch", -1)) == epoch:
            stopper.best = float(sidecar["stopper_best"])
            stopper.stale_epochs = int(sidecar["stopper_stale"])
        if not batch:
            self.log(f"resumed from epoch {epoch}")
            return cursor
        cur = (sidecar or {}).get("cursor") or {}
        if int(cur.get("epoch", -1)) == epoch and int(cur.get("batch_index", -1)) == batch:
            cursor.losses = [float(x) for x in cur.get("loss_ledger", [])]
            cursor.skips_used = int(cur.get("skips_used", 0))
            cursor.skipped_steps = int(cur.get("skipped_steps", 0))
        else:
            self.log("mid-epoch resume: the trainer_state.json cursor does not match the "
                     "restored checkpoint; the position is exact but the interrupted epoch's "
                     "train_loss covers only the re-run batches")
        self.log(f"resumed from epoch {epoch}, batch {batch}")
        return cursor

    def _run_epoch(self, state: TrainState, epoch: int, cursor: ResumeCursor,
                   history: List[Dict[str, float]], train_data: DataSource,
                   val_data: Optional[DataSource], ckpt: Optional[Checkpointer],
                   saver: Optional["_Saver"], stopper: EarlyStopping, t_start: float) -> bool:
        """One epoch of fit: train, validate (and viz), write the scalars,
        save, the telemetry, the stopper and the sidecar. Appends the
        epoch's metrics to ``history``; True when training should stop."""
        cfg = self.cfg
        t0 = time.perf_counter()
        resuming = epoch == cursor.epoch and cursor.batch > 0
        losses = list(cursor.losses) if resuming else []
        stats: Dict[str, float] = {"skipped_steps": cursor.skipped_steps if resuming else 0}
        midsave = None
        if ckpt is not None and cfg.save_every_steps > 0:
            midsave = self._make_midsave(ckpt, saver, epoch, stopper, losses, stats, train_data,
                                         cursor.skips_used if resuming else 0)
        self._train_epoch(state, train_data, epoch, losses, stats,
                          start_batch=cursor.batch if resuming else 0,
                          skips_used=cursor.skips_used if resuming else 0, save_fn=midsave)
        t_train = time.perf_counter()
        # Skipped steps made no update: their losses stay out of the mean.
        finite = [x for x in losses if math.isfinite(x)]
        metrics: Dict[str, float] = {
            "epoch": epoch,
            "train_loss": float(np.mean(finite)) if finite else float("nan"),
            "train_steps": float(len(losses)),
            "train_seconds": t_train - t0}
        if cfg.nonfinite_guard:
            metrics["train_skipped_steps"] = float(stats["skipped_steps"])
        if val_data is not None:
            with obs_spans.span("eval", epoch=epoch):
                metrics.update(self.evaluate(state, val_data, stage="val"))
            metrics["val_eval_seconds"] = time.perf_counter() - t_train
            # Under a pair axis every rank takes part in the eval step the
            # images come from; rank 0 alone writes them.
            if (cfg.viz_every_n_epochs and (epoch + 1) % cfg.viz_every_n_epochs == 0
                    and (self.metric_writer is not None
                         or (self.mesh is not None and self.mesh.pair is not None))):
                self._log_viz_images(state, val_data, epoch)
        metrics["epoch_seconds"] = time.perf_counter() - t0
        history.append(metrics)
        self._write_metrics(epoch, metrics)
        phase = f"train_s={metrics['train_seconds']:.1f}"
        if "val_eval_seconds" in metrics:
            phase += f" val_s={metrics['val_eval_seconds']:.1f}"
        self.log(f"epoch {epoch}: train_loss={metrics['train_loss']:.4f} {phase} " + " ".join(
            f"{k}={v:.4f}" for k, v in metrics.items()
            if k.startswith(("val_", "med_val_")) and k != "val_eval_seconds"
            and not math.isnan(v)))
        ckpt_s = 0.0
        if saver is not None:
            with obs_spans.span("checkpoint", epoch=epoch) as ckpt_span:
                saver.submit(epoch + 1, state, metrics)
            ckpt_s = metrics["checkpoint_seconds"] = ckpt_span.dur_s
        # Boundary work (the save, the stopper) is progress too.
        self._progress(phase="epoch_boundary", epoch=epoch)
        telemetry = self._epoch_telemetry(stats, ckpt_s, metrics.get("val_eval_seconds", 0.0),
                                          time.perf_counter() - t0)
        metrics.update(telemetry)
        _EPOCHS_TOTAL.inc()
        self.log(f"epoch {epoch} telemetry: data_wait={telemetry['tele_data_wait_frac']:.1%} "
                 f"h2d={telemetry['tele_h2d_frac']:.1%} "
                 f"device={telemetry['tele_device_frac']:.1%} "
                 f"checkpoint={telemetry['tele_checkpoint_frac']:.1%} "
                 f"eval={telemetry['tele_eval_frac']:.1%}")
        stop = False
        if val_data is not None and stopper.update(metrics.get(cfg.metric_to_track,
                                                               float("nan"))):
            self.log(f"early stop at epoch {epoch}: no {cfg.metric_to_track} improvement in "
                     f"{cfg.patience} epochs (best {stopper.best:.6f})")
            stop = True
        if ckpt is not None:
            # After stopper.update: a resume at this boundary takes the
            # counters as they stand here.
            write_sidecar(cfg.ckpt_dir, {"epoch": epoch + 1, "stopper_best": stopper.best,
                                         "stopper_stale": stopper.stale_epochs,
                                         "telemetry": telemetry})
        if cfg.max_time_seconds:
            # Each rank reads its own clock: the ranks stop together when any
            # of them is out of time.
            if multihost.any_across_hosts(time.time() - t_start > cfg.max_time_seconds):
                self.log("max_time reached; stopping")
                stop = True
        return stop

    def fit(self, state: TrainState, train_data: DataSource,
            val_data: Optional[DataSource] = None, num_epochs: Optional[int] = None,
            resume: bool = False):
        """Run the epoch loop. Returns (state, history: one metric dict per
        epoch run). With ``resume`` and a checkpoint under ``ckpt_dir``, the
        run continues from its newest position."""
        cfg = self.cfg
        # Rank 0 alone checkpoints: the state is the same on every rank.
        ckpt = Checkpointer(CheckpointConfig(directory=cfg.ckpt_dir,
                                             metric_to_track=cfg.metric_to_track,
                                             save_top_k=cfg.save_top_k)) \
            if cfg.ckpt_dir and self.rank == 0 else None
        stopper = EarlyStopping(metric_mode(cfg.metric_to_track), cfg.patience, cfg.min_delta)
        cursor = ResumeCursor()
        restored = resume and ckpt is not None and ckpt.has_restorable()
        if restored:
            cursor = self._resume(ckpt, state, stopper)
        if resume and self.world > 1:
            cursor = self._share_resume(state, stopper, cursor, restored)
        epochs = cfg.num_epochs if num_epochs is None else num_epochs
        swa_first = int(math.ceil(cfg.swa_epoch_start * epochs))
        swa_params: Optional[List[torch.Tensor]] = None
        swa_count = 0
        history: List[Dict[str, float]] = []
        saver = _Saver(ckpt, cfg.async_checkpoint) if ckpt is not None else None
        preempt = PreemptionGuard(log=self.log) if cfg.preemption_guard else None
        self._preempt = preempt
        if cfg.heartbeat_seconds > 0:
            # Started right before the try whose finally stops it, so no
            # setup failure above can leave a beating thread behind.
            self._heartbeat = Heartbeat(
                os.path.join(cfg.ckpt_dir or ".", "obs", f"heartbeat_p{self.rank}.json"),
                interval_s=cfg.heartbeat_seconds, process_index=self.rank,
                process_count=self.world).start()
        t_start = time.time()
        abort: Optional[Exception] = None
        device = next(state.model.parameters()).device
        self._install_device_prefetch(train_data, device)
        # The span log of this run; a sink this fit opened, this fit closes.
        own_span_sink = False
        if cfg.span_log and cfg.ckpt_dir and self.rank == 0 and not obs_spans.configured():
            obs_spans.configure(os.path.join(cfg.ckpt_dir, "obs", "events.jsonl"))
            own_span_sink = True
        try:
            if preempt is not None:
                preempt.__enter__()
            for epoch in range(cursor.epoch, epochs):
                self._check_preempt(epoch_boundary=True)
                with obs_spans.span("epoch", epoch=epoch):
                    stop = self._run_epoch(state, epoch, cursor, history, train_data, val_data,
                                           ckpt, saver, stopper, t_start)
                if cfg.swa and epoch >= swa_first:
                    params = [p.detach().clone() for p in state.model.parameters()]
                    swa_count += 1
                    if swa_params is None:
                        swa_params = params
                    else:
                        for avg, p in zip(swa_params, params):
                            avg.add_((p - avg) / swa_count)
                if stop:
                    break
        except (TrainingPreempted, NonFiniteTrainingError) as exc:
            abort = exc  # raised after the drain below: the save in flight lands first
        finally:
            try:
                if saver is not None:
                    saver.close()
            finally:
                if preempt is not None:
                    preempt.__exit__(None, None, None)
                self._preempt = None
                self._stop_profile()
                if own_span_sink:
                    obs_spans.close()
                if self._heartbeat is not None:
                    self._heartbeat.stop()
                    self._heartbeat = None
        if abort is not None:
            if isinstance(abort, TrainingPreempted):
                self.log(f"preempted ({abort}): the newest checkpoint is flushed - rerun "
                         "with resume=True to continue")
            raise abort
        if swa_params is not None:
            self.log(f"SWA: averaged {swa_count} epoch snapshot(s) into the final params")
            with torch.no_grad():
                for p, avg in zip(state.model.parameters(), swa_params):
                    p.copy_(avg)
            self.refresh_batch_stats(state, train_data)
            if ckpt is not None and history:
                # cli.test and predict then load the weights the last metrics
                # were computed with.
                ckpt.save(history[-1]["epoch"] + 2, host_snapshot(state), history[-1])
        if ckpt is not None:
            ckpt.close()
        return state, history

    @torch.no_grad()
    def refresh_batch_stats(self, state: TrainState, data: DataSource) -> None:
        """One train-mode pass over epoch 0 of ``data`` without gradients:
        the batch-norm running statistics of the current parameters (over
        the global batches of a data-parallel run)."""
        model = state.model
        device = next(model.parameters()).device
        model.train()
        key = DropoutKey(state.seed_t, state.step_t,
                         shard=0 if self.mesh is None else self.mesh.data_rank)
        pair = None if self.mesh is None else self.mesh.pair
        with dropout_rng(model, key), data_parallel(self.mesh), pair_sharded(pair):
            for batch in _iter_data(data, 0):
                batch = batch.to(device)
                model(batch.graph1, batch.graph2)

    def _log_viz_images(self, state: TrainState, val_data: DataSource, epoch: int) -> None:
        """The first validation complex's predicted positive-class
        probabilities and its true contacts, each ``[n1, n2, 1]`` uint8
        (0-255), as images of the metric writer (the reference's viz
        epochs)."""
        batch = next(iter(_iter_data(val_data, 0)), None)
        if batch is None:
            return
        probs = eval_step(state, batch, self.cfg.weight_classes, self.mesh)["probs"][0, ..., -1]
        if self.metric_writer is None:
            return
        n1, n2 = int(batch.graph1.num_nodes[0]), int(batch.graph2.num_nodes[0])
        pred = (probs.float().cpu().numpy()[:n1, :n2, None] * 255).astype(np.uint8)
        true = (batch.contact_map[0, :n1, :n2, None].numpy() * 255).astype(np.uint8)
        self.metric_writer.add_image("val_predicted_contact_probs", pred, epoch,
                                     dataformats="HWC")
        self.metric_writer.add_image("val_true_contacts", true, epoch, dataformats="HWC")

    def _write_metrics(self, epoch: int, metrics: Dict[str, float]) -> None:
        """Every finite scalar of the epoch to the metric writer and the
        registry."""
        for k, v in metrics.items():
            if isinstance(v, (int, float)) and not math.isnan(float(v)):
                self._scalar_writer.add_scalar(k, float(v), epoch)


def _simulate_hang(log) -> None:
    """The ``training.hang`` fault site: freeze the step loop forever while
    the heartbeat thread (a daemon) keeps the file fresh and its progress
    stamp goes stale, the signature on which the supervisor's watchdog
    kills the process. Nothing else ends this loop."""
    log("training.hang fault injected: step loop frozen until killed")
    while True:
        time.sleep(0.25)
