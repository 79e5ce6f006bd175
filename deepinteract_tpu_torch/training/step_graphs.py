"""One CUDA graph of the train step and one of the eval step per bucket key.

The JAX trainer jits ``train_step`` / ``eval_step`` and scans K of them
per dispatch (``multi_train_step`` / ``multi_eval_step``,
``deepinteract_tpu/training/steps.py``): one compiled executable per
batch shape, the whole step on the device. Its counterpart here is a
:class:`StepGraphs` inventory: for every key (every tensor's shape and
dtype of a batch, the rule of the loop's ``_shape_runs``) the train step
body (``steps.train_step_body``: forward, loss, backward with K2, the
guard, the clip, the on-device schedule and the masked AdamW) and the eval
body (``steps.eval_step_body``) are each captured once with
``torch.cuda.graph`` at the key's first dispatch and replayed for every
step after. A replay launches the step's ~20,000 kernels with one host call
and reads nothing back.

What a capture bakes in, and why it stays valid:

* **inputs**: static device buffers at the key's shapes; each step
  ``copy_``-s its placed batch in (a batch the placement thread placed is
  made ready, its event waited on, before it gets here).
* **state**: the parameters, batch-norm buffers, the optimizer's flat
  gradient, moments, count and accumulator, and the step and skip
  counters are updated in place by every replay. Whatever swaps them must
  copy into them instead: ``TrainState.load_state_dict`` (resume, the
  fine-tune restore) and SWA's average do. A new ``TrainState`` (a
  fine-tune state, the LR finder's copy) gets its own inventory.
* **warm-up**: before a capture the body runs ``WARMUP_RUNS`` time(s) on
  a side stream, as PyTorch requires (cuBLAS and cuDNN workspaces, K1 and
  K2's libraries, the resize matrices, lazily built tables). A train
  warm-up really steps, so every tensor it writes is snapshotted before
  and copied back after: the replays start from the state as it was.
* **pool**: every entry of an inventory allocates from one memory pool
  (autograd's saved tensors, K2's ``dsum`` scratch, the in-edge CSR
  builds), not shared with serving's. That is safe because replays are
  serialized on one stream and each replay's outputs are copied out (into
  a run's [K] buffers) before the next replay of any key.
* **counts**: K1's and K2's launch counters and the CSR build counter run
  in Python, so they move at a capture (and in its warm-up runs) and not
  at a replay: an entry records its capture's counts, ``replays`` its
  replays. So does ``parallel.mesh.ALL_REDUCES``: ``all_reduces`` is what
  a sharded capture baked in, by site.
* **collectives**: with a mesh (``parallel/train.py``) a train capture
  holds the step's all-reduces (loss, batch norms and their backward, the
  flat gradient), NCCL on the card, captured like any kernel; with a pair
  axis the train and eval captures also hold the pair group's halo
  exchanges (P2P), statistics all-reduces and the eval's loss sums and
  row gather. Every communicator (the data, data-group and pair-group
  ones, and the pair group's P2P connections) exists before the first
  capture (``multihost.initialize_distributed``, ``parallel.mesh.
  make_mesh``) and the warm-up runs them eagerly. Every rank plans the
  same global batches, so every rank captures the same key at the same
  step: a capture is a collective too. A collective that cannot be
  captured fails the capture, which raises.

A capture that fails raises with the key; the key is never run eagerly
instead. On the CPU nothing is captured: the loop runs the bodies eagerly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from deepinteract_tpu_torch.data.graph import PairedComplex, ProteinGraph
from deepinteract_tpu_torch.data.pipeline import tensors
from deepinteract_tpu_torch.device import graph_capture
from deepinteract_tpu_torch.ops import cuda_attention
from deepinteract_tpu_torch.parallel import mesh as mesh_lib
from deepinteract_tpu_torch.parallel.mesh import DataMesh
from deepinteract_tpu_torch.training.steps import (TrainState, eval_step_body,
                                                   train_step_body)

# Eager runs on a side stream before each capture. One does every lazy
# set-up; each costs a flagship step (0.4-0.5 s on the card) per key.
WARMUP_RUNS = 1


def batch_key(batch: PairedComplex) -> Tuple:
    """A batch's graph key: every tensor's shape and dtype."""
    return tuple((tuple(t.shape), t.dtype) for t in tensors(batch))


def _static(batch: PairedComplex, device) -> PairedComplex:
    """Device copies of a batch, in a batch's structure."""
    def graph(g: ProteinGraph) -> ProteinGraph:
        return ProteinGraph(**{f.name: getattr(g, f.name).to(device, copy=True)
                               for f in dataclasses.fields(g)})
    return PairedComplex(graph(batch.graph1), graph(batch.graph2),
                         batch.examples.to(device, copy=True),
                         batch.example_mask.to(device, copy=True),
                         batch.contact_map.to(device, copy=True))


def _launch_counts() -> Tuple[int, int, int]:
    return (cuda_attention.edge_attention_forward.launches,
            cuda_attention.edge_attention_backward.launches, cuda_attention.in_edge_csr.builds)


def _all_reduces() -> Dict[str, int]:
    return dict(mesh_lib.ALL_REDUCES)


class _Entry:
    """One key's captured step: static inputs, the graph, its outputs.
    ``seconds`` is the capture wall (warm-up, snapshot and capture);
    ``k1_launches``, ``k2_launches``, ``csr_builds`` and ``all_reduces``
    (by site) are the counters' moves during the capture alone."""

    kind = ""

    def __init__(self, state: TrainState, batch: PairedComplex, pool, body):
        device = next(state.model.parameters()).device
        marks = [time.perf_counter()]
        self.key = batch_key(batch)
        self.static = _static(batch, device)
        try:
            self._warm_up(state, body, device)
            marks.append(time.perf_counter())
            before, reduces_before = _launch_counts(), _all_reduces()
            self.graph = torch.cuda.CUDAGraph()
            with graph_capture(self.graph, pool):
                marks.append(time.perf_counter())
                self.output = body(self.static)
                marks.append(time.perf_counter())
            marks.append(time.perf_counter())
        except Exception as exc:
            raise RuntimeError(f"capturing the {self.kind} step of key {self.key} failed: "
                               f"{exc}") from exc
        self.k1_launches, self.k2_launches, self.csr_builds = (
            a - b for a, b in zip(_launch_counts(), before))
        self.all_reduces = {site: n - reduces_before.get(site, 0)
                            for site, n in _all_reduces().items()
                            if n != reduces_before.get(site, 0)}
        self.seconds = marks[-1] - marks[0]
        # Where a capture's seconds go: the warm-up (and its snapshot), the
        # capture context's set-up, the body's pass, the graph's instantiation.
        self.split = dict(zip(("warm_up_s", "enter_s", "body_s", "instantiate_s"),
                              (b - a for a, b in zip(marks, marks[1:]))))
        self.replays = 0

    def _warm_up(self, state: TrainState, body, device) -> None:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                body(self.static)
        torch.cuda.current_stream(device).wait_stream(side)

    def replay(self, batch: PairedComplex):
        """Copy ``batch`` into the static inputs and replay. The outputs
        are static: valid until the next replay of any entry of the
        inventory."""
        with torch.no_grad():
            for dst, src in zip(tensors(self.static), tensors(batch), strict=True):
                dst.copy_(src)
        self.graph.replay()
        self.replays += 1
        return self.output


class TrainEntry(_Entry):
    """The train step of one key: its output is the body's float32 [4]
    metrics. The warm-up steps are undone from a snapshot of every tensor
    a step writes."""

    kind = "train"

    def _warm_up(self, state: TrainState, body, device) -> None:
        live = state.tensors()
        with torch.no_grad():
            snapshot = [t.clone() for t in live]
        super()._warm_up(state, body, device)
        with torch.no_grad():
            torch._foreach_copy_(live, snapshot)


class EvalEntry(_Entry):
    """The eval step of one key: its output is the body's ``loss``,
    ``probs`` and ``logits``."""

    kind = "eval"


class StepGraphs:
    """The step graphs of one :class:`TrainState` on the card: a train and
    an eval entry per key, captured at the key's first step, sharing one
    memory pool. With ``mesh`` the train steps are data-parallel and hold
    their collectives; the eval steps stay replicated over the data axis
    and, with a pair axis, hold the pair group's collectives."""

    def __init__(self, state: TrainState, weight_classes: bool = False, guard: bool = False,
                 mesh: Optional[DataMesh] = None):
        device = next(state.model.parameters()).device
        if device.type != "cuda":
            raise ValueError(f"step graphs need a model on a CUDA device, got {device}")
        self.state = state
        self.weight_classes, self.guard, self.mesh = weight_classes, guard, mesh
        self.pool = torch.cuda.graph_pool_handle()
        self.train_entries: Dict[Tuple, TrainEntry] = {}
        self.eval_entries: Dict[Tuple, EvalEntry] = {}

    def train(self, batch: PairedComplex) -> torch.Tensor:
        """One train step on ``batch``: a replay of its key's graph (captured
        first if the key is new). Returns the static float32 [4] metrics."""
        key = batch_key(batch)
        entry = self.train_entries.get(key)
        if entry is None:
            entry = self.train_entries[key] = TrainEntry(
                self.state, batch, self.pool,
                lambda b: train_step_body(self.state, b, self.weight_classes, self.guard,
                                          self.mesh))
        return entry.replay(batch)

    def eval(self, batch: PairedComplex) -> Dict[str, torch.Tensor]:
        """One eval step on ``batch``: a replay of its key's eval graph.
        Returns the static ``loss``, ``probs`` and ``logits``."""
        key = batch_key(batch)
        entry = self.eval_entries.get(key)
        if entry is None:
            entry = self.eval_entries[key] = EvalEntry(
                self.state, batch, self.pool,
                lambda b: eval_step_body(self.state, b, self.weight_classes, self.mesh))
        return entry.replay(batch)

    def entries(self) -> List[_Entry]:
        return [*self.train_entries.values(), *self.eval_entries.values()]

    def inventory(self) -> List[Dict]:
        """Per entry: kind, key shapes, capture seconds and their split,
        (K1, K2, CSR builds) and all-reduces by site at its capture,
        replays."""
        return [{"kind": e.kind, "key": [list(shape) for shape, _ in e.key],
                 "capture_s": e.seconds, **e.split,
                 "counts": (e.k1_launches, e.k2_launches, e.csr_builds),
                 "all_reduces": e.all_reduces, "replays": e.replays} for e in self.entries()]
