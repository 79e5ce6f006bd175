"""Train and eval steps over a :class:`TrainState`: one step body, run
eagerly or replayed from a CUDA graph.

Port of ``deepinteract_tpu/training/steps.py`` (``create_train_state``,
``train_step``, ``eval_step``, ``multi_train_step``, ``multi_eval_step``).
The model holds the parameters and the batch statistics; the state adds
the optimizer (AdamW and its schedule), and the step counter, the
consecutive-skip counter and the seed as int64 tensors on the device.

:func:`train_step_body` is the whole step with no host read: the forward
(dropout keyed on the device step, ``layers.DropoutKey``: the counterpart
of ``fold_in(dropout_rng, state.step)``, so a skipped step's successor
reuses its key), the loss, the backward into the static flat gradient, the
gradient norm, the guarded update and the metrics, written into a [4]
tensor. :func:`train_step` calls it eagerly and reads the metrics;
:func:`multi_train_step` runs it K times into [K] metrics, eagerly (the
CPU, or ``step_graphs`` off) or as replays of a bucket key's CUDA graph
(``training/step_graphs.py``). ``multi_eval_step`` is the eval twin. A
checkpoint needs no generator state: ``TrainState.state_dict`` holds the
model (parameters and batch-norm running statistics), the optimizer
(``Optimizer.state_dict``), ``step``, ``bad_steps`` and ``seed``, read to
the host at the save.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from deepinteract_tpu_torch.data.graph import PairedComplex
from deepinteract_tpu_torch.data.pipeline import is_placed
from deepinteract_tpu_torch.models.layers import DropoutKey, dropout_rng
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.parallel.mesh import DataMesh, data_parallel
from deepinteract_tpu_torch.parallel.pair import pair_sharded, take_rows
from deepinteract_tpu_torch.robustness.guards import apply_guarded_update
from deepinteract_tpu_torch.training.objective import contact_loss
from deepinteract_tpu_torch.training.optim import OptimConfig, Optimizer

# The train step's metrics, in the order of the body's [4] tensor.
METRICS = ("loss", "grad_norm", "bad_step", "bad_steps")


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


class TrainState:
    """The model, its optimizer, and the seed, step and consecutive-skip
    counters as int64 0-d tensors on the model's device (``seed_t``,
    ``step_t``, ``bad_steps_t``), which a step updates in place. ``seed``,
    ``step`` and ``bad_steps`` are their int views for the host (each read
    is a device sync: the loop reads them at dispatch boundaries only);
    assigning one writes into the tensor."""

    def __init__(self, model: DeepInteract, optimizer: Optimizer, seed: int = 42,
                 step: int = 0, bad_steps: int = 0):
        self.model = model
        self.optimizer = optimizer
        device = _device(model)
        self.seed_t, self.step_t, self.bad_steps_t = (
            torch.tensor(v, dtype=torch.int64, device=device) for v in (seed, step, bad_steps))
        self._backup: Optional[List[torch.Tensor]] = None

    seed = property(lambda self: int(self.seed_t),
                    lambda self, v: self.seed_t.fill_(int(v)))
    step = property(lambda self: int(self.step_t),
                    lambda self, v: self.step_t.fill_(int(v)))
    bad_steps = property(lambda self: int(self.bad_steps_t),
                         lambda self, v: self.bad_steps_t.fill_(int(v)))

    def guard_buffers(self):
        """(the model's buffers, their static copies): what a guarded step
        restores after a non-finite forward. The copies are allocated once."""
        buffers = list(self.model.buffers())
        if self._backup is None or len(self._backup) != len(buffers):
            self._backup = [torch.empty_like(b) for b in buffers]
        return buffers, self._backup

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor a train step writes (parameters, buffers, the
        optimizer's state, the counters): a snapshot of these undoes
        steps."""
        return [*self.model.parameters(), *self.model.buffers(),
                *self.optimizer.tensors(), self.step_t, self.bad_steps_t]

    def state_dict(self) -> Dict:
        """Everything a resume needs: the model's and the optimizer's live
        tensors, the counters as ints. Dropout masks come from (seed, step)
        alone (``layers.DropoutKey``), so no generator state is kept."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step, "bad_steps": self.bad_steps, "seed": self.seed}

    def load_state_dict(self, state: Dict) -> None:
        """Restore :meth:`state_dict`'s output into the existing tensors
        (a captured step graph keeps addressing them). The optimizer part
        is refused when it was saved over another parameter list (a
        fine-tune state, whose frozen prefix is left out, takes only the
        model)."""
        self.optimizer.load_state_dict(state["optimizer"])
        self.model.load_state_dict(state["model"])
        self.step, self.bad_steps, self.seed = state["step"], state["bad_steps"], state["seed"]


def create_train_state(model: DeepInteract, seed: int = 42,
                       optim_cfg: Optional[OptimConfig] = None,
                       frozen_prefixes: Sequence[str] = ()) -> TrainState:
    """The state around an initialized model (its weights are the
    caller's: ``weights.init_weights`` or ``load_jax_variables``).
    ``frozen_prefixes`` freezes top-level submodules (``("decoder",)``
    for the reference's fine-tune mode)."""
    return TrainState(model, Optimizer(model.named_parameters(), optim_cfg, frozen_prefixes),
                      seed)


def _pair_of(model: DeepInteract, mesh: Optional[DataMesh]):
    """The pair mesh a step decodes over: ``mesh.pair`` for a model with
    ``shard_pair_map`` (None without a mesh: the model then raises).
    A mesh with a pair axis and a model without it would count every pair
    rank's whole map once each in the world's sums: refused."""
    pair = None if mesh is None else mesh.pair
    if pair is not None and not model.cfg.shard_pair_map:
        raise ValueError("a mesh with a pair axis needs a model with shard_pair_map")
    return pair


def _label_rows(model: DeepInteract, batch: PairedComplex, pair):
    """(contact map, pair mask) rows of ``batch`` that the model's logits
    hold: this rank's rows under pair-map sharding, else all; and the
    number of row blocks they come in."""
    cm, pm = batch.contact_map, batch.pair_mask
    if pair is None:
        return cm, pm, 1
    rows = model.pair_row_slices(cm.shape[1], cm.shape[2], pair)
    return take_rows(cm, rows), take_rows(pm, rows), len(rows)


def train_step_body(state: TrainState, batch: PairedComplex, weight_classes: bool = False,
                    guard: bool = False, mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """One optimization step on ``batch`` (on the model's device), with no
    host read, so that it can be captured in a CUDA graph: train-mode
    forward with dropout keyed on (seed, step), the loss, its backward
    into the optimizer's static flat gradient (zeroed first), the global
    gradient norm over every parameter, then the update. With ``guard``
    a non-finite step skips it on the device
    (:func:`~deepinteract_tpu_torch.robustness.guards.apply_guarded_update`).
    Returns float32 [4]: :data:`METRICS` (``bad_step``, ``bad_steps`` 0
    without the guard). The gradients stay in ``.grad``.

    With a data-parallel ``mesh`` (``parallel/train.py``) ``batch`` is this
    rank's slice of the global batch and the step is the global batch's:
    the loss over the global weight sum, batch statistics over the global
    batch, dropout masks of the rank's slice, and the flat gradient summed
    over the ranks before the norm; the loss reported is the global one.
    So every rank takes the same guard decision and the same update.

    With a pair axis (``mesh.pair``, a model with ``shard_pair_map``) each
    rank of a pair group holds the same complexes and decodes its rows of
    their maps: the loss is its rows' term, the weight sum, the reported
    loss and the flat gradient are summed over data x pair, the encoder's
    batch norms over the data group, and the decoder's statistics and
    halos ride the pair group (``parallel/pair.py``); the dropout masks
    are those of the data index (the encoder's, equal on every pair rank)
    and of the whole map's rows (the decoder's)."""
    model, opt = state.model, state.optimizer
    model.train()
    opt.zero_grad()
    if guard:
        buffers, backup = state.guard_buffers()
        with torch.no_grad():
            for dst, src in zip(backup, buffers):
                dst.copy_(src)
    key = DropoutKey(state.seed_t, state.step_t, shard=0 if mesh is None else mesh.data_rank)
    pair = _pair_of(model, mesh)
    with dropout_rng(model, key), data_parallel(mesh), pair_sharded(pair):
        logits = model(batch.graph1, batch.graph2)
        contact_map, mask, _ = _label_rows(model, batch, pair)
        loss = contact_loss(logits, contact_map, mask, weight_classes, mesh=mesh)
        loss.backward()
    loss = loss.detach().float()
    if mesh is not None:
        loss = mesh.all_reduce(loss, "loss")
        mesh.all_reduce_(opt.grads(), "grads")
    norm = torch.linalg.vector_norm(opt.grads())
    if guard:
        finite = apply_guarded_update(state, loss, norm, buffers, backup)
        flags = ((~finite).to(torch.float32), state.bad_steps_t.to(torch.float32))
    else:
        opt.apply_update()
        with torch.no_grad():
            state.step_t.add_(1)
        flags = (torch.zeros_like(loss), torch.zeros_like(loss))
    return torch.stack([loss, norm, *flags])


def _metrics(values: torch.Tensor, guard: bool) -> Dict[str, torch.Tensor]:
    """[..., 4] metric values -> the named [...] columns (the guard's two
    only with the guard)."""
    return {name: values[..., i] for i, name in enumerate(METRICS[:4 if guard else 2])}


def train_step(state: TrainState, batch: PairedComplex, weight_classes: bool = False,
               guard: bool = False, mesh: Optional[DataMesh] = None) -> Dict[str, float]:
    """One eager optimization step on ``batch`` (moved to the model's
    device unless the placement stage already put it there): the body,
    then one host read of its metrics. Returns ``loss`` and the pre-clip
    ``grad_norm`` over every parameter; with ``guard`` also ``bad_step``
    (0/1) and ``bad_steps`` (consecutive skips after this step). ``mesh``:
    a data-parallel step (:func:`train_step_body`)."""
    device = _device(state.model)
    if not is_placed(batch, device):
        batch = batch.to(device)
    values = train_step_body(state, batch, weight_classes, guard, mesh).tolist()
    return dict(zip(METRICS[:4 if guard else 2], values))


def multi_train_step(state: TrainState, batches: Sequence[PairedComplex],
                     weight_classes: bool = False, guard: bool = False,
                     graphs=None, mesh: Optional[DataMesh] = None) -> Dict[str, torch.Tensor]:
    """K optimization steps over same-shape batches (placed on the
    model's device), the JAX ``multi_train_step``'s meaning: the same
    updates as K :func:`train_step` calls, and metrics with a leading [K]
    axis, left on the device. With ``graphs`` (a
    ``step_graphs.StepGraphs`` of this state) each step replays the
    batches' key's CUDA graph (captured with its own mesh), else the body
    runs eagerly, data-parallel with ``mesh``. No host read."""
    device = _device(state.model)
    out = torch.empty((len(batches), len(METRICS)), device=device)
    for j, batch in enumerate(batches):
        values = (graphs.train(batch) if graphs is not None
                  else train_step_body(state, batch, weight_classes, guard, mesh))
        out[j].copy_(values)
    return _metrics(out, guard)


def eval_step_body(state: TrainState, batch: PairedComplex, weight_classes: bool = False,
                   mesh: Optional[DataMesh] = None) -> Dict[str, torch.Tensor]:
    """Eval-mode forward, loss, per-pair probabilities and logits of a
    batch on the model's device; no update, no host read. Evaluation is
    replicated over the data axis (no data collective); with a pair axis
    each rank decodes its rows, the loss's sums ride the pair group
    (``pair_loss``) and the logits are gathered whole (``pair_gather``),
    so the outputs are the whole maps' on every rank."""
    model = state.model
    model.eval()
    pair = _pair_of(model, mesh)
    with torch.no_grad(), pair_sharded(pair):
        logits = model(batch.graph1, batch.graph2)
        contact_map, mask, blocks = _label_rows(model, batch, pair)
        loss = contact_loss(logits, contact_map, mask, weight_classes, mesh=pair,
                            site="pair_loss")
        if pair is not None:
            loss = pair.all_reduce(loss, "pair_loss")
            logits = pair.gather_rows(logits, blocks)
        return {"loss": loss, "probs": torch.softmax(logits, dim=-1), "logits": logits}


def eval_step(state: TrainState, batch: PairedComplex, weight_classes: bool = False,
              mesh: Optional[DataMesh] = None) -> Dict[str, torch.Tensor]:
    """Eval-mode forward, loss and per-pair probabilities; no update."""
    return eval_step_body(state, batch.to(_device(state.model)), weight_classes, mesh)


def multi_eval_step(state: TrainState, batches: Sequence[PairedComplex],
                    weight_classes: bool = False, graphs=None,
                    mesh: Optional[DataMesh] = None) -> Dict[str, torch.Tensor]:
    """K eval steps over same-shape batches (placed on the model's
    device), the JAX ``multi_eval_step``: ``loss`` [K], ``probs`` and
    ``logits`` [K, B, L1, L2, 2], on the device. With ``graphs`` each
    batch replays its key's eval graph, else the body runs eagerly
    (pair-sharded with a ``mesh`` that has a pair axis)."""
    out: Dict[str, torch.Tensor] = {}
    for j, batch in enumerate(batches):
        step = (graphs.eval(batch) if graphs is not None
                else eval_step_body(state, batch, weight_classes, mesh))
        for name, value in step.items():
            if name not in out:
                out[name] = torch.empty((len(batches), *value.shape), dtype=value.dtype,
                                        device=value.device)
            out[name][j].copy_(value)
    return out
