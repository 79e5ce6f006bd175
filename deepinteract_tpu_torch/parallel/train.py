"""Sharded train and eval steps: data-parallel, pair-map sharded, or both.

Port of ``deepinteract_tpu/parallel/train.py``. There GSPMD shards the
batch of the one pure ``train_step`` over the mesh's ``data`` axis and
the pair map's rows over its ``pair`` axis, and a step over D x P devices
equals the single-device step on the global batch of D*B complexes. Here
every rank runs ``steps.train_step_body`` on its data index's B complexes
with the :class:`~.mesh.DataMesh`, which makes the step that same global
one (``training/steps.py``):

* the loss divides each rank's weighted sum by the global weight sum,
  and the reported loss is the sum of the ranks' terms;
* train-mode batch norms take their statistics over every valid node of
  the global batch, with gradients through them;
* dropout hashes each element's index in the global batch;
* the flat gradient buffer is summed over the ranks right after the
  backward, before the norm, the guard and the update, so every rank
  clips, skips or updates identically;
* with a pair axis (a model with ``shard_pair_map``) the P ranks of a
  data index encode the same complexes and decode one run of rows of
  each map each, with halo exchanges and statistics over their pair group
  (``parallel/pair.py``); the loss, the reported loss and the gradient
  are summed over data x pair, the encoder's batch norms over the data
  group only (each data group holds the global batch once).

On the card each train step is replayed from a CUDA graph that holds
those collectives (``training/step_graphs.StepGraphs`` with the mesh).
Evaluation stays replicated over the data axis: every rank evaluates the
whole val and test splits, with no data collective, as the JAX
``cli.train`` does; over a pair axis each rank decodes its rows and the
eval step gathers the whole maps.
"""

from __future__ import annotations

from functools import partial

from deepinteract_tpu_torch.parallel.mesh import DataMesh
from deepinteract_tpu_torch.training import steps


def make_sharded_train_step(mesh: DataMesh, weight_classes: bool = False,
                            guard: bool = False):
    """``(state, batch) -> metrics``: one eager data-parallel step on this
    rank's batch (``steps.train_step``)."""
    return partial(steps.train_step, weight_classes=weight_classes, guard=guard, mesh=mesh)


def make_sharded_multi_step(mesh: DataMesh, weight_classes: bool = False,
                            guard: bool = False):
    """``(state, batches, graphs=None) -> [K] metrics``: K data-parallel
    steps (``steps.multi_train_step``), replayed from ``graphs`` (a
    ``StepGraphs`` built with the same mesh) on the card."""
    return partial(steps.multi_train_step, weight_classes=weight_classes, guard=guard,
                   mesh=mesh)


def make_sharded_eval_step(mesh: DataMesh, weight_classes: bool = False):
    """``(state, batch) -> outputs``: the eval step, replicated over the
    data axis (no data collective) and row-sharded over a pair axis."""
    return partial(steps.eval_step, weight_classes=weight_classes, mesh=mesh)


def make_sharded_multi_eval_step(mesh: DataMesh, weight_classes: bool = False):
    """``(state, batches, graphs=None) -> [K] outputs``: eval steps
    (``steps.multi_eval_step``), replicated over data, row-sharded over a
    pair axis."""
    return partial(steps.multi_eval_step, weight_classes=weight_classes, mesh=mesh)
