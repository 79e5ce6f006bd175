"""Data-parallel train and eval steps.

Port of the data axis of ``deepinteract_tpu/parallel/train.py``. There
GSPMD shards the batch of the one pure ``train_step`` over the mesh, and
a step over W devices equals the single-device step on the global batch
of W*B complexes. Here every rank runs ``steps.train_step_body`` on its
own B complexes with the :class:`~.mesh.DataMesh`, which makes the step
that same global one (``training/steps.py``):

* the loss divides each rank's weighted sum by the global weight sum,
  and the reported loss is the sum of the ranks' terms;
* train-mode batch norms take their statistics over every valid node of
  the global batch, with gradients through them;
* dropout hashes each element's index in the global batch;
* the flat gradient buffer is summed over the ranks right after the
  backward, before the norm, the guard and the update, so every rank
  clips, skips or updates identically.

On the card each train step is replayed from a CUDA graph that holds
those collectives (``training/step_graphs.StepGraphs`` with the mesh).
Evaluation stays replicated: every rank evaluates the whole val and test
splits, with no collective, as the JAX ``cli.train`` does.
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
    """``(state, batch) -> outputs``: the replicated eval step (no
    collective; ``mesh`` only names the axis it is replicated over)."""
    return partial(steps.eval_step, weight_classes=weight_classes)


def make_sharded_multi_eval_step(mesh: DataMesh, weight_classes: bool = False):
    """``(state, batches, graphs=None) -> [K] outputs``: replicated eval
    steps (``steps.multi_eval_step``), no collective."""
    return partial(steps.multi_eval_step, weight_classes=weight_classes)
