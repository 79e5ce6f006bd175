"""The data axis: one process per device, and the all-reduces of a
data-parallel train step.

Port of the data axis of ``deepinteract_tpu/parallel/mesh.py``. The JAX
package drives all devices from one process through a ``(data, pair)``
mesh and lets GSPMD insert the collectives; here each device has a
process, and :func:`make_mesh` returns this rank's view of the group
(:class:`DataMesh`). A rank holds only local tensors, so the JAX
``host_local_array`` has no counterpart, and the pair axis (``num_pair``
> 1, ``serving_mesh``) is ROADMAP item 10b.

The step's collectives go through :class:`DataMesh`, which counts each
one it issues in :data:`ALL_REDUCES` by site: Python runs once per CUDA
graph capture, so a capture's counts are the collectives baked into it
(``training/step_graphs.py``), as K1's launch counter counts its launches.
Sites: ``grads`` (the optimizer's flat gradient, after the backward),
``loss`` (the global weight sum of the loss and the reported loss),
``batch_norm`` (two per train-mode :class:`~deepinteract_tpu_torch.models.
layers.MaskedBatchNorm` call: the sums with the count, then the centred
squares) and ``batch_norm_grad`` (their backward, issued by the autograd
engine).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from deepinteract_tpu_torch.parallel import multihost

# All-reduces issued, by site (Python counts: a capture, never a replay).
ALL_REDUCES: "collections.Counter[str]" = collections.Counter()


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This rank's view of the data axis: its rank, the world size, the
    device it binds and the backend of the group (``nccl`` or ``gloo``).
    The group is the default process group."""

    rank: int
    world: int
    device: torch.device
    backend: str

    def all_reduce_(self, tensor: torch.Tensor, site: str) -> torch.Tensor:
        """Sum ``tensor`` over the ranks in place (no autograd)."""
        ALL_REDUCES[site] += 1
        dist.all_reduce(tensor)
        return tensor

    def all_reduce(self, tensor: torch.Tensor, site: str) -> torch.Tensor:
        """The sum of a detached copy of ``tensor`` over the ranks."""
        return self.all_reduce_(tensor.detach().clone(memory_format=torch.contiguous_format),
                                site)

    def broadcast_(self, tensors) -> None:
        """Rank 0's values written into ``tensors`` in place on every rank
        (the resume's state, on the main thread)."""
        for t in tensors:
            dist.broadcast(t, src=0)

    def all_reduce_autograd(self, tensor: torch.Tensor, site: str) -> torch.Tensor:
        """The sum over the ranks, differentiable: its backward sums the
        incoming gradient over the ranks (``site + "_grad"``), as
        ``torch.distributed.nn.functional.all_reduce`` does, with both
        directions counted."""
        return _AllReduceSum.apply(tensor, self, site)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, mesh: DataMesh, site: str):
        ctx.mesh, ctx.site = mesh, site
        return mesh.all_reduce(tensor, site)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad, ctx.site + "_grad"), None, None


def available_devices(device: torch.device) -> int:
    """Devices one host offers the data axis: its CUDA devices, or its CPU
    cores for CPU ranks."""
    return torch.cuda.device_count() if device.type == "cuda" else (os.cpu_count() or 1)


def make_mesh(num_data: Optional[int] = None, num_pair: int = 1) -> DataMesh:
    """The data axis over the initialized group (``parallel.multihost.
    initialize_distributed``), one process per device. ``num_data``
    (default: the world size) must be the world size. Raises for a pair
    axis (``num_pair > 1``, ROADMAP item 10b) and without a group."""
    if num_pair != 1:
        raise NotImplementedError(
            f"a pair axis of {num_pair} shards (pair-map sharding) is not ported yet: "
            "ROADMAP queue 1, item 10b")
    device = multihost.bound_device()
    if device is None:
        raise RuntimeError("make_mesh needs the process group: call "
                           "parallel.multihost.initialize_distributed first")
    world = multihost.process_count()
    if num_data is not None and num_data != world:
        raise ValueError(f"a data axis of {num_data} needs {num_data} processes, the group "
                         f"has {world}")
    return DataMesh(multihost.process_index(), world, device, multihost.backend())


_ACTIVE: Optional[DataMesh] = None


def active_mesh() -> Optional[DataMesh]:
    """The mesh of the train-mode forward running now (:func:`data_parallel`),
    None outside one."""
    return _ACTIVE


@contextlib.contextmanager
def data_parallel(mesh: Optional[DataMesh]):
    """Inside the block, train-mode batch norms take their statistics over
    the global batch of ``mesh`` (nothing changes with None)."""
    global _ACTIVE
    previous, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = previous
