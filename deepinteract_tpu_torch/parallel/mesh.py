"""The (data, pair) grid of processes, one per device, and the
all-reduces of a sharded train step.

Port of ``deepinteract_tpu/parallel/mesh.py``. The JAX package drives all
devices from one process through a ``(data, pair)`` mesh and lets GSPMD
insert the collectives; here each device has a process, and
:func:`make_mesh` returns this rank's view of a ``num_data x num_pair``
grid (:class:`DataMesh`). Rank ``r`` sits at data index ``r // num_pair``
and pair index ``r % num_pair``, the JAX mesh's
``devices.reshape(num_data, num_pair)``. Two kinds of groups are made,
once, on every rank in the same order: a *data group* per pair index (the
ranks that share it: together they hold the global batch once) and a
*pair group* per data index (the ranks that split one batch's pair map by
rows, ``parallel/pair.py``). A rank holds only local tensors, so the JAX
``host_local_array`` has no counterpart. :func:`serving_mesh` is the grid
of one serving worker (``cli.serve --mesh_shape DxP``, ``serving/group.py``).

The step's collectives go through :class:`DataMesh` and
:class:`~deepinteract_tpu_torch.parallel.pair.PairMesh`, which count each
one they issue in :data:`ALL_REDUCES` by site: Python runs once per CUDA
graph capture, so a capture's counts are the collectives baked into it
(``training/step_graphs.py``), as K1's launch counter counts its launches.
Sites over the world (data x pair): ``grads`` (the optimizer's flat
gradient, after the backward) and ``loss`` (the global weight sum of the
loss and the reported loss). Over the data group: ``batch_norm`` (two
per train-mode :class:`~deepinteract_tpu_torch.models.layers.
MaskedBatchNorm` call: the sums with the count, then the centred squares)
and ``batch_norm_grad`` (their backward, issued by the autograd engine).
Over the pair group (``parallel/pair.py``): ``halo`` / ``halo_grad``,
``pair_norm`` / ``pair_norm_grad``, ``pair_se`` / ``pair_se_grad``,
``pair_loss`` and ``pair_gather``. A serving worker's data placement
gathers its slots over the data group (``slot_gather``).
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
    """This rank's view of the grid: its global rank, the world size, the
    device it binds and the backend of the groups (``nccl`` or ``gloo``);
    ``num_pair`` ranks split each batch's pair map (``pair``, a
    :class:`~deepinteract_tpu_torch.parallel.pair.PairMesh`, None without
    pair sharding) and ``data_group`` is this rank's data group (None:
    the default group, which it is when ``num_pair`` is 1)."""

    rank: int
    world: int
    device: torch.device
    backend: str
    num_pair: int = 1
    data_group: Optional[object] = None
    pair: Optional[object] = None

    @property
    def num_data(self) -> int:
        """Ranks on the data axis: the global batch is split this many ways."""
        return self.world // self.num_pair

    @property
    def data_rank(self) -> int:
        """This rank's index on the data axis: its slice of the global batch."""
        return self.rank // self.num_pair

    def all_reduce_(self, tensor: torch.Tensor, site: str) -> torch.Tensor:
        """Sum ``tensor`` over every rank (data x pair) in place (no autograd)."""
        ALL_REDUCES[site] += 1
        dist.all_reduce(tensor)
        return tensor

    def all_reduce(self, tensor: torch.Tensor, site: str) -> torch.Tensor:
        """The sum of a detached copy of ``tensor`` over every rank."""
        return self.all_reduce_(tensor.detach().clone(memory_format=torch.contiguous_format),
                                site)

    def broadcast_(self, tensors) -> None:
        """Rank 0's values written into ``tensors`` in place on every rank
        (the resume's state, on the main thread)."""
        for t in tensors:
            dist.broadcast(t, src=0)

    def gather_slots(self, tensor: torch.Tensor, site: str = "slot_gather") -> torch.Tensor:
        """The whole batch from every data rank's slots (no autograd):
        ``tensor`` is ``[s, ...]`` on each rank of the data group, the
        result ``[s * num_data, ...]`` in data-rank order."""
        t = tensor.detach().contiguous()
        out = torch.empty((self.num_data * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        ALL_REDUCES[site] += 1
        dist.all_gather_into_tensor(out, t, group=self.data_group)
        return out

    def all_reduce_autograd(self, tensor: torch.Tensor, site: str) -> torch.Tensor:
        """The sum over the data group, differentiable: its backward sums
        the incoming gradient over the data group (``site + "_grad"``), as
        ``torch.distributed.nn.functional.all_reduce`` does, with both
        directions counted. The batch norms' statistics: the data group
        holds the global batch once, whatever the pair axis (every pair
        rank encodes the same complexes)."""
        return AllReduceSum.apply(tensor, self.data_group, site)


def all_reduce_group(tensor: torch.Tensor, group, site: str) -> torch.Tensor:
    """The sum of a detached copy of ``tensor`` over ``group`` (None: the
    default group), counted at ``site``."""
    out = tensor.detach().clone(memory_format=torch.contiguous_format)
    ALL_REDUCES[site] += 1
    dist.all_reduce(out, group=group)
    return out


class AllReduceSum(torch.autograd.Function):
    """``apply(tensor, group, site)``: the sum over ``group``, whose
    backward sums the incoming gradient over the same group
    (``site + "_grad"``)."""

    @staticmethod
    def forward(ctx, tensor, group, site: str):
        ctx.group, ctx.site = group, site
        return all_reduce_group(tensor, group, site)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_group(grad, ctx.group, ctx.site + "_grad"), None, None


def available_devices(device: torch.device) -> int:
    """Devices one host offers the data axis: its CUDA devices, or its CPU
    cores for CPU ranks."""
    return torch.cuda.device_count() if device.type == "cuda" else (os.cpu_count() or 1)


def make_mesh(num_data: Optional[int] = None, num_pair: int = 1,
              shard_pair_map: bool = False) -> DataMesh:
    """The ``num_data x num_pair`` grid over the initialized group
    (``parallel.multihost.initialize_distributed``), one process per
    device; ``num_data`` defaults to the world size over ``num_pair``, and
    their product must be the world size. With ``num_pair > 1`` or
    ``shard_pair_map`` (a pair axis of one) the data and pair groups are
    made and warmed here, on every rank in the same order, before any
    step graph is captured. Raises without a group."""
    device = multihost.bound_device()
    if device is None:
        raise RuntimeError("make_mesh needs the process group: call "
                           "parallel.multihost.initialize_distributed first")
    world = multihost.process_count()
    if num_pair < 1 or world % num_pair:
        raise ValueError(f"a pair axis of {num_pair} does not divide the {world} processes")
    if num_data is None:
        num_data = world // num_pair
    if num_data * num_pair != world:
        raise ValueError(f"a {num_data} x {num_pair} (data x pair) grid needs "
                         f"{num_data * num_pair} processes, the group has {world}")
    rank, backend = multihost.process_index(), multihost.backend()
    if num_pair == 1 and not shard_pair_map:
        return DataMesh(rank, world, device, backend)
    from deepinteract_tpu_torch.parallel.pair import PairMesh

    data_group = None
    if num_pair > 1:
        for p in range(num_pair):  # every rank makes every group, in one order
            group = dist.new_group([d * num_pair + p for d in range(num_data)])
            if p == rank % num_pair:
                data_group = group
    pair_group, pair_ranks = None, ()
    for d in range(num_data):
        ranks = tuple(d * num_pair + p for p in range(num_pair))
        group = dist.new_group(list(ranks))
        if d == rank // num_pair:
            pair_group, pair_ranks = group, ranks
    pair = PairMesh(rank % num_pair, num_pair, pair_group, pair_ranks, device)
    mesh = DataMesh(rank, world, device, backend, num_pair, data_group, pair)
    pair.warm_up()
    warm = torch.zeros(1, device=device)
    dist.all_reduce(warm, group=data_group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return mesh


def serving_mesh(shape, shard_pair_map: bool = False) -> DataMesh:
    """The grid one serving worker owns, from its ``--mesh_shape``
    ``(num_data, num_pair)``: :func:`make_mesh`'s layout, so a worker's
    row-sharded decode partitions as the sharded train step does. Both axes
    are checked (a worker fails at startup on a topology its group does
    not have, never at its first decode); ``shard_pair_map`` makes the
    pair groups with one pair rank."""
    if len(shape) != 2:
        raise ValueError(f"serving mesh shape needs 2 axes, got {shape!r}")
    num_data, num_pair = int(shape[0]), int(shape[1])
    if num_data < 1 or num_pair < 1:
        raise ValueError(f"serving mesh axes must be >= 1, got {num_data}x{num_pair}")
    return make_mesh(num_data=num_data, num_pair=num_pair, shard_pair_map=shard_pair_map)


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
