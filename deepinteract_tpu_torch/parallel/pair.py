"""The pair axis: a complex's pair map split by rows over a group of
processes, one per device.

The JAX package shards the ``[B, L1, L2, C]`` pair map's rows over the
mesh's ``pair`` axis with sharding annotations (``shard_pair_rows``,
``deepinteract_tpu/models/stem.py``) and lets XLA insert the halo
exchanges and the cross-shard reductions. Here those operations are
explicit, over this rank's pair group (:class:`PairMesh`, made by
``parallel.mesh.make_mesh``):

* :meth:`PairMesh.halo`: the ``h`` rows above and below the rank's rows,
  from its neighbours on the pair axis (zero rows at the map's global
  edges), so a 3x3 conv of dilation ``h`` sees what it would see on the
  whole map; its backward sends the halo rows' gradients back to their
  owners, which add them into their edge rows;
* :meth:`PairMesh.all_reduce_autograd`: a differentiable sum over the
  pair group (instance-norm and squeeze-excitation statistics);
* :meth:`PairMesh.all_reduce` and :meth:`PairMesh.gather_rows`: the eval
  step's loss sums and whole maps;
* :func:`row_slices`: a rank's rows of a map of ``blocks`` row blocks (the
  tiles of a tiled decode; one block untiled).

Every collective is counted by site in ``parallel.mesh.ALL_REDUCES``. On
the card the group is NCCL and the halo rides ``batch_isend_irecv`` with
the two neighbours (P2P, which NCCL captures in a CUDA graph;
``pair_shard_check.py`` holds graphed against eager steps). No primitive
has a local stand-in: a sharded decode without a pair mesh raises
(``models/model.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from deepinteract_tpu_torch.parallel.mesh import ALL_REDUCES, AllReduceSum, all_reduce_group


@dataclasses.dataclass(frozen=True)
class PairMesh:
    """This rank's view of its pair group: its pair ``index``, the group's
    ``size``, the group, its global ``ranks`` by pair index and the
    device."""

    index: int
    size: int
    group: object
    ranks: Tuple[int, ...]
    device: torch.device

    # -- rows -------------------------------------------------------------

    def rows(self, total: int, halo: int = 0) -> int:
        """This rank's row count of a ``total``-row map (block); raises
        unless the group divides it into shards of at least ``halo``
        rows (a halo comes from the immediate neighbours only)."""
        if total % self.size:
            raise ValueError(f"pair-map sharding: {total} rows do not split over "
                             f"{self.size} pair shards (pad the chains to a multiple, or "
                             "use a pair axis that divides the bucket or the tile)")
        rows = total // self.size
        if rows < halo:
            raise ValueError(f"pair-map sharding: a shard of {rows} rows is narrower than "
                             f"the decoder's halo of {halo} rows ({total} rows over "
                             f"{self.size} shards: use fewer pair shards or larger buckets)")
        return rows

    # -- collectives ------------------------------------------------------

    def all_reduce(self, tensor: torch.Tensor, site: str) -> torch.Tensor:
        """The sum of a detached copy of ``tensor`` over the pair group."""
        return all_reduce_group(tensor, self.group, site)

    def all_reduce_autograd(self, tensor: torch.Tensor, site: str) -> torch.Tensor:
        """The sum over the pair group, differentiable (its backward sums
        the gradient over the group, ``site + "_grad"``)."""
        return AllReduceSum.apply(tensor, self.group, site)

    def gather_rows(self, tensor: torch.Tensor, blocks: int, site: str = "pair_gather"
                    ) -> torch.Tensor:
        """The whole map from every rank's rows (no autograd): ``tensor``
        is ``[B, blocks * r, ...]`` (:func:`row_slices`' rows of each
        rank), the result ``[B, blocks * r * size, ...]`` in map order."""
        t = tensor.detach().contiguous()
        out = torch.empty((self.size * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        ALL_REDUCES[site] += 1
        dist.all_gather_into_tensor(out, t, group=self.group)
        b, n, *rest = t.shape
        out = out.reshape(self.size, b, blocks, n // blocks, *rest)
        out = out.permute(1, 2, 0, *range(3, out.dim()))
        return out.reshape(b, n * self.size, *rest)

    def halo_rows(self, x: torch.Tensor, h: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[B, C, R, W]`` -> (the ``h`` rows above the rank's rows, the
        ``h`` rows below them), each ``[B, C, h, W]``, from the neighbours
        (zeros past the map's edges); differentiable."""
        return _Halo.apply(x, self, h)

    def halo(self, x: torch.Tensor, h: int) -> torch.Tensor:
        """``[B, C, R, W]`` -> ``[B, C, R + 2h, W]``: the rank's rows between
        its halo rows (:meth:`halo_rows`)."""
        above, below = self.halo_rows(x, h)
        return torch.cat([above, x, below], dim=2)

    def _exchange(self, top: torch.Tensor, bottom: torch.Tensor, site: Optional[str]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Send ``top`` to the upper neighbour and ``bottom`` to the lower
        one; return (what the upper neighbour sent down, what the lower
        one sent up), zeros where there is no neighbour. Counted at
        ``site`` (None: not counted)."""
        if site is not None:
            ALL_REDUCES[site] += 1
        top, bottom = top.contiguous(), bottom.contiguous()
        above, below = torch.zeros_like(bottom), torch.zeros_like(top)
        ops = []
        if self.index > 0:
            peer = self.ranks[self.index - 1]
            ops += [dist.P2POp(dist.isend, top, peer, self.group),
                    dist.P2POp(dist.irecv, above, peer, self.group)]
        if self.index + 1 < self.size:
            peer = self.ranks[self.index + 1]
            ops += [dist.P2POp(dist.isend, bottom, peer, self.group),
                    dist.P2POp(dist.irecv, below, peer, self.group)]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return above, below

    def warm_up(self) -> None:
        """One all-reduce and one halo exchange on the pair group: the
        communicator and its P2P connections exist before any capture."""
        warm = torch.zeros(1, device=self.device)
        dist.all_reduce(warm, group=self.group)
        x = torch.zeros((1, 1, 2, 1), device=self.device)
        self._exchange(x[:, :, :1], x[:, :, 1:], None)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pair: PairMesh, h: int):
        ctx.pair, ctx.h, ctx.shape = pair, h, x.shape
        return pair._exchange(x[:, :, :h], x[:, :, -h:], "halo")

    @staticmethod
    def backward(ctx, grad_above, grad_below):
        pair, h = ctx.pair, ctx.h
        # The halo rows' gradients belong to the neighbours' edge rows:
        # the upper halo's go up, the lower halo's down, and each rank adds
        # what comes back into its own first and last rows.
        for_top, for_bottom = pair._exchange(grad_above, grad_below, "halo_grad")
        out = torch.zeros(ctx.shape, dtype=for_top.dtype, device=for_top.device)
        out[:, :, :h] += for_top
        out[:, :, -h:] += for_bottom
        return out, None, None


def row_slices(total: int, pair: PairMesh, blocks: int = 1, halo: int = 0) -> List[slice]:
    """This rank's rows of a ``total``-row map of ``blocks`` equal row
    blocks (tile rows; 1 untiled): in each block, the ``index``-th of
    ``size`` equal runs."""
    block = total // blocks
    rows = pair.rows(block, halo)
    return [slice(b * block + pair.index * rows, b * block + (pair.index + 1) * rows)
            for b in range(blocks)]


def take_rows(x: torch.Tensor, slices: List[slice]) -> torch.Tensor:
    """``x[:, rows]`` for the rows of ``slices`` (python slices: no index
    tensor is copied to the device inside a captured step)."""
    parts = [x[:, s] for s in slices]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


class _Active(threading.local):
    pair: Optional[PairMesh] = None


# Per thread: a serving engine enters ``pair_sharded`` on the thread that
# captures or replays a key while other threads of its process serve
# requests; none of them may see another thread's pair group.
_ACTIVE = _Active()


def active_pair() -> Optional[PairMesh]:
    """The pair mesh of the sharded step running now on this thread
    (:func:`pair_sharded`), None outside one."""
    return _ACTIVE.pair


@contextlib.contextmanager
def pair_sharded(pair: Optional[PairMesh]):
    """Inside the block a model with ``shard_pair_map`` decodes this
    rank's rows over ``pair`` (nothing changes with None); the block holds
    for the calling thread only."""
    previous, _ACTIVE.pair = _ACTIVE.pair, pair
    try:
        yield pair
    finally:
        _ACTIVE.pair = previous
