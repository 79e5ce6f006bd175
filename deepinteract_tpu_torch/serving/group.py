"""A serving worker over a (data, pair) grid: a group of processes, one per
device, and the protocol of its dispatches.

The JAX engine drives a worker's ``(num_data, num_pair)`` mesh from one
process (``deepinteract_tpu/serving/engine.py``, GSPMD placement). Here
each device has a process (``cli.serve --mesh_shape DxP``, started as
``cli.train --num_devices`` starts its ranks: ``parallel.launch``). Rank 0
serves HTTP and owns the scheduler, admission, cache and engine; ranks
1..D*P-1 run the same engine as *followers* (:func:`follow`), with no
HTTP. Rank ``r`` sits at data index ``r // P`` and pair index ``r % P``
(``parallel.mesh.make_mesh``).

Every dispatch (a request batch's forward, a screen's encode or decode, a
warm-up capture) is one round of this protocol, driven by rank 0 alone
under the engine's exec lock:

1. rank 0 broadcasts a small header over the *control* group (gloo, the
   host): the op (``forward`` / ``encode`` / ``decode`` / ``stop``), the
   graph key, the placement, whether to capture only, and the inputs'
   shapes and types (:meth:`ServingGroup.announce`);
2. it broadcasts the inputs over the placement's device group (NCCL on
   the card, gloo on the CPU): the data group of pair index 0 for
   ``data``, the pair group of data index 0 for ``pair``;
3. every rank the placement involves (:meth:`ServingGroup.ranks_for`)
   takes its part of the inputs (its slots for ``data``, all of them for
   ``pair``), copies them into its entry's static buffers and replays the
   same key's graph, in the same order; a cold key is captured on all of
   them together, its collectives inside;
4. the output is gathered inside the graph (``slot_gather`` over the data
   group, ``pair_gather`` over the pair group), so rank 0 holds the whole
   batch's.

The ``repl`` placement (a slot count the data axis does not divide) runs
on rank 0 alone and sends nothing. In ``data`` placement the pair ranks
past index 0 wait: with no pair model on that path, their decode would
repeat pair index 0's. A follower that is not involved reads the header
and waits for the next.

Failures are loud. A follower that dies, or a dispatch that fails after
its header went out (the group's collectives are then out of step), makes
rank 0's dispatch raise ``BatchExecutionError`` and the worker exit with
:data:`LOST_RANK_EXIT` within :data:`LOSS_EXIT_BOUND_S` seconds, so a
fleet supervisor restarts the whole group; the followers die with rank 0
(their control channel closes, and the OS kills them with their parent).
``stop`` (drain, SIGTERM) ends every follower's loop; every rank then
exits 0.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from deepinteract_tpu_torch.data.graph import ProteinGraph
from deepinteract_tpu_torch.parallel.mesh import DataMesh

logger = logging.getLogger(__name__)

# Exit code of a worker whose group lost a rank, and the bound on the
# time from the loss to that exit (the monitor's poll, the grace for an
# in-flight dispatch to fail, the teardown).
LOST_RANK_EXIT = 3
LOSS_POLL_S = 0.2
LOSS_GRACE_S = 2.0
LOSS_EXIT_BOUND_S = 10.0
# The control group's timeout: a follower waits for its next header as
# long as the worker is idle (a dead peer is seen at once: its socket
# closes).
CONTROL_TIMEOUT = datetime.timedelta(days=365)


class GroupLost(RuntimeError):
    """The group can no longer dispatch: a rank died, or a dispatch failed
    after its header was sent."""


def _flatten(inputs: Sequence) -> Tuple[List[torch.Tensor], List]:
    """The tensors of a dispatch's inputs in broadcast order, and their
    layout: per input ``("graph", [(shape, dtype), ...])`` for a
    ``ProteinGraph`` or ``("tensor", (shape, dtype))``."""
    tensors, layout = [], []
    for x in inputs:
        if isinstance(x, ProteinGraph):
            parts = [torch.as_tensor(getattr(x, f.name)) for f in dataclasses.fields(x)]
            tensors += parts
            layout.append(("graph", [(tuple(t.shape), str(t.dtype)) for t in parts]))
        else:
            t = torch.as_tensor(x)
            tensors.append(t)
            layout.append(("tensor", (tuple(t.shape), str(t.dtype))))
    return tensors, layout


def _unflatten(tensors: List[torch.Tensor], layout) -> tuple:
    out, it = [], iter(tensors)
    for kind, spec in layout:
        if kind == "graph":
            out.append(ProteinGraph(**{f.name: next(it) for f, _ in
                                       zip(dataclasses.fields(ProteinGraph), spec)}))
        else:
            out.append(next(it))
    return tuple(out)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.split(".")[-1])


def local_part(inputs: Sequence, index: int, parts: int) -> tuple:
    """The ``index``-th of ``parts`` equal runs of slots of every input (a
    data rank's share of a ``data`` dispatch)."""
    tensors, layout = _flatten(inputs)
    n = tensors[0].shape[0] // parts
    return _unflatten([t[index * n:(index + 1) * n] for t in tensors], layout)


class ServingGroup:
    """One serving worker's group, on one of its ranks: the grid
    (``mesh``), the control group, and on rank 0 the started ranks
    (``children``, watched by a monitor thread)."""

    def __init__(self, mesh: DataMesh, children: Sequence = (),
                 store_path: Optional[str] = None):
        self.mesh = mesh
        self.children = list(children)
        self.store_path = store_path
        self.control = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
        self.lost: Optional[str] = None
        self._stopping = False
        self._monitor: Optional[threading.Thread] = None
        if self.is_leader and self.children:
            self._monitor = threading.Thread(target=self._watch, name="group-monitor",
                                             daemon=True)
            self._monitor.start()

    # -- topology ---------------------------------------------------------

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def world(self) -> int:
        return self.mesh.world

    @property
    def is_leader(self) -> bool:
        return self.mesh.rank == 0

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.mesh.num_data, self.mesh.num_pair)

    def ranks_for(self, placement: str) -> Tuple[int, ...]:
        """The ranks a dispatch of ``placement`` involves: pair index 0 of
        every data index (``data``), the pair group of data index 0
        (``pair``), rank 0 alone (``repl``, ``single``)."""
        num_data, num_pair = self.shape
        if placement == "data":
            return tuple(d * num_pair for d in range(num_data))
        if placement == "pair":
            return tuple(range(num_pair))
        return (0,)

    def _device_group(self, placement: str):
        return self.mesh.data_group if placement == "data" else self.mesh.pair.group

    # -- rank 0 -----------------------------------------------------------

    def announce(self, op: str, key: Tuple, placement: str, inputs: Sequence,
                 capture_only: bool = False) -> tuple:
        """Rank 0: send one dispatch's header and inputs to the ranks it
        involves (nothing when it involves rank 0 alone). Returns the
        inputs on this rank's device. Raises :class:`GroupLost` when the
        group lost a rank or the sends fail."""
        if self.lost:
            raise GroupLost(self.lost)
        device = self.mesh.device
        tensors, layout = _flatten(inputs)
        tensors = [t.to(device) for t in tensors]
        if len(self.ranks_for(placement)) > 1 or self.world > 1 and op == "stop":
            header = {"op": op, "key": key, "placement": placement,
                      "capture_only": capture_only, "layout": layout}
            try:
                dist.broadcast_object_list([header], src=0, group=self.control)
                self._broadcast(tensors, placement)
            except Exception as exc:  # noqa: BLE001 - a peer is gone
                self.fail(f"sending a {op} dispatch failed: {exc}")
                raise GroupLost(self.lost) from exc
        return _unflatten(tensors, layout)

    def _broadcast(self, tensors: List[torch.Tensor], placement: str) -> None:
        if not tensors:  # a stop
            return
        group = self._device_group(placement)
        for t in tensors:
            # Bool travels as bytes (every backend carries uint8).
            dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t, src=0,
                           group=group)

    def stop(self) -> None:
        """Rank 0: end every follower's loop (after the drain); every later
        dispatch raises. Best effort: a group that lost a rank has nothing
        to stop."""
        self._stopping = True
        if self.world > 1 and not self.lost:
            try:
                self.announce("stop", (), "single", ())
            except GroupLost as exc:
                logger.warning("stopping the group: %s", exc)
        self.lost = self.lost or "the serving group is stopped"

    def fail(self, reason: str) -> None:
        """Rank 0: mark the group lost (every later dispatch raises) and
        exit the worker within :data:`LOSS_EXIT_BOUND_S`."""
        if self.lost:
            return
        self.lost = f"the serving group is lost: {reason}"
        logger.error("%s; the worker exits with code %d", self.lost, LOST_RANK_EXIT)
        threading.Thread(target=self._exit_after_grace, name="group-exit",
                         daemon=True).start()

    def _exit_after_grace(self) -> None:
        time.sleep(LOSS_GRACE_S)
        for child in self.children:
            if child.poll() is None:
                child.kill()
        if self.store_path and os.path.exists(self.store_path):
            os.remove(self.store_path)
        logging.shutdown()
        os._exit(LOST_RANK_EXIT)

    def _watch(self) -> None:
        """Rank 0's monitor: a started rank that exits before ``stop``
        loses the group."""
        while not self._stopping and not self.lost:
            for rank, child in enumerate(self.children, start=1):
                rc = child.poll()
                if rc is not None and not self._stopping:
                    self.fail(f"rank {rank} (pid {child.pid}) exited with code {rc}")
                    return
            time.sleep(LOSS_POLL_S)

    def pids(self) -> Dict[int, int]:
        """Rank 0: the process ids of the group's ranks."""
        return {0: os.getpid(), **{rank: child.pid
                                   for rank, child in enumerate(self.children, start=1)}}

    # -- followers --------------------------------------------------------

    def receive(self) -> Tuple[Dict, Optional[tuple]]:
        """A follower: the next header, and the dispatch's inputs on this
        rank's device when its placement involves this rank (else None)."""
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.control)
        header = box[0]
        if header["op"] == "stop" or self.rank not in self.ranks_for(header["placement"]):
            return header, None
        device = self.mesh.device
        tensors = []
        for kind, spec in header["layout"]:
            for shape, dtype in (spec if kind == "graph" else [spec]):
                tensors.append(torch.empty(shape, dtype=_dtype(dtype), device=device))
        self._broadcast(tensors, header["placement"])
        return header, _unflatten(tensors, header["layout"])


def check_same_weights(group: ServingGroup, model) -> None:
    """Every rank serves the same weights: a float64 sum of each
    parameter and buffer, compared over the control group at startup."""
    sums = torch.tensor([float(t.detach().double().sum()) for t in model.state_dict().values()],
                        dtype=torch.float64)
    gathered = [torch.empty_like(sums) for _ in range(group.world)]
    dist.all_gather(gathered, sums, group=group.control)
    bad = [r for r, g in enumerate(gathered) if not torch.equal(g, gathered[0])]
    if bad:
        raise RuntimeError(f"serving group: ranks {bad} load other weights than rank 0")


def follow(engine) -> int:
    """A follower's loop: run every dispatch rank 0 announces that
    involves this rank (the same key's entry, captured with the others
    when cold), until ``stop``. Returns the number of dispatches run."""
    group = engine.group
    runs = 0
    while True:
        header, inputs = group.receive()
        if header["op"] == "stop":
            return runs
        if inputs is None:
            continue
        with engine._exec_lock:
            engine._run_placed(header["op"], header["key"], header["placement"], inputs,
                               capture_only=header["capture_only"])
        runs += 1
