"""Multi-process training: the process group, per-host data sharding and
host-side agreement.

Port of ``deepinteract_tpu/parallel/multihost.py`` to ``torch.distributed``,
one process per device (the reference's Lightning DDP over NCCL,
``--num_compute_nodes``). :func:`initialize_distributed` joins this
process to the group from ``cli.train``'s ``--coordinator_address`` /
``--num_processes`` / ``--process_id``: the backend is NCCL on CUDA and
gloo on the CPU, and each rank binds ``cuda:<local rank>``. Beside the
data group it keeps:

* the rendezvous store, the transport of :func:`agree_any_flag` (the
  loader's skip decisions, made on its read-ahead thread while the main
  thread may be replaying a step graph that holds NCCL collectives);
* a gloo group for the host-side collectives of the main thread
  (:func:`assert_same_across_hosts`, :func:`any_across_hosts`,
  :func:`broadcast_floats`), so no NCCL collective ever carries host
  bookkeeping.

A coordinator address is ``host:port`` (or ``tcp://host:port``: a
TCPStore served by rank 0) or ``file://PATH`` (a FileStore, for ranks on
one machine). Without a group every helper degrades to one process.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import logging
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# Rendezvous and collective timeout of a group this module creates.
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass
class _Runtime:
    store: "dist.Store"
    host_group: object
    device: torch.device


_RUNTIME: Optional[_Runtime] = None


def _make_store(address: str, world: int, rank: int, timeout: datetime.timedelta):
    if address.startswith("file://"):
        store = dist.FileStore(address[len("file://"):], world)
        store.set_timeout(timeout)
        return store
    host, _, port = address[len("tcp://"):].rpartition(":") if address.startswith(
        "tcp://") else address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r}: expected host:port, "
                         "tcp://host:port or file://PATH")
    return dist.TCPStore(host, int(port), world, is_master=rank == 0, timeout=timeout,
                         wait_for_workers=True)


def local_device(process_id: int, device: Optional[torch.device] = None) -> torch.device:
    """The device rank ``process_id`` binds: ``cuda:<local rank>`` on CUDA
    (the rank modulo the host's devices), the CPU otherwise."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return torch.device("cpu")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(f"rank {process_id} needs a CUDA device, this host has none")
    return torch.device("cuda", process_id % count)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: Optional[torch.device] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join the process group, idempotently; returns this process's rank.

    Without a topology (no argument set) the run is one process: nothing
    is created and 0 is returned. An explicit topology that does not come up
    within ``timeout_s`` raises; it never degrades to one process. On CUDA
    the rank's device is made current and the NCCL communicator is
    created eagerly (``device_id``, then one collective), before any step
    graph is captured."""
    global _RUNTIME
    if dist.is_initialized():
        return dist.get_rank()
    if all(v is None for v in (coordinator_address, num_processes, process_id)):
        return 0
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs --coordinator_address, --num_processes "
                         "and --process_id together")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is outside [0, {num_processes})")
    bound = local_device(process_id, device)
    backend = "nccl" if bound.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    store = _make_store(coordinator_address, num_processes, process_id, timeout)
    kwargs = {}
    if bound.type == "cuda":
        torch.cuda.set_device(bound)
        kwargs["device_id"] = bound
    dist.init_process_group(backend, store=dist.PrefixStore("data", store), rank=process_id,
                            world_size=num_processes, timeout=timeout, **kwargs)
    host_group = dist.new_group(backend="gloo", timeout=timeout)
    warm = torch.zeros(1, device=bound)
    dist.all_reduce(warm)  # the communicator exists before the first capture
    if bound.type == "cuda":
        torch.cuda.synchronize(bound)
    _RUNTIME = _Runtime(dist.PrefixStore("agree", store), host_group, bound)
    return process_id


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


process_index, process_count = _rank, _world


def backend() -> Optional[str]:
    """The data group's backend (``nccl`` or ``gloo``), None without one."""
    return dist.get_backend() if dist.is_initialized() else None


def bound_device() -> Optional[torch.device]:
    """The device :func:`initialize_distributed` bound, None without a group."""
    return None if _RUNTIME is None else _RUNTIME.device


def shard_filenames_for_host(filenames: Sequence[str], process_index: Optional[int] = None,
                             process_count: Optional[int] = None) -> list:
    """This host's shard of a work list: the same ``filenames`` order on
    every host gives disjoint shards, the remainder wrapped as torch's
    DistributedSampler pads, so shard lengths match and nothing is left
    out. For per-host work without collectives (featurization, dataset
    builds, sweeps); a training list is sharded by the loader's
    coordinated plan (``BucketedLoader(shard=...)``) instead, since
    per-host lists would give hosts different batch shapes."""
    pi = _rank() if process_index is None else process_index
    pc = _world() if process_count is None else process_count
    if pc <= 1:
        return list(filenames)
    names = list(filenames)
    per_host = -(-len(names) // pc)  # ceil
    padded = list(itertools.islice(itertools.cycle(names), per_host * pc))
    start = pi * per_host
    return padded[start:start + per_host]


def _host_group():
    if _RUNTIME is None:
        raise RuntimeError("host-side agreement needs initialize_distributed's group")
    return _RUNTIME.host_group


def assert_same_across_hosts(values, fail_message: str) -> None:
    """Raise on every host unless a small vector of host-side values is
    equal on all of them (no-op for one process). A collective over the
    gloo host group: call it from code that every host runs at the same
    point, on the main thread."""
    if process_count() <= 1:
        return
    local = torch.as_tensor(values, dtype=torch.float64).reshape(-1)
    gathered = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(gathered, local, group=_host_group())
    if not all(torch.equal(g, gathered[0]) for g in gathered[1:]):
        raise AssertionError(f"{fail_message}: values per host "
                             f"{[g.tolist() for g in gathered]}")


def any_across_hosts(local_flag: bool) -> bool:
    """OR of one flag per host, by an all-gather over the host group (the
    preemption poll at an epoch boundary). One process: the flag."""
    if process_count() <= 1:
        return bool(local_flag)
    local = torch.tensor([1 if local_flag else 0], dtype=torch.int64)
    gathered = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(gathered, local, group=_host_group())
    return any(int(g) for g in gathered)


def broadcast_floats(values: Sequence[float]) -> List[float]:
    """Host 0's float64 values on every host (the resume scalars and loss
    ledger); every host passes a vector of the same length."""
    if process_count() <= 1:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64)
    dist.broadcast(t, src=0, group=_host_group())
    return t.tolist()


def can_agree() -> bool:
    """True when :func:`agree_any_flag` has a transport: a multi-process
    group with its rendezvous store."""
    return process_count() > 1 and _RUNTIME is not None


def agree_any_flag(tag: str, local_flag: bool, timeout_s: float = 120.0) -> bool:
    """Host-0-decides OR over one boolean per host, through the rendezvous
    store (host-side requests, no device collective), so it is safe on
    the loader's read-ahead thread while the main thread is inside a
    step's collectives. Every host publishes its flag under ``tag``; host 0
    reads them all and publishes the OR; every host returns that verdict.
    ``tag`` must be unique per decision. One process: the local flag."""
    if process_count() <= 1:
        return bool(local_flag)
    if _RUNTIME is None:
        raise RuntimeError("agree_any_flag needs initialize_distributed's store: refusing to "
                           "guess a cross-host decision")
    store, rank = _RUNTIME.store, process_index()
    timeout = datetime.timedelta(seconds=timeout_s)
    store.set(f"{tag}/h{rank}", "1" if local_flag else "0")
    if rank == 0:
        verdict = bool(local_flag)
        for peer in range(1, process_count()):
            key = f"{tag}/h{peer}"
            store.wait([key], timeout)
            verdict = verdict or store.get(key) == b"1"
        store.set(f"{tag}/verdict", "1" if verdict else "0")
        return verdict
    store.wait([f"{tag}/verdict"], timeout)
    return store.get(f"{tag}/verdict") == b"1"


def is_primary_host() -> bool:
    """True on the process that writes checkpoints, logs and the test CSV
    (rank 0, as the reference's Lightning callbacks)."""
    return process_index() == 0


def barrier() -> None:
    """Every host meets here (the host group; no-op for one process): the
    packed cache that rank 0 writes is read after it."""
    if process_count() > 1:
        dist.barrier(group=_host_group())


def abort_group() -> None:
    """Destroy the process group without meeting the peers (a rank that
    fails leaves at once: its peers may be stuck in a collective that it
    never joins). No-op without a group."""
    global _RUNTIME
    if dist.is_initialized():
        try:
            dist.destroy_process_group()
        except Exception as exc:  # noqa: BLE001 - best effort on the way out
            logger.warning("destroying the process group failed: %s", exc)
    _RUNTIME = None


def exit_barrier(tag: str = "exit") -> None:
    """Meet every host, then destroy the process group (the data group,
    the host group and the store): hosts leave ``cli.train`` at different
    times (rank 0 drains checkpoints), so the rendezvous runs while they
    are still aligned. Best effort: a failure here is logged and never
    turns a finished or preempted run into a crash. No collective may run
    after it. No-op without a group."""
    if not dist.is_initialized():
        return
    try:
        if _RUNTIME is not None and process_count() > 1:
            dist.barrier(group=_RUNTIME.host_group)
    except Exception as exc:  # noqa: BLE001 - a peer may be gone already
        logger.warning("exit barrier %r failed (peer already down?): %s", tag, exc)
    abort_group()
