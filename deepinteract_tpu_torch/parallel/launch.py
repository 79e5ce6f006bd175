"""Start or join the ranks of a (data, pair) grid, one process per device.

``cli.train`` and ``cli.test`` (``--num_devices D --num_pair_shards P``)
and ``cli.serve`` (``--mesh_shape DxP``) share this: rank 0 is the
process that runs :func:`rank_group`, and it starts ranks 1..D*P-1 as
copies of its own command line (``python -m MODULE ARGV``) with the
coordinator flags appended, meeting at a FileStore in ``run_dir``; or,
given a coordinator address, the process joins a group started
elsewhere. The block receives a :class:`RankGroup`: the grid and the
started ranks. On the way out every rank meets at the exit barrier, the
group is destroyed and the started ranks are waited for (one that failed
raises); on an error the group is destroyed without the barrier and the
started ranks are killed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple, Type

import torch

from deepinteract_tpu_torch.parallel import multihost
from deepinteract_tpu_torch.parallel.mesh import DataMesh, available_devices


@dataclasses.dataclass
class RankGroup:
    """The grid of this rank (``mesh``) and, on the rank that started the
    others, their processes (``children``, by rank 1..) and the store."""

    mesh: DataMesh
    children: List[subprocess.Popen]
    store_path: Optional[str]


def check_devices(n: int, device: torch.device, label: str) -> None:
    """Raise unless this host offers ``n`` devices of ``device``'s type
    (``label``: the flags that asked for them)."""
    have = available_devices(device)
    if n > have:
        raise ValueError(f"{label} needs {n} devices: this host has {have} {device.type} "
                         "device(s)")


@contextlib.contextmanager
def rank_group(argv: Sequence[str], module: str, n: int, make: Callable[[], DataMesh],
               device: torch.device, run_dir: str = ".",
               coordinator: Optional[Tuple[str, int, int]] = None, label: str = "",
               graceful: Tuple[Type[BaseException], ...] = (), exit_tag: str = "exit"):
    """The ``n``-rank group and its grid, made by ``make`` once the group
    is up (``parallel.mesh.make_mesh`` or ``serving_mesh``). ``coordinator``
    is (address, processes, rank) to join a group started elsewhere;
    without it this process is rank 0 and starts the others (``label``
    names the flags in the ``needs N devices`` refusal). An exception of a
    ``graceful`` type still leaves through the exit barrier (``exit_tag +
    "-graceful"``)."""
    children, store_path = [], None
    if coordinator is not None:
        multihost.initialize_distributed(*coordinator, device)
    else:
        check_devices(n, device, label)
        os.makedirs(run_dir, exist_ok=True)
        store_path = os.path.abspath(os.path.join(
            run_dir, f".rendezvous-{os.getpid()}-{time.time_ns()}"))
        flags = ["--coordinator_address", f"file://{store_path}", "--num_processes", str(n)]
        children = [subprocess.Popen([sys.executable, "-m", module, *argv, *flags,
                                      "--process_id", str(rank)])
                    for rank in range(1, n)]
        try:
            multihost.initialize_distributed(f"file://{store_path}", n, 0, device)
        except BaseException:
            stop_ranks(children)
            raise
    try:
        yield RankGroup(make(), children, store_path)
    except graceful:
        _leave(children, store_path, exit_tag + "-graceful")
        raise
    except BaseException:
        stop_ranks(children)
        multihost.abort_group()
        raise
    _leave(children, store_path, exit_tag)


def stop_ranks(children) -> None:
    """Kill the started ranks and reap them."""
    for child in children:
        child.kill()
        child.wait()


def _leave(children, store_path, tag: str) -> None:
    """The exit barrier, then the started ranks' exit codes."""
    multihost.exit_barrier(tag)
    failed = [(rank, child.wait()) for rank, child in enumerate(children, start=1)]
    failed = [(rank, rc) for rank, rc in failed if rc != 0]
    if store_path and os.path.exists(store_path):
        os.remove(store_path)
    if failed:
        raise RuntimeError(f"ranks exited with codes {failed}")
