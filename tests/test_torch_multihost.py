"""The port's process group and host agreement (``parallel/multihost.py``,
``parallel/mesh.py``) against the JAX package's ``parallel/multihost.py``,
and the data-parallel loader shard (``data/loader.py``) against the JAX
loader's: one process, then two ranks on gloo in spawned processes that
meet at a FileStore under the test's directory."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

from deepinteract_tpu.data.loader import BucketedLoader as JaxBucketedLoader
from deepinteract_tpu.parallel import multihost as jax_multihost
from deepinteract_tpu_torch.data.loader import BucketedLoader
from deepinteract_tpu_torch.parallel import mesh, multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


@pytest.mark.parametrize("n,hosts", [(10, 3), (2, 5), (7, 1), (8, 4), (0, 2)])
def test_shard_filenames_for_host_matches_jax(n, hosts):
    names = [f"c{i}.npz" for i in range(n)]
    for host in range(hosts):
        assert multihost.shard_filenames_for_host(names, host, hosts) == \
            jax_multihost.shard_filenames_for_host(names, host, hosts)


def test_single_process_helpers_degrade_as_in_jax():
    """No group: rank 0 of 1, every host-side helper returns the local
    answer, and the exit barrier is a no-op; the grid needs a group, with
    a pair axis as without."""
    assert multihost.initialize_distributed() == 0 and not dist.is_initialized()
    assert multihost.process_index() == 0 and multihost.process_count() == 1
    assert multihost.is_primary_host() and not multihost.can_agree()
    names = [f"c{i}" for i in range(10)]
    assert multihost.shard_filenames_for_host(names) == names
    assert multihost.agree_any_flag("t", True) and not multihost.agree_any_flag("t", False)
    assert multihost.any_across_hosts(True) and not multihost.any_across_hosts(False)
    assert multihost.broadcast_floats([1.5, float("inf")]) == [1.5, float("inf")]
    multihost.assert_same_across_hosts([1.0, 2.0], "never raised")
    multihost.barrier()
    multihost.exit_barrier()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        mesh.make_mesh(num_pair=2)


def test_an_explicit_topology_that_does_not_come_up_raises(tmp_path):
    """Rank 0 of 2 alone: the rendezvous times out and raises, leaving no
    group (never a quiet single-process run); partial flags raise too."""
    with pytest.raises(RuntimeError):
        multihost.initialize_distributed(f"file://{tmp_path / 'store'}", 2, 0, device="cpu",
                                         timeout_s=1.0)
    assert not dist.is_initialized() and multihost.process_count() == 1
    with pytest.raises(ValueError, match="together"):
        multihost.initialize_distributed(num_processes=2)
    with pytest.raises(ValueError, match="outside"):
        multihost.initialize_distributed("file://x", 2, 2, device="cpu")


class _Lengths:
    """A dataset of lengths only: what the plan reads."""

    def __init__(self, lengths):
        self._lengths = lengths

    def lengths(self):
        return self._lengths

    def __len__(self):
        return len(self._lengths)


@pytest.mark.parametrize("drop_remainder,dispatch_run", [(True, 1), (False, 1), (True, 3)])
def test_sharded_loader_plans_the_jax_loaders_global_batches(drop_remainder, dispatch_run):
    """Every rank plans the JAX loader's global batches (wrapped within the
    bucket when short), takes its slice, and counts global steps."""
    rng = np.random.default_rng(4)
    ds = _Lengths([(int(a), int(b)) for a, b in rng.integers(20, 300, size=(23, 2))])
    kw = dict(batch_size=2, shuffle=True, drop_remainder=drop_remainder, seed=9,
              dispatch_run=dispatch_run)
    for rank in range(3):
        port = BucketedLoader(ds, shard=(rank, 3), **kw)
        ref = JaxBucketedLoader(ds, shard=(rank, 3), prefetch=0, **kw)
        assert port.num_batches() == ref.num_batches()
        for epoch in (0, 1):
            plan, ref_plan = port.epoch_plan(epoch), ref._epoch_plan(epoch)
            assert [(b, c) for b, c in plan] == [(tuple(b), c) for b, c in ref_plan]
            assert [port._host_slice(c) for _, c in plan] == \
                [ref._host_slice(c) for _, c in ref_plan]
    with pytest.raises(ValueError, match="rank"):
        BucketedLoader(ds, shard=(3, 3))


WORKER = r"""
import sys, threading
import torch
torch.set_num_threads(1)
from deepinteract_tpu_torch.data.datasets import DIPSDataset
from deepinteract_tpu_torch.data.loader import BucketedLoader
from deepinteract_tpu_torch.parallel import multihost
from deepinteract_tpu_torch.robustness import faults

store, rank, root = sys.argv[1], int(sys.argv[2]), sys.argv[3]
multihost.initialize_distributed(f"file://{store}", 2, rank, device="cpu", timeout_s=60)
assert multihost.can_agree() and multihost.process_count() == 2
for case, flags in enumerate(((False, False), (False, True), (True, False))):
    print(f"agree {case} {multihost.agree_any_flag(f'case{case}', flags[rank])}")
# From a read-ahead thread, as the loader calls it.
box = []
t = threading.Thread(target=lambda: box.append(multihost.agree_any_flag("thread", rank == 1)))
t.start(); t.join()
print(f"thread {box[0]}")
print(f"any {multihost.any_across_hosts(rank == 1)} {multihost.any_across_hosts(False)}")
print(f"broadcast {multihost.broadcast_floats([10.0 + rank, float('inf')])}")
multihost.assert_same_across_hosts([1.0, 2.0], "equal values raised")
try:
    multihost.assert_same_across_hosts([float(rank)], "ranks differ")
    print("mismatch passed")
except AssertionError as exc:
    print(f"mismatch raised {'ranks differ' in str(exc)}")
# Rank 1 fails to load its second batch: every rank drops that plan entry.
if rank == 1:
    faults.configure("loader.batch=@2")
loader = BucketedLoader(DIPSDataset(root, "train"), batch_size=1, shuffle=True, seed=3,
                        drop_remainder=True, skip_budget=1, shard=(rank, 2))
batches = list(loader.iter_epoch(0))
print(f"loader {loader.num_batches()} {len(batches)} {loader.skips_before(len(batches))}")
multihost.barrier()
multihost.exit_barrier()
print(f"after {multihost.process_count()}")
"""


def test_two_ranks_agree_through_the_store_and_the_host_group(tmp_path):
    """World size 2: ``agree_any_flag`` returns host 0's OR on both ranks
    (from the main thread and from another thread), the host-group
    helpers agree, ``assert_same_across_hosts`` raises on both ranks on a
    mismatch, and a load failure on rank 1 drops the same global batch on
    both ranks."""
    from deepinteract_tpu_torch.data.synthetic import write_tiny_npz_dataset

    root = tmp_path / "data"
    write_tiny_npz_dataset(str(root), n_complexes=6, seed=0)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(tmp_path / "store"), str(r),
                               str(root)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    for rank, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            pytest.fail(f"rank {rank} timed out:\n{proc.communicate()[0][-4000:]}")
        assert proc.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        outs.append([line for line in out.splitlines() if not line.startswith("skipping")])
    for lines in outs:
        got = dict(line.split(" ", 1) for line in lines if " " in line)
        assert [line for line in lines if line.startswith("agree")] == \
            ["agree 0 False", "agree 1 True", "agree 2 True"]
        assert got["thread"] == "True" and got["any"] == "True False"
        assert got["broadcast"] == "[10.0, inf]"
        assert got["mismatch"] == "raised True"
        assert got["loader"] == "3 2 1"  # 3 global steps, one dropped on every rank
        assert got["after"] == "1"


@pytest.mark.parametrize("flags,error,match", [
    (["--num_pair_shards", "100000"], ValueError, "needs 100000 devices"),
    (["--num_devices", "100000"], ValueError, "device"),
    (["--num_devices", "2", "--coordinator_address", "file://x", "--num_processes", "3",
      "--process_id", "0"], ValueError, "disagree"),
], ids=["pair_shards", "too_many_devices", "inconsistent"])
def test_train_cli_refuses_a_topology_it_cannot_run(tmp_path, flags, error, match):
    """No fallback: a pair axis or a data axis wider than the host's
    devices, and contradictory flags, raise before any group or process is
    started."""
    from deepinteract_tpu_torch.cli import train as train_cli

    args = train_cli.parse_args(["--dips_root", str(tmp_path), "--device", "cpu",
                                 "--ckpt_dir", str(tmp_path / "ck"), *flags])
    with pytest.raises(error, match=match):
        train_cli.run(args)
    assert not dist.is_initialized() and not (tmp_path / "ck").exists()


def test_supervised_rank_watches_its_own_heartbeat(tmp_path, monkeypatch):
    """``--supervise`` stays in front of the group, and the heartbeat it
    watches is the one the rank's trainer writes: heartbeat_p{process_id}."""
    from deepinteract_tpu_torch.cli import train as train_cli
    from deepinteract_tpu_torch.training import supervisor

    seen = {}

    class Recorder:
        def __init__(self, cmd_fn, cfg, log=None):
            seen["cfg"] = cfg

        def run(self):
            return 0

        def contract(self):
            return {}

    monkeypatch.setattr(supervisor, "TrainingSupervisor", Recorder)
    assert train_cli.main(["--supervise", "--ckpt_dir", str(tmp_path), "--device", "cpu",
                           "--coordinator_address", "file://x", "--num_processes", "2",
                           "--process_id", "1"]) == 0
    assert seen["cfg"].heartbeat_path == str(tmp_path / "obs" / "heartbeat_p1.json")
    assert not dist.is_initialized()
