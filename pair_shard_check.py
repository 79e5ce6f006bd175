"""Pair-map sharding on several GPUs against one GPU: is a row-sharded
``cli.train`` the one-process run of the same global batches?

    python3 pair_shard_check.py [--cards 4] [--log_dir DIR] [-- EXTRA CLI.TRAIN FLAGS]

On ``data_parallel_check.py``'s dataset (16 synthetic complexes of bucket
128x128, so 32 rows a shard at P = 4, past the dilation-8 halo), at the
flagship width, one epoch under ``--deterministic`` at dropout 0.1, with
the global batch 2 everywhere, six ``cli.train`` runs:

* ``p1``: one process, ``--batch_size 2``;
* ``p1_moved``: the same from the seeded weights moved by 1e-7 relative
  (the one-process run's float32 sensitivity);
* ``p4``: ``--num_devices 1 --num_pair_shards 4 --batch_size 2`` (each
  map's rows over four ranks, halos and statistics in the step graphs);
* ``d2p2`` and ``d2p2_again``: ``--num_devices 2 --num_pair_shards 2``
  (a 2 x 2 grid, one complex per data index);
* ``d2p2_eager``: the 2 x 2 grid joined with ``--coordinator_address`` and
  the step graphs off.

Prints each run's per-step losses and grad norms and wall, then one JSON
line: the largest difference of each sharded run's last/ state (weights,
AdamW moments, batch-norm statistics) from ``p1``'s beside ``p1`` against
``p1_moved``, ``d2p2`` against ``d2p2_again`` (repeatability) and against
``d2p2_eager`` (captured against eager collectives); then the cards' names
and power limits. Exits 1 when a run fails or its ranks disagree on a
step. Each run's output goes to ``DIR/<run>.log``. With ``-- --device cpu``
and small-model flags it rehearses on the CPU over gloo.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from data_parallel_check import WRAP, run, write_dataset  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cards", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log_dir", default=None)
    args, extra = parser.parse_known_args(argv)
    extra = [a for a in extra if a != "--"]
    on_cpu = "--device" in extra and extra[extra.index("--device") + 1] == "cpu"
    import torch

    if args.cards != 4:
        print("pair_shard_check: the grids need --cards 4", file=sys.stderr)
        return 1
    if not on_cpu and torch.cuda.device_count() < args.cards:
        print(f"pair_shard_check: {args.cards} CUDA devices needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deepinteract_tpu_torch.training.checkpoint import CheckpointConfig, Checkpointer

    if not on_cpu:
        cs.build_kernels()
    work = tempfile.mkdtemp(prefix="pair_shard_check_")
    log_dir = args.log_dir or work
    os.makedirs(log_dir, exist_ok=True)
    root = os.path.join(work, "data")
    write_dataset(root, args.seed)

    def flags(name, *more):
        return ["--dips_root", root, "--num_epochs", "1", "--seed", str(args.seed),
                "--log_every", "1", "--dropout_rate", "0.1", "--steps_per_dispatch", "1",
                "--eval_batches_per_dispatch", "4", "--deterministic", "--ckpt_dir",
                os.path.join(work, name), "--test_csv", os.path.join(work, f"{name}.csv"),
                *extra, *more]

    store = os.path.join(work, "rendezvous")
    grid = ("--num_devices", "2", "--num_pair_shards", "2")
    runs = {
        "p1": run("p1", [["-c", WRAP, "graphed", *flags("p1", "--batch_size", "2")]], log_dir),
        "p1_moved": run("p1_moved", [["-c", WRAP, "moved", *flags(
            "p1_moved", "--batch_size", "2")]], log_dir),
        "p4": run("p4", [["-c", WRAP, "graphed", *flags(
            "p4", "--batch_size", "2", "--num_devices", "1", "--num_pair_shards", "4")]],
            log_dir),
        "d2p2": run("d2p2", [["-c", WRAP, "graphed", *flags("d2p2", *grid)]], log_dir),
        "d2p2_again": run("d2p2_again", [["-c", WRAP, "graphed", *flags(
            "d2p2_again", *grid)]], log_dir),
        "d2p2_eager": run("d2p2_eager", [["-c", WRAP, "eager", *flags(
            "d2p2_eager", *grid, "--coordinator_address", f"file://{store}",
            "--num_processes", "4", "--process_id", str(r))] for r in range(4)], log_dir),
    }
    if any(any(r["rcs"]) or not r["agree"] for r in runs.values()):
        print("pair_shard_check: a run failed or its ranks disagreed", flush=True)
        return 1
    finals = {n: Checkpointer(CheckpointConfig(directory=os.path.join(work, n))).restore(
        None, which="last") for n in runs}
    diff = {"p4_vs_p1": cs._tree_diff(finals["p4"], finals["p1"]),
            "d2p2_vs_p1": cs._tree_diff(finals["d2p2"], finals["p1"]),
            "p1_vs_p1_moved": cs._tree_diff(finals["p1"], finals["p1_moved"]),
            "d2p2_vs_d2p2_again": cs._tree_diff(finals["d2p2"], finals["d2p2_again"]),
            "d2p2_vs_d2p2_eager": cs._tree_diff(finals["d2p2"], finals["d2p2_eager"])}
    print(json.dumps({"max_state_diff": diff,
                      "d2p2_repeatable_bitwise": diff["d2p2_vs_d2p2_again"] == 0.0,
                      "walls_s": {n: r["wall_s"] for n, r in runs.items()},
                      "steps": {n: r["steps"] for n, r in runs.items()}}), flush=True)
    if not on_cpu:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
