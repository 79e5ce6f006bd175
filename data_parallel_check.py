"""Data-parallel training on several GPUs against one GPU: is a W-rank
``cli.train`` the one-process run of the same global batches?

    python3 data_parallel_check.py [--cards 4] [--log_dir DIR] [-- EXTRA CLI.TRAIN FLAGS]

On 16 synthetic complexes of bucket 128x128 (W global steps of W complexes
each at ``--cards 4``; phase 12's val and test complexes of ``chip_smoke.py``),
at the flagship width, one epoch under ``--deterministic`` at dropout 0.1,
five ``cli.train`` runs:

* ``w1``: one process, ``--batch_size W``;
* ``w1_moved``: the same from the seeded weights moved by 1e-7 relative
  (the one-process run's float32 sensitivity);
* ``wW`` and ``wW_again``: ``--num_devices W`` (NCCL, one rank per card,
  the all-reduces captured in the train-step graphs);
* ``wW_eager``: W ranks joined with ``--coordinator_address`` and the step
  graphs off.

Prints each run's per-step losses and grad norms (as every rank logs
them) and wall, then one JSON line: the largest difference between last/
states (weights, AdamW moments, batch-norm statistics) of ``wW`` and
``wW_eager`` (captured against eager collectives), ``wW`` and ``wW_again``
(repeatability), ``wW`` and ``w1``, and ``w1`` and ``w1_moved``; then the
cards' names and power limits. Exits 1 when a run fails, when ranks
disagree on a step, or when ``wW`` differs from ``wW_eager`` or
``wW_again``. Each run's output goes to ``DIR/<run>.log``. With ``--
--device cpu`` and small-model flags it rehearses on the CPU over gloo.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# The rank's command: cli.train, with the step graphs off ("eager") or the
# seeded weights moved by 1e-7 relative ("moved").
WRAP = r"""
import dataclasses, sys, torch
from deepinteract_tpu_torch.cli import train as t
mode, argv = sys.argv[1], sys.argv[2:]
if mode == "eager":
    real = t.loop_config_from_args
    t.loop_config_from_args = lambda a: dataclasses.replace(real(a), step_graphs=False)
if mode == "moved":
    real_init = t.init_weights
    def init(model, seed):
        real_init(model, seed)
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=g))
    t.init_weights = init
sys.exit(t.main(argv))
"""
# Ranks share one output stream, so lines may run together: match numbers only.
STEP = re.compile(r"epoch 0 step (\d+): loss=(nan|inf|[0-9.]+) grad_norm=(nan|inf|[0-9.]+)")
RUN_LIMIT_S = 420


def write_dataset(root: str, seed: int) -> None:
    import chip_smoke as cs

    train = tuple((100 + i, 80 + 2 * i) for i in range(16))
    sizes = train + cs.DISPATCH_VAL + cs.DISPATCH_TEST
    cs.write_tiny_npz_dataset(root, sizes=sizes, seed=seed, knn=cs.constants.KNN,
                              geo_nbrhd_size=cs.constants.GEO_NBRHD_SIZE)
    names = [f"c{i}.npz" for i in range(len(sizes))]
    for split, sel in (("train", names[:16]), ("val", names[16:20]), ("test", names[20:])):
        with open(os.path.join(root, f"pairs-postprocessed-{split}.txt"), "w") as f:
            f.write("\n".join(sel) + "\n")


def run(name: str, cmds, log_dir: str) -> dict:
    """Start every command (one per rank), wait for all, and read the step
    lines: a step whose ranks logged different values is a failure."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(["timeout", "-k", "10", str(RUN_LIMIT_S), sys.executable, *c],
                              cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    texts = [p.communicate()[0] for p in procs]
    wall = time.perf_counter() - t0
    with open(os.path.join(log_dir, f"{name}.log"), "w") as f:
        f.write("\n".join(texts))
    rcs = [p.returncode for p in procs]
    steps = {}
    for s, loss, norm in STEP.findall("\n".join(texts)):
        steps.setdefault(int(s), set()).add((loss, norm))
    agree = all(len(v) == 1 for v in steps.values())
    steps = {s: sorted(v)[0] for s, v in sorted(steps.items())}
    print(f"{name}: exit codes {rcs}, wall {wall:.3f} s, ranks agree {agree}, steps "
          f"{[(s, *v) for s, v in steps.items()]}", flush=True)
    if any(rcs):
        print("\n".join(texts)[-4000:], flush=True)
    return {"rcs": rcs, "wall_s": wall, "agree": agree, "steps": steps}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cards", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log_dir", default=None)
    args, extra = parser.parse_known_args(argv)
    extra = [a for a in extra if a != "--"]
    on_cpu = "--device" in extra and extra[extra.index("--device") + 1] == "cpu"
    import torch

    if not on_cpu and torch.cuda.device_count() < args.cards:
        print(f"data_parallel_check: {args.cards} CUDA devices needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deepinteract_tpu_torch.training.checkpoint import CheckpointConfig, Checkpointer

    if not on_cpu:
        cs.build_kernels()
    work = tempfile.mkdtemp(prefix="data_parallel_check_")
    log_dir = args.log_dir or work
    os.makedirs(log_dir, exist_ok=True)
    root = os.path.join(work, "data")
    write_dataset(root, args.seed)
    w = args.cards

    def flags(name, *more):
        return ["--dips_root", root, "--num_epochs", "1", "--seed", str(args.seed),
                "--log_every", "1", "--dropout_rate", "0.1", "--steps_per_dispatch", "1",
                "--eval_batches_per_dispatch", "4", "--deterministic", "--ckpt_dir",
                os.path.join(work, name), "--test_csv", os.path.join(work, f"{name}.csv"),
                *extra, *more]

    store = os.path.join(work, "rendezvous")
    runs = {
        "w1": run("w1", [["-c", WRAP, "graphed", *flags("w1", "--batch_size", str(w))]],
                  log_dir),
        "w1_moved": run("w1_moved", [["-c", WRAP, "moved", *flags(
            "w1_moved", "--batch_size", str(w))]], log_dir),
        f"w{w}": run(f"w{w}", [["-c", WRAP, "graphed", *flags(
            f"w{w}", "--num_devices", str(w))]], log_dir),
        f"w{w}_again": run(f"w{w}_again", [["-c", WRAP, "graphed", *flags(
            f"w{w}_again", "--num_devices", str(w))]], log_dir),
        f"w{w}_eager": run(f"w{w}_eager", [["-c", WRAP, "eager", *flags(
            f"w{w}_eager", "--coordinator_address", f"file://{store}", "--num_processes",
            str(w), "--process_id", str(r))] for r in range(w)], log_dir),
    }
    if any(any(r["rcs"]) or not r["agree"] for r in runs.values()):
        print("data_parallel_check: a run failed or its ranks disagreed", flush=True)
        return 1
    finals = {n: Checkpointer(CheckpointConfig(directory=os.path.join(work, n))).restore(
        None, which="last") for n in runs}
    diff = {f"w{w}_vs_w{w}_eager": cs._tree_diff(finals[f"w{w}"], finals[f"w{w}_eager"]),
            f"w{w}_vs_w{w}_again": cs._tree_diff(finals[f"w{w}"], finals[f"w{w}_again"]),
            f"w{w}_vs_w1": cs._tree_diff(finals[f"w{w}"], finals["w1"]),
            "w1_vs_w1_moved": cs._tree_diff(finals["w1"], finals["w1_moved"])}
    print(json.dumps({"max_state_diff": diff,
                      "walls_s": {n: r["wall_s"] for n, r in runs.items()},
                      "steps": {n: r["steps"] for n, r in runs.items()}}), flush=True)
    if not on_cpu:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    same = diff[f"w{w}_vs_w{w}_eager"] == 0.0 and diff[f"w{w}_vs_w{w}_again"] == 0.0
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
