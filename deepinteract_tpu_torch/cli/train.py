"""Train CLI: data module -> model -> trainer with early stopping and
checkpoints -> fit -> test metrics.

Port of ``deepinteract_tpu/cli/train.py``. Runs on the GPU unless
``--device cpu`` is given; without a GPU and without ``--device cpu`` it
refuses.

    python -m deepinteract_tpu_torch.cli.train --dips_root D [--num_epochs N] \\
        [--batch_size B] [--lr --weight_decay --grad_clip_norm --dropout_rate] \\
        [--weight_classes] [--accumulate_grad_batches K] [--patience P] \\
        [--ckpt_dir DIR] [--resume] [--save_every_steps N] [--sync_checkpoint] \\
        [--fine_tune --ckpt_name SRC] [--stochastic_weight_avg] [--find_lr] \\
        [--max_hours H] [--data_skip_budget S] [--test_csv PATH] [--remat \\
        [--remat_policy full|convs]] [--heartbeat_seconds S] [--deterministic] \\
        [--steps_per_dispatch K] [--eval_batches_per_dispatch K] [--device_prefetch] \\
        [--packed_cache_dir DIR] [--profile_dir DIR [--profile_steps N]] [--no_span_log] \\
        [--viz_every_n_epochs N] [--tb_log_dir DIR] [--use_wandb [--offline] ...] \\
        [--supervise [--hang_timeout_s T] ...] [--device cpu] \\
        [--num_devices N] [--num_pair_shards P] [--shard_pair_map] \\
        [--coordinator_address A --num_processes W --process_id R]

Sharded, one process per device (``parallel/``): ``--num_devices D``
(data parallel) and ``--num_pair_shards P`` (pair-map sharding: each
complex's map split by rows over P processes) make a D x P grid; rank 0
runs in this process and starts ranks 1..D*P-1 as copies of this command
line, one per device, meeting at a FileStore in ``--ckpt_dir``.
``--shard_pair_map`` with P = 1 runs the sharded path over a group of
one. ``--coordinator_address host:port`` (or ``file://PATH``) with
``--num_processes`` and ``--process_id`` joins one rank of a group
started elsewhere. NCCL on the GPU, gloo with ``--device cpu``. Each step
is the single-process step on the global batch of ``batch_size * D``
complexes; rank 0 alone writes checkpoints, logs, the test CSV and the
final metrics line, and with D > 1 every rank prints ``host r/D: n
coordinated global steps/epoch``. A grid of more processes than devices
(``needs N devices``), a topology that does not come up and a model that
cannot be row-sharded (DeepLab; rows that P does not split into shards
at least as wide as the decoder's halo) raise.

The train loader shuffles runs of ``--steps_per_dispatch`` same-bucket
batches (the JAX CLI's epoch order), and each full run is one dispatch of
the trainer. ``--packed_cache_dir`` packs each split once (the JAX
package's pack signatures, so either package reuses the other's pack) and
reads batches from the packs. ``--device_prefetch`` places each run on the
placement thread (pinned memory, a side CUDA stream). Checkpoints go to
``--ckpt_dir`` (``best/``, ``last/``, ``mid/``), the phase spans to
``<ckpt_dir>/obs/events.jsonl`` (unless ``--no_span_log``), epoch scalars
to ``--tb_log_dir`` and W&B (``--use_wandb``). A
preempted run (SIGTERM, SIGINT) flushes its newest checkpoint, prints
"training preempted (...)" and exits 0; rerun it with ``--resume``. The
last line of a finished run's output is the test split's metrics as a
dict.

``--supervise`` runs the same command line (without the supervisor's
flags) as a watched child (``training/supervisor.py``): a crash or a hang
restarts it into ``--resume``, a crash loop opens a circuit breaker, and
the last stdout line is the ``train_supervise/v1`` record.

The test split's per-target top-k CSV goes to ``test_top_metrics.csv``
in the working directory, as the JAX CLI writes it (``--test_csv``
elsewhere). On the card each train step and each eval batch of a bucket
key replays that key's CUDA graph (``training/step_graphs.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
from itertools import islice

import torch

from deepinteract_tpu_torch.cli.args import (add_data_args, add_distributed_args,
                                             add_logging_args, add_training_args, build_parser,
                                             loop_config_from_args, make_metric_writer,
                                             model_config_from_args, optim_config_from_args)
from deepinteract_tpu_torch.data.datasets import PICPDataModule
from deepinteract_tpu_torch.data.loader import BucketedLoader, make_bucket_fn
from deepinteract_tpu_torch.data.packed import PackedDataset, pack_dataset
from deepinteract_tpu_torch.device import resolve_device
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.models.policy import set_backend_precision
from deepinteract_tpu_torch.parallel import multihost
from deepinteract_tpu_torch.parallel.launch import rank_group
from deepinteract_tpu_torch.parallel.mesh import make_mesh
from deepinteract_tpu_torch.robustness.preemption import TrainingPreempted
from deepinteract_tpu_torch.training.loop import Trainer
from deepinteract_tpu_torch.training.lr_finder import lr_find
from deepinteract_tpu_torch.weights import init_weights


def parse_args(argv=None) -> argparse.Namespace:
    parser = build_parser(__doc__)
    add_data_args(parser)
    add_training_args(parser)
    add_logging_args(parser)
    parser.add_argument("--test_csv", type=str, default="test_top_metrics.csv",
                        help="the test split's per-target top-k metrics (default: "
                             "test_top_metrics.csv in the working directory, as the "
                             "JAX CLI writes it)")
    add_distributed_args(parser)
    args = parser.parse_args(argv)
    if args.fine_tune and not args.ckpt_name:
        parser.error("--fine_tune needs --ckpt_name (the checkpoint to warm-start from)")
    # The command line, for the ranks --num_devices starts.
    args.argv = list(sys.argv[1:] if argv is None else argv)
    return args


def run(args: argparse.Namespace):
    """Train as ``args`` say and evaluate the test split. Returns (history,
    test metrics); a preemption raises ``TrainingPreempted`` once the
    newest checkpoint is flushed. ``--deterministic`` holds for this call
    only. A data-parallel run's group lives for this call: it is
    destroyed (after a barrier, or at once on an error) before it
    returns."""
    if not args.deterministic:
        return _run(args)
    # cuBLAS reads the workspace setting when its first handle is made.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    previous = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _run(args)
    finally:
        torch.use_deterministic_algorithms(previous)


def is_primary(args: argparse.Namespace) -> bool:
    """Rank 0 of ``args``' run (or its only process)."""
    return not args.process_id


@contextlib.contextmanager
def data_parallel_run(args: argparse.Namespace, module: str = "deepinteract_tpu_torch.cli.train"):
    """The run's (data, pair) grid (a ``parallel.mesh.DataMesh``, or None
    for one process without pair sharding): joined from the coordinator
    flags, or, with ``--num_devices D`` and/or ``--num_pair_shards P``
    (or ``--shard_pair_map``), rank 0 here and ranks 1..D*P-1 started as
    copies of the command line (``python -m module``), meeting at a
    FileStore in ``--ckpt_dir`` (``parallel.launch.rank_group``). On the
    way out every rank meets at the exit barrier and the group is
    destroyed; the started ranks are waited for, and one that failed
    raises. On an error other than a preemption the group is destroyed
    without the barrier and the started ranks are killed."""
    device = resolve_device(args.device)
    pairs = args.num_pair_shards
    if pairs < 1:
        raise ValueError(f"--num_pair_shards {pairs}: at least 1")
    sharded = args.shard_pair_map or pairs > 1
    coordinated = any(v is not None for v in (args.coordinator_address, args.num_processes,
                                               args.process_id))
    n = max(args.num_devices, 1) * pairs
    if args.num_devices and coordinated and n != args.num_processes:
        raise ValueError(f"--num_devices {args.num_devices} x --num_pair_shards {pairs} and "
                         f"--num_processes {args.num_processes} disagree")
    if not coordinated and args.num_devices <= 0 and not sharded:
        yield None
        return
    coordinator = ((args.coordinator_address, args.num_processes, args.process_id)
                   if coordinated else None)
    grid = lambda: make_mesh(num_pair=pairs, shard_pair_map=sharded)  # noqa: E731
    with rank_group(args.argv, module, n, grid, device, args.ckpt_dir or ".",
                    coordinator=coordinator,
                    label=f"--num_devices {max(args.num_devices, 1)} x --num_pair_shards {pairs}",
                    graceful=(TrainingPreempted,), exit_tag="train-exit") as group:
        yield group.mesh


def _run(args: argparse.Namespace):
    with data_parallel_run(args) as mesh:
        return _train(args, mesh)


def _train(args: argparse.Namespace, mesh):
    device = resolve_device(args.device) if mesh is None else mesh.device
    primary = mesh is None or mesh.rank == 0
    shard = ((mesh.data_rank, mesh.num_data) if mesh is not None and mesh.num_data > 1
             else None)

    model_cfg = model_config_from_args(args)
    dm = PICPDataModule(dips_root=args.dips_root, db5_root=args.db5_root,
                        casp_capri_root=args.casp_capri_root,
                        train_with_db5=args.train_with_db5,
                        test_with_casp_capri=args.test_with_casp_capri,
                        percent_to_use=args.percent_to_use, input_indep=args.input_indep,
                        split_ver=args.split_ver, seed=args.seed)
    train_ds, val_ds, test_ds = dm.train, dm.val, dm.test
    if args.packed_cache_dir:
        train_ds, val_ds, test_ds = packed_splits(args, train_ds, val_ds, test_ds,
                                                  write=primary)
    # Every rank plans the same global batches and loads its own slice;
    # val and test stay whole on every rank (replicated evaluation).
    train_loader = BucketedLoader(train_ds, batch_size=args.batch_size, shuffle=True,
                                  drop_remainder=True, seed=args.seed,
                                  pad_to_max_bucket=args.pad_to_max_bucket,
                                  diagonal_buckets=args.diagonal_buckets,
                                  skip_budget=args.data_skip_budget,
                                  dispatch_run=max(1, args.steps_per_dispatch), shard=shard)
    if shard:
        print(f"host {shard[0]}/{shard[1]}: {train_loader.num_batches()} coordinated global "
              f"steps/epoch, {args.batch_size} local x {shard[1]} hosts per step", flush=True)
    val_loader = BucketedLoader(val_ds, batch_size=args.eval_batch_size)
    test_loader = BucketedLoader(test_ds, batch_size=args.eval_batch_size)
    # The cosine-restart schedule counts steps of this loader's epochs.
    optim_cfg = dataclasses.replace(optim_config_from_args(args),
                                    steps_per_epoch=max(train_loader.num_batches(), 1))

    set_backend_precision(model_cfg.gnn.compute_dtype)
    model = DeepInteract(model_cfg)
    init_weights(model, args.seed)
    model.to(device)
    if args.find_lr:
        suggested, _ = lr_find(model, islice(train_loader.iter_epoch(0), 8), optim_cfg,
                               seed=args.seed, weight_classes=args.weight_classes, mesh=mesh)
        print(f"lr_find suggestion: {suggested:.2e} (was {optim_cfg.lr:.2e})")
        optim_cfg = dataclasses.replace(optim_cfg, lr=suggested)
    trainer = Trainer(model, loop_config_from_args(args), optim_cfg,
                      metric_writer=make_metric_writer(args) if primary else None, mesh=mesh)
    state = trainer.init_state(fine_tune_from=args.ckpt_name if args.fine_tune else None)
    state, history = trainer.fit(state, train_loader, val_data=val_loader, resume=args.resume)
    writer = trainer.metric_writer
    if writer is not None and args.ckpt_dir and hasattr(writer, "log_checkpoint_artifact"):
        try:
            writer.log_checkpoint_artifact(args.ckpt_dir)
        except Exception as exc:  # an artifact upload must not fail the run
            print(f"checkpoint artifact upload failed: {exc}")
    test_metrics = trainer.evaluate(state, test_loader, stage="test",
                                    targets=test_loader.targets(),
                                    csv_path=args.test_csv if primary else None)
    return history, test_metrics


def packed_splits(args: argparse.Namespace, train_ds, val_ds, test_ds, write: bool = True):
    """The three splits as pre-padded packs under ``--packed_cache_dir``
    (``train/``, ``val/``, ``test/``), each written on the first run and
    reused while its signature, item count and lengths match. The
    signatures are the JAX CLI's, so a pack that either package wrote is
    the other's too. Under a group only rank 0 writes (``write``), and every
    rank waits at a barrier before reading."""
    train_sig = (f"pad_max={args.pad_to_max_bucket},diag={args.diagonal_buckets},"
                 f"indep={args.input_indep}")
    eval_sig = f"eval,indep={args.input_indep}"
    specs = (("train", train_ds, make_bucket_fn(args.pad_to_max_bucket,
                                                args.diagonal_buckets), train_sig),
             ("val", val_ds, make_bucket_fn(), eval_sig),
             ("test", test_ds, make_bucket_fn(), eval_sig))
    packs = []
    if write:
        for split, ds, bucket_fn, sig in specs:
            pack_dataset(ds, os.path.join(args.packed_cache_dir, split), bucket_fn,
                         signature=sig)
    multihost.barrier()
    for split, *_ in specs:
        packs.append(PackedDataset(os.path.join(args.packed_cache_dir, split)))
    return packs


def _supervise_main(args: argparse.Namespace, argv) -> int:
    """``--supervise``: run this command line (supervisor flags stripped,
    ``--heartbeat_seconds`` forced on) as a watched child; print the
    ``train_supervise/v1`` record as the last stdout line."""
    from deepinteract_tpu_torch.training.supervisor import (SuperviseConfig,
                                                            TrainingSupervisor,
                                                            strip_supervisor_flags,
                                                            train_child_cmd_fn)

    heartbeat_seconds = args.heartbeat_seconds if args.heartbeat_seconds > 0 else 5.0
    supervisor = TrainingSupervisor(
        train_child_cmd_fn(strip_supervisor_flags(list(argv)), heartbeat_seconds),
        SuperviseConfig(heartbeat_path=os.path.join(args.ckpt_dir, "obs",
                                                    f"heartbeat_p{args.process_id or 0}.json"),
                        state_dir=args.ckpt_dir, heartbeat_seconds=heartbeat_seconds,
                        poll_interval_s=args.watch_interval_s,
                        hang_timeout_s=args.hang_timeout_s, start_grace_s=args.start_grace_s,
                        restart_backoff_s=args.train_restart_backoff_s,
                        circuit_max_restarts=args.train_circuit_max_restarts,
                        circuit_window_s=args.train_circuit_window_s),
        log=lambda line: print(line, flush=True))
    rc = supervisor.run()
    print(json.dumps(supervisor.contract()), flush=True)
    return rc


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.supervise:
        # The parent stays a plain control plane, in front of the group: the
        # child owns the device and the rank.
        return _supervise_main(args, args.argv)
    try:
        resolve_device(args.device)
    except RuntimeError as err:
        print(f"train: {err}", file=sys.stderr)
        return 2
    try:
        _, test_metrics = run(args)
    except TrainingPreempted as exc:
        print(f"training preempted ({exc}); checkpoint state is flushed — rerun with "
              f"--resume to continue", flush=True)
        return 0
    if is_primary(args):
        print({k: round(v, 4) for k, v in test_metrics.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
