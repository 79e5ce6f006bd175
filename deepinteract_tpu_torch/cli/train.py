"""Train CLI: data module -> model -> trainer with early stopping and
checkpoints -> fit -> test metrics.

Port of ``deepinteract_tpu/cli/train.py`` on one device. Runs on the GPU
unless ``--device cpu`` is given; without a GPU and without ``--device
cpu`` it refuses.

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
        [--supervise [--hang_timeout_s T] ...] [--device cpu]

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
import dataclasses
import json
import os
import sys
from itertools import islice

import torch

from deepinteract_tpu_torch.cli.args import (add_data_args, add_logging_args,
                                             add_training_args, build_parser,
                                             loop_config_from_args, make_metric_writer,
                                             model_config_from_args, optim_config_from_args)
from deepinteract_tpu_torch.data.datasets import PICPDataModule
from deepinteract_tpu_torch.data.loader import BucketedLoader, make_bucket_fn
from deepinteract_tpu_torch.data.packed import PackedDataset, pack_dataset
from deepinteract_tpu_torch.device import resolve_device
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.models.policy import set_backend_precision
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
    args = parser.parse_args(argv)
    if args.fine_tune and not args.ckpt_name:
        parser.error("--fine_tune needs --ckpt_name (the checkpoint to warm-start from)")
    return args


def run(args: argparse.Namespace):
    """Train as ``args`` say and evaluate the test split. Returns (history,
    test metrics); a preemption raises ``TrainingPreempted`` once the
    newest checkpoint is flushed. ``--deterministic`` holds for this call
    only."""
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


def _run(args: argparse.Namespace):
    device = resolve_device(args.device)

    model_cfg = model_config_from_args(args)
    dm = PICPDataModule(dips_root=args.dips_root, db5_root=args.db5_root,
                        casp_capri_root=args.casp_capri_root,
                        train_with_db5=args.train_with_db5,
                        test_with_casp_capri=args.test_with_casp_capri,
                        percent_to_use=args.percent_to_use, input_indep=args.input_indep,
                        split_ver=args.split_ver, seed=args.seed)
    train_ds, val_ds, test_ds = dm.train, dm.val, dm.test
    if args.packed_cache_dir:
        train_ds, val_ds, test_ds = packed_splits(args, train_ds, val_ds, test_ds)
    train_loader = BucketedLoader(train_ds, batch_size=args.batch_size, shuffle=True,
                                  drop_remainder=True, seed=args.seed,
                                  pad_to_max_bucket=args.pad_to_max_bucket,
                                  diagonal_buckets=args.diagonal_buckets,
                                  skip_budget=args.data_skip_budget,
                                  dispatch_run=max(1, args.steps_per_dispatch))
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
                               seed=args.seed, weight_classes=args.weight_classes)
        print(f"lr_find suggestion: {suggested:.2e} (was {optim_cfg.lr:.2e})")
        optim_cfg = dataclasses.replace(optim_cfg, lr=suggested)
    trainer = Trainer(model, loop_config_from_args(args), optim_cfg,
                      metric_writer=make_metric_writer(args))
    state = trainer.init_state(fine_tune_from=args.ckpt_name if args.fine_tune else None)
    state, history = trainer.fit(state, train_loader, val_data=val_loader, resume=args.resume)
    writer = trainer.metric_writer
    if writer is not None and args.ckpt_dir and hasattr(writer, "log_checkpoint_artifact"):
        try:
            writer.log_checkpoint_artifact(args.ckpt_dir)
        except Exception as exc:  # an artifact upload must not fail the run
            print(f"checkpoint artifact upload failed: {exc}")
    test_metrics = trainer.evaluate(state, test_loader, stage="test",
                                    targets=test_loader.targets(), csv_path=args.test_csv)
    return history, test_metrics


def packed_splits(args: argparse.Namespace, train_ds, val_ds, test_ds):
    """The three splits as pre-padded packs under ``--packed_cache_dir``
    (``train/``, ``val/``, ``test/``), each written on the first run and
    reused while its signature, item count and lengths match. The
    signatures are the JAX CLI's, so a pack that either package wrote is
    the other's too."""
    train_sig = (f"pad_max={args.pad_to_max_bucket},diag={args.diagonal_buckets},"
                 f"indep={args.input_indep}")
    eval_sig = f"eval,indep={args.input_indep}"
    specs = (("train", train_ds, make_bucket_fn(args.pad_to_max_bucket,
                                                args.diagonal_buckets), train_sig),
             ("val", val_ds, make_bucket_fn(), eval_sig),
             ("test", test_ds, make_bucket_fn(), eval_sig))
    packs = []
    for split, ds, bucket_fn, sig in specs:
        pack_dir = os.path.join(args.packed_cache_dir, split)
        pack_dataset(ds, pack_dir, bucket_fn, signature=sig)
        packs.append(PackedDataset(pack_dir))
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
        SuperviseConfig(heartbeat_path=os.path.join(args.ckpt_dir, "obs", "heartbeat_p0.json"),
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
        # The parent stays a plain control plane: the child owns the device.
        return _supervise_main(args, sys.argv[1:] if argv is None else argv)
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
    print({k: round(v, 4) for k, v in test_metrics.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
