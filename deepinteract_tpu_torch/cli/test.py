"""Test CLI: restore a checkpoint's best/ step, run the held-out test split
with the test-time metric conventions (L = min(n1, n2)), write the
per-target top-k CSV and print the median metrics.

Port of ``deepinteract_tpu/cli/test.py`` for the port's own checkpoints
(``training/checkpoint.py``). Runs on the GPU unless ``--device cpu`` is
given; without a GPU and without ``--device cpu`` it refuses.

    python -m deepinteract_tpu_torch.cli.test --dips_root D --ckpt_name DIR \\
        [--csv_out PATH] [--eval_batch_size B] [--device cpu] [model flags] \\
        [--num_devices D] [--num_pair_shards P] [--shard_pair_map]

``--num_pair_shards P`` evaluates each complex's pair map split by rows
over P processes, one per device (``cli.train``'s launcher: rank 0 here,
the rest started as copies of this command line); ``--num_devices D``
replicates the evaluation over D data ranks, as training's evaluation is
replicated. Rank 0 alone writes the CSV and prints the metrics.

A reference (Lightning/torch) ``.ckpt`` or ``.pt`` is refused: reading one
needs the checkpoint importer, which the port does not have yet.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional

from deepinteract_tpu_torch.cli.args import (add_data_args, add_distributed_args,
                                             add_training_args, build_parser,
                                             loop_config_from_args, model_config_from_args)
from deepinteract_tpu_torch.cli.import_checkpoint import (imported_model,
                                                          load_reference_checkpoint)
from deepinteract_tpu_torch.data.datasets import PICPDataModule
from deepinteract_tpu_torch.data.loader import BucketedLoader
from deepinteract_tpu_torch.device import resolve_device
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.models.policy import set_backend_precision
from deepinteract_tpu_torch.training.checkpoint import CheckpointConfig, Checkpointer
from deepinteract_tpu_torch.training.loop import Trainer

def reference_checkpoint(path: str) -> Optional[str]:
    """The reference checkpoint at or inside ``path`` (a ``.ckpt``/``.pt``
    file, or a directory holding ``model.ckpt``/``model.pt``), else None."""
    if os.path.isfile(path) and path.endswith((".ckpt", ".pt")):
        return path
    if os.path.isdir(path):
        for name in ("model.ckpt", "model.pt"):
            if os.path.isfile(os.path.join(path, name)):
                return os.path.join(path, name)
    return None


def csv_path_of(args: argparse.Namespace) -> str:
    """``--csv_out``, else the reference's name for the test set."""
    if args.csv_out:
        return args.csv_out
    if args.test_with_casp_capri:
        return "casp_capri_top_metrics.csv"
    if args.train_with_db5:
        return "db5_plus_test_top_metrics.csv"
    return "dips_plus_test_top_metrics.csv"


def parse_args(argv=None) -> argparse.Namespace:
    parser = build_parser(__doc__)
    add_data_args(parser)
    add_training_args(parser)
    parser.add_argument("--csv_out", type=str, default=None,
                        help="per-target CSV path (default: the reference's name for "
                             "the test set)")
    parser.add_argument("--unsafe-load", action="store_true",
                        help="allow a full (code-executing) pickle load of a reference "
                             "checkpoint the safe weights_only path rejects; trusted files only")
    add_distributed_args(parser)
    args = parser.parse_args(argv)
    # The command line, for the ranks --num_devices / --num_pair_shards start.
    args.argv = list(sys.argv[1:] if argv is None else argv)
    return args


def run(args: argparse.Namespace) -> Dict[str, float]:
    """The test split's metrics under the checkpoint's best/ weights (over
    the run's grid, when it has one: ``cli.train.data_parallel_run``)."""
    from deepinteract_tpu_torch.cli.train import data_parallel_run

    with data_parallel_run(args, "deepinteract_tpu_torch.cli.test") as mesh:
        return _test(args, mesh)


def _test(args: argparse.Namespace, mesh) -> Dict[str, float]:
    device = resolve_device(args.device) if mesh is None else mesh.device
    primary = mesh is None or mesh.rank == 0
    ckpt_dir = args.ckpt_name or args.ckpt_dir
    if not os.path.exists(ckpt_dir):
        raise SystemExit(f"test: no checkpoint at {ckpt_dir!r}")
    model_cfg = model_config_from_args(args)
    dm = PICPDataModule(dips_root=args.dips_root, db5_root=args.db5_root,
                        casp_capri_root=args.casp_capri_root,
                        train_with_db5=args.train_with_db5,
                        test_with_casp_capri=args.test_with_casp_capri,
                        input_indep=args.input_indep, split_ver=args.split_ver, seed=args.seed)
    test_loader = BucketedLoader(dm.test, batch_size=args.eval_batch_size)
    set_backend_precision(model_cfg.gnn.compute_dtype)
    ref = reference_checkpoint(ckpt_dir)
    if ref is None:
        model = DeepInteract(model_cfg)
    else:
        sd, _ = load_reference_checkpoint(ref, args.unsafe_load)
        model = imported_model(sd, model_cfg,
                               log=lambda s: print(f"imported reference checkpoint {ref}: {s}"))
    trainer = Trainer(model.to(device), loop_config_from_args(args), mesh=mesh)
    state = trainer.init_state()
    if ref is None:
        Checkpointer(CheckpointConfig(directory=ckpt_dir, metric_to_track=args.metric_to_track)
                     ).restore(state, which="best", partial=True)
    return trainer.evaluate(state, test_loader, stage="test", targets=test_loader.targets(),
                            csv_path=csv_path_of(args) if primary else None)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as err:
        print(f"test: {err}", file=sys.stderr)
        return 2
    metrics = run(args)
    if args.process_id:  # a started rank: rank 0 reports
        return 0
    for key in sorted(metrics):
        print(f"{key}: {metrics[key]:.6f}")
    print(f"wrote {csv_path_of(args)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
