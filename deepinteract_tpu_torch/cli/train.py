"""Train CLI: data module -> model -> trainer with early stopping -> fit ->
test metrics.

Port of ``deepinteract_tpu/cli/train.py`` (single device; no checkpoints
yet). Runs on the GPU unless ``--device cpu`` is given; without a GPU and
without ``--device cpu`` it refuses.

    python -m deepinteract_tpu_torch.cli.train --dips_root D [--num_epochs N] \\
        [--batch_size B] [--lr --weight_decay --grad_clip_norm --dropout_rate] \\
        [--weight_classes] [--accumulate_grad_batches K] [--patience P] \\
        [--test_csv PATH] [--device cpu]

The last line of its output is the test split's metrics as a dict.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from deepinteract_tpu_torch.cli.args import (add_data_args, add_training_args, build_parser,
                                             loop_config_from_args, model_config_from_args,
                                             optim_config_from_args)
from deepinteract_tpu_torch.data.datasets import PICPDataModule
from deepinteract_tpu_torch.data.loader import BucketedLoader
from deepinteract_tpu_torch.device import resolve_device
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.models.policy import set_backend_precision
from deepinteract_tpu_torch.training.loop import Trainer
from deepinteract_tpu_torch.weights import init_weights


def parse_args(argv=None) -> argparse.Namespace:
    parser = build_parser(__doc__)
    add_data_args(parser)
    add_training_args(parser)
    parser.add_argument("--test_csv", type=str, default=None,
                        help="write the test split's per-target top-k metrics here")
    return parser.parse_args(argv)


def run(args: argparse.Namespace):
    """Train as ``args`` say and evaluate the test split. Returns (history,
    test metrics)."""
    device = resolve_device(args.device)

    model_cfg = model_config_from_args(args)
    dm = PICPDataModule(dips_root=args.dips_root, db5_root=args.db5_root,
                        casp_capri_root=args.casp_capri_root,
                        train_with_db5=args.train_with_db5,
                        test_with_casp_capri=args.test_with_casp_capri,
                        percent_to_use=args.percent_to_use, input_indep=args.input_indep,
                        split_ver=args.split_ver, seed=args.seed)
    train_loader = BucketedLoader(dm.train, batch_size=args.batch_size, shuffle=True,
                                  drop_remainder=True, seed=args.seed,
                                  pad_to_max_bucket=args.pad_to_max_bucket,
                                  diagonal_buckets=args.diagonal_buckets)
    val_loader, test_loader = BucketedLoader(dm.val), BucketedLoader(dm.test)
    # The cosine-restart schedule counts steps of this loader's epochs.
    optim_cfg = dataclasses.replace(optim_config_from_args(args),
                                    steps_per_epoch=max(train_loader.num_batches(), 1))

    set_backend_precision(model_cfg.gnn.compute_dtype)
    model = DeepInteract(model_cfg)
    init_weights(model, args.seed)
    trainer = Trainer(model.to(device), loop_config_from_args(args), optim_cfg)
    state, history = trainer.fit(trainer.init_state(), train_loader, val_data=val_loader)
    test_metrics = trainer.evaluate(state, test_loader, stage="test",
                                    targets=test_loader.targets(), csv_path=args.test_csv)
    return history, test_metrics


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as err:
        print(f"train: {err}", file=sys.stderr)
        return 2
    _, test_metrics = run(args)
    print({k: round(v, 4) for k, v in test_metrics.items()})
    return 0

if __name__ == "__main__":
    sys.exit(main())
