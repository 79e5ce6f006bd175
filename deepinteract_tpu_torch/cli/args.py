"""Flags of the port's CLIs, with the JAX package's names and defaults
(``deepinteract_tpu/cli/args.py``), and the configs they build."""

from __future__ import annotations

import argparse

from deepinteract_tpu_torch.models.decoder import DecoderConfig
from deepinteract_tpu_torch.models.geometric_transformer import GTConfig
from deepinteract_tpu_torch.models.model import ModelConfig
from deepinteract_tpu_torch.training.loop import LoopConfig
from deepinteract_tpu_torch.training.optim import OptimConfig


def add_model_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("model")
    g.add_argument("--num_gnn_layers", type=int, default=2)
    g.add_argument("--num_gnn_hidden_channels", type=int, default=128)
    g.add_argument("--num_gnn_attention_heads", type=int, default=4)
    g.add_argument("--num_interact_layers", type=int, default=14,
                   help="decoder ResNet chunks")
    g.add_argument("--num_interact_hidden_channels", type=int, default=128)
    g.add_argument("--compute_dtype", choices=("float32", "bfloat16"), default=None,
                   help="activation/matmul dtype of the encoder and decoder; "
                        "params, norm statistics, softmax accumulators and "
                        "logits stay float32 (default float32)")
    g.add_argument("--interaction_stem", choices=("factorized", "materialized"),
                   default=None,
                   help="'factorized' computes the decoder's first layer from "
                        "per-chain features; 'materialized' builds the "
                        "[L1, L2, 2C] tensor (same params; default factorized)")
    g.add_argument("--attention_mode", choices=("scatter", "gather"), default="scatter",
                   help="scatter = reference-exact edge softmax; gather = "
                        "out-edge approximation")
    g.add_argument("--norm_type", choices=("batch", "layer"), default="batch")
    g.add_argument("--dropout_rate", type=float, default=0.2)


def add_data_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("data")
    g.add_argument("--dips_root", type=str, default=None,
                   help="DIPS-Plus npz root (with processed/ and split files)")
    g.add_argument("--db5_root", type=str, default=None)
    g.add_argument("--casp_capri_root", type=str, default=None)
    g.add_argument("--train_with_db5", action="store_true",
                   help="train/val on DB5-Plus instead of DIPS-Plus")
    g.add_argument("--test_with_casp_capri", action="store_true")
    g.add_argument("--percent_to_use", type=float, default=1.0)
    g.add_argument("--split_ver", type=str, default=None)
    g.add_argument("--input_indep", action="store_true",
                   help="zero all input features (the reference's control)")
    g.add_argument("--batch_size", type=int, default=1)
    g.add_argument("--pad_to_max_bucket", action="store_true",
                   help="pad every chain to at least the top bucket")
    g.add_argument("--diagonal_buckets", action="store_true",
                   help="pad both chains of a pair to the larger chain's bucket")


def add_training_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("training")
    g.add_argument("--lr", type=float, default=1e-3)
    g.add_argument("--weight_decay", type=float, default=1e-2)
    g.add_argument("--grad_clip_norm", type=float, default=0.5)
    g.add_argument("--num_epochs", type=int, default=50)
    g.add_argument("--accumulate_grad_batches", type=int, default=1)
    g.add_argument("--patience", type=int, default=5)
    g.add_argument("--min_delta", type=float, default=5e-6)
    g.add_argument("--weight_classes", action="store_true",
                   help="1:5 positive class weighting")
    g.add_argument("--log_every", type=int, default=100)


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    add_model_args(p)
    p.add_argument("--seed", type=int, default=42,
                   help="seed of the init (when no --weights are given) and of "
                        "training's shuffle and dropout")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch ops on the CPU)")
    return p


def model_config_from_args(args: argparse.Namespace) -> ModelConfig:
    gnn = GTConfig(
        num_layers=args.num_gnn_layers,
        hidden=args.num_gnn_hidden_channels,
        num_heads=args.num_gnn_attention_heads,
        dropout_rate=args.dropout_rate,
        attention_mode=args.attention_mode,
        norm_type=args.norm_type,
    )
    decoder = DecoderConfig(num_chunks=args.num_interact_layers,
                            num_channels=args.num_interact_hidden_channels)
    return ModelConfig(gnn=gnn, decoder=decoder,
                       interaction_stem=args.interaction_stem or "factorized",
                       compute_dtype=args.compute_dtype or "float32")


def optim_config_from_args(args: argparse.Namespace) -> OptimConfig:
    return OptimConfig(lr=args.lr, weight_decay=args.weight_decay,
                       grad_clip_norm=args.grad_clip_norm, num_epochs=args.num_epochs,
                       accumulate_steps=args.accumulate_grad_batches)


def loop_config_from_args(args: argparse.Namespace) -> LoopConfig:
    return LoopConfig(num_epochs=args.num_epochs, patience=args.patience,
                      min_delta=args.min_delta, seed=args.seed,
                      weight_classes=args.weight_classes, log_every=args.log_every)
