"""Model-shape flags of the port's CLIs, with the JAX package's names and
defaults (``deepinteract_tpu/cli/args.py``), and the config they build."""

from __future__ import annotations

import argparse

from deepinteract_tpu_torch.models.decoder import DecoderConfig
from deepinteract_tpu_torch.models.geometric_transformer import GTConfig
from deepinteract_tpu_torch.models.model import ModelConfig


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


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    add_model_args(p)
    p.add_argument("--seed", type=int, default=42,
                   help="seed of the init when no --weights are given")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch ops on the CPU)")
    return p


def model_config_from_args(args: argparse.Namespace) -> ModelConfig:
    gnn = GTConfig(
        num_layers=args.num_gnn_layers,
        hidden=args.num_gnn_hidden_channels,
        num_heads=args.num_gnn_attention_heads,
        attention_mode=args.attention_mode,
        norm_type=args.norm_type,
    )
    decoder = DecoderConfig(num_chunks=args.num_interact_layers,
                            num_channels=args.num_interact_hidden_channels)
    return ModelConfig(gnn=gnn, decoder=decoder,
                       interaction_stem=args.interaction_stem or "factorized",
                       compute_dtype=args.compute_dtype or "float32")
