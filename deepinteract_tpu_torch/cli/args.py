"""Flags of the port's CLIs, with the JAX package's names and defaults
(``deepinteract_tpu/cli/args.py``), and the configs they build."""

from __future__ import annotations

import argparse

from deepinteract_tpu_torch.constants import NODE_COUNT_LIMIT
from deepinteract_tpu_torch.models.decoder import REMAT_POLICIES, DecoderConfig
from deepinteract_tpu_torch.models.geometric_transformer import GTConfig
from deepinteract_tpu_torch.models.model import (GNN_LAYER_TYPES, INTERACT_MODULE_TYPES,
                                                 ModelConfig)
from deepinteract_tpu_torch.models.vision import DeepLabConfig
from deepinteract_tpu_torch.training.loop import LoopConfig
from deepinteract_tpu_torch.training.optim import OptimConfig


def add_model_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("model")
    g.add_argument("--gnn_layer_type", choices=GNN_LAYER_TYPES, default="geotran",
                   help="chain encoder: the Geometric Transformer or a plain GCN")
    g.add_argument("--num_gnn_layers", type=int, default=2)
    g.add_argument("--num_gnn_hidden_channels", type=int, default=128)
    g.add_argument("--num_gnn_attention_heads", type=int, default=4)
    g.add_argument("--node_count_limit", type=int, default=NODE_COUNT_LIMIT,
                   help="rows of the encoder's node-position embedding: the largest padded "
                        "chain it takes (a checkpoint fixes it)")
    g.add_argument("--interact_module_type", choices=INTERACT_MODULE_TYPES, default="dilated",
                   help="dilated = SE-ResNet decoder (the reference's default); "
                        "deeplab = the DeepLabV3+ alternative")
    g.add_argument("--num_interact_layers", type=int, default=14,
                   help="decoder ResNet chunks")
    g.add_argument("--num_interact_hidden_channels", type=int, default=128)
    g.add_argument("--use_interact_attention", action="store_true",
                   help="regional attention after each dilated-decoder stage")
    g.add_argument("--deeplab_output_stride", type=int, choices=(8, 16), default=16,
                   help="DeepLabV3+ encoder output stride")
    g.add_argument("--deeplab_encoder", choices=("resnet18", "resnet34", "resnet50"),
                   default="resnet34", help="DeepLabV3+ encoder backbone")
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
    g.add_argument("--disable_geometric_mode", action="store_true",
                   help="plain edge features in place of the GT's geometric modules")
    g.add_argument("--norm_type", choices=("batch", "layer"), default="batch")
    g.add_argument("--tile_pair_map", action="store_true",
                   help="decode the pair map in 256x256 tiles once a padded chain exceeds "
                        "one tile (each tile is its own map)")
    g.add_argument("--dropout_rate", type=float, default=0.2)
    g.add_argument("--remat", action="store_true",
                   help="rematerialize decoder blocks in the backward (torch.utils.checkpoint): "
                        "each block keeps only its input and recomputes the rest")
    g.add_argument("--remat_policy", choices=REMAT_POLICIES, default="full",
                   help="with --remat: 'full' recomputes whole blocks; 'convs' keeps the conv "
                        "outputs and recomputes only the elementwise chain")


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
    g.add_argument("--pos_prob_threshold", type=float, default=0.5)
    g.add_argument("--log_every", type=int, default=100)
    g.add_argument("--eval_batch_size", type=int, default=1,
                   help="complexes per val/test batch (metrics stay per complex)")
    g.add_argument("--sync_checkpoint", action="store_true",
                   help="save the epoch-boundary checkpoint synchronously instead of "
                        "writing it on a worker thread while the next epoch trains")
    g.add_argument("--ckpt_dir", type=str, default="checkpoints",
                   help="checkpoint root of this run (best/, last/, mid/)")
    add_restore_args(g)
    g.add_argument("--fine_tune", action="store_true",
                   help="warm-start the model from --ckpt_name's best/ step and freeze "
                        "the decoder")
    g.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint under --ckpt_dir")
    g.add_argument("--find_lr", action="store_true",
                   help="run an LR range test before training and use its suggestion")
    g.add_argument("--stochastic_weight_avg", action="store_true",
                   help="average the params over the last 20%% of epochs")
    g.add_argument("--max_hours", type=float, default=None)
    g.add_argument("--deterministic", action="store_true",
                   help="run under torch.use_deterministic_algorithms (and a fixed cuBLAS "
                        "workspace): two runs of one command, or a run and its --resume, "
                        "give bitwise equal weights; an op without a deterministic kernel "
                        "raises")

    g = p.add_argument_group("fault tolerance")
    g.add_argument("--no_nonfinite_guard", action="store_true",
                   help="disable the non-finite step guard (by default a step whose loss or "
                        "gradients are not finite skips the optimizer update)")
    g.add_argument("--max_bad_steps", type=int, default=10,
                   help="abort with a diagnostic dump after this many consecutive "
                        "non-finite (skipped) train steps")
    g.add_argument("--no_preemption_guard", action="store_true",
                   help="do not install SIGTERM/SIGINT handlers around fit (by default a "
                        "preemption flushes the newest checkpoint and exits 0; rerun with "
                        "--resume)")
    g.add_argument("--data_skip_budget", type=int, default=0,
                   help="train batches per epoch that may fail to load and be skipped "
                        "(logged) instead of ending the run (0 = fail fast)")
    g.add_argument("--save_every_steps", type=int, default=0,
                   help="mid-epoch checkpoint cadence in train steps, with the loader "
                        "cursor, so --resume re-pays at most N steps (0 = epoch "
                        "boundaries only)")
    g.add_argument("--heartbeat_seconds", type=float, default=0.0,
                   help="write <ckpt_dir>/obs/heartbeat_p0.json (process, phase, last "
                        "progress step and time) every N seconds; 0 disables")

    g = p.add_argument_group(
        "supervision",
        "run training as a supervised child (training/supervisor.py): a crash restarts "
        "with jittered backoff into --resume, a live but hung child (no heartbeat progress) "
        "is killed and resumed, and a crash loop opens a circuit breaker; the last stdout "
        "line is the train_supervise/v1 record")
    g.add_argument("--supervise", action="store_true",
                   help="spawn this command line as a watched child (with "
                        "--heartbeat_seconds on) and restart it into --resume on a crash "
                        "or a hang")
    g.add_argument("--watch_interval_s", type=float, default=1.0,
                   help="supervisor poll cadence")
    g.add_argument("--hang_timeout_s", type=float, default=600.0,
                   help="a live child whose heartbeat shows no progress for this long is "
                        "killed and resumed")
    g.add_argument("--start_grace_s", type=float, default=900.0,
                   help="grace after each (re)spawn before the hang verdict applies")
    g.add_argument("--train_restart_backoff_s", type=float, default=1.0,
                   help="base of the jittered exponential backoff between restarts "
                        "(capped at 60 s)")
    g.add_argument("--train_circuit_max_restarts", type=int, default=5,
                   help="restarts inside --train_circuit_window_s after which the "
                        "supervisor stops and exits nonzero")
    g.add_argument("--train_circuit_window_s", type=float, default=3600.0,
                   help="sliding window of --train_circuit_max_restarts")


def add_restore_args(p) -> None:
    """The flags that name a checkpoint to restore (train, test, predict)."""
    p.add_argument("--ckpt_name", type=str, default=None,
                   help="checkpoint directory to restore from (its best/ step)")
    p.add_argument("--metric_to_track", type=str, default="val_ce",
                   help="metric that ranks best/ ('min' iff its name contains 'ce')")


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
        node_count_limit=args.node_count_limit,
        dropout_rate=args.dropout_rate,
        attention_mode=args.attention_mode,
        disable_geometric_mode=args.disable_geometric_mode,
        norm_type=args.norm_type,
    )
    decoder = DecoderConfig(num_chunks=args.num_interact_layers,
                            num_channels=args.num_interact_hidden_channels,
                            use_attention=args.use_interact_attention,
                            dropout_rate=args.dropout_rate, remat=args.remat,
                            remat_policy=args.remat_policy)
    deeplab = DeepLabConfig(dropout_rate=args.dropout_rate, remat=args.remat,
                            output_stride=args.deeplab_output_stride,
                            encoder_name=args.deeplab_encoder)
    return ModelConfig(gnn=gnn, decoder=decoder, deeplab=deeplab,
                       gnn_layer_type=args.gnn_layer_type,
                       interact_module_type=args.interact_module_type,
                       tile_pair_map=args.tile_pair_map,
                       interaction_stem=args.interaction_stem or "factorized",
                       compute_dtype=args.compute_dtype or "float32")


def optim_config_from_args(args: argparse.Namespace) -> OptimConfig:
    return OptimConfig(lr=args.lr, weight_decay=args.weight_decay,
                       grad_clip_norm=args.grad_clip_norm, num_epochs=args.num_epochs,
                       accumulate_steps=args.accumulate_grad_batches)


def loop_config_from_args(args: argparse.Namespace) -> LoopConfig:
    return LoopConfig(num_epochs=args.num_epochs, patience=args.patience,
                      min_delta=args.min_delta, seed=args.seed,
                      weight_classes=args.weight_classes,
                      pos_prob_threshold=args.pos_prob_threshold, log_every=args.log_every,
                      metric_to_track=args.metric_to_track, ckpt_dir=args.ckpt_dir,
                      swa=args.stochastic_weight_avg,
                      max_time_seconds=args.max_hours * 3600 if args.max_hours else None,
                      preemption_guard=not args.no_preemption_guard,
                      save_every_steps=args.save_every_steps,
                      async_checkpoint=not args.sync_checkpoint,
                      nonfinite_guard=not args.no_nonfinite_guard,
                      max_bad_steps=args.max_bad_steps,
                      heartbeat_seconds=args.heartbeat_seconds)
