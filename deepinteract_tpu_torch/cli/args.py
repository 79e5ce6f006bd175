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
    g.add_argument("--batch_size", type=int, default=1)
    add_bucket_args(g)
    g.add_argument("--packed_cache_dir", type=str, default=None,
                   help="directory for pre-padded per-bucket memmap packs of each split "
                        "(built on the first run, and by either package); the per-epoch host "
                        "path is then an mmap + stack instead of npz decompress + pad")


def add_bucket_args(g) -> None:
    """The input flags that training, testing and serving share."""
    g.add_argument("--input_indep", action="store_true",
                   help="zero all input features (the reference's control)")
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
    g.add_argument("--steps_per_dispatch", type=int, default=8,
                   help="train steps per dispatch: a run of this many same-shape batches is "
                        "placed once and stepped back to back, and the loader shuffles whole "
                        "runs (1 = a dispatch per step)")
    g.add_argument("--patience", type=int, default=5)
    g.add_argument("--min_delta", type=float, default=5e-6)
    g.add_argument("--weight_classes", action="store_true",
                   help="1:5 positive class weighting")
    g.add_argument("--pos_prob_threshold", type=float, default=0.5)
    g.add_argument("--log_every", type=int, default=100)
    g.add_argument("--eval_batch_size", type=int, default=1,
                   help="complexes per val/test batch (metrics stay per complex)")
    g.add_argument("--eval_batches_per_dispatch", type=int, default=8,
                   help="eval batches per dispatch: a same-shape run's outputs reach the host "
                        "in one copy (1 = batch by batch)")
    g.add_argument("--viz_every_n_epochs", type=int, default=0,
                   help="log predicted and true contact-map images to the metric writer "
                        "every N epochs (0 = off)")
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

    g = p.add_argument_group("input pipeline")
    g.add_argument("--device_prefetch", action="store_true",
                   help="place each train run on the placement thread while the previous "
                        "dispatch runs: on a GPU the run's tensors go to pinned memory and "
                        "then to the card by non-blocking copies on a side CUDA stream, at "
                        "most the loader's prefetch depth (2) of runs ahead")

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


def add_logging_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("logging")
    g.add_argument("--experiment_name", type=str, default=None)
    g.add_argument("--tb_log_dir", type=str, default=None,
                   help="TensorBoard scalar log directory (tensorboardX)")
    g.add_argument("--use_wandb", action="store_true",
                   help="log to Weights & Biases; without wandb installed it is ignored "
                        "with a warning")
    g.add_argument("--wandb_project", type=str, default="DeepInteract-TPU")
    g.add_argument("--wandb_entity", type=str, default=None, help="W&B entity")
    g.add_argument("--offline", action="store_true", help="wandb offline mode")
    g.add_argument("--profile_dir", type=str, default=None,
                   help="write a phase-labeled torch.profiler Chrome trace of --profile_steps "
                        "train dispatches (from the second one) into this directory")
    g.add_argument("--profile_steps", type=int, default=3,
                   help="train dispatches captured by --profile_dir")
    g.add_argument("--no_span_log", action="store_true",
                   help="do not write the phase-span JSONL log (<ckpt_dir>/obs/events.jsonl)")


def add_serving_args(p: argparse.ArgumentParser) -> None:
    """Knobs of the resident inference engine (``cli/serve.py``), with the
    JAX package's names and defaults; the model and checkpoint flags are
    shared with train/test/predict."""
    g = p.add_argument_group("serving")
    g.add_argument("--host", type=str, default="127.0.0.1")
    g.add_argument("--port", type=int, default=8008,
                   help="0 picks a free port (printed at startup)")
    g.add_argument("--max_batch", type=int, default=8,
                   help="micro-batch flush size: pending same-bucket requests share one "
                        "graph replay once this many are queued")
    g.add_argument("--max_delay_ms", type=float, default=5.0,
                   help="max time a lone request waits for batch company before flushing "
                        "anyway (latency bound)")
    g.add_argument("--warmup_buckets", type=str, default="",
                   help="comma list of B1xB2xBATCH keys captured at startup (e.g. "
                        "128x128x1,128x128x8) so first requests replay warm graphs")
    g.add_argument("--mesh_shape", type=str, default="",
                   help="serving mesh as DATAxPAIR device counts (the JAX flag). An "
                        "engine worker of this port serves one device: any shape but "
                        "'' or 1x1 exits 2. Stub workers advertise it, so the router's "
                        "topology-aware routing can be rehearsed")
    g.add_argument("--pair_shard_threshold", type=int, default=512,
                   help="bucket pad at/above which a mesh with a pair axis would decode "
                        "row-sharded; the router uses it for topology-aware routing")
    g.add_argument("--result_cache_size", type=int, default=256,
                   help="LRU entries of depadded contact maps keyed on a content hash of "
                        "the featurized complex (0 disables)")
    g.add_argument("--request_timeout_s", type=float, default=120.0,
                   help="per-request wait bound inside the HTTP handler")
    g.add_argument("--max_queue_depth", type=int, default=64,
                   help="admission control: max pending requests PER shape bucket; "
                        "submits beyond it are rejected 429 with Retry-After")
    g.add_argument("--max_inflight", type=int, default=256,
                   help="admission control: max admitted-but-unanswered requests across "
                        "all buckets (global cap)")
    g.add_argument("--default_deadline_ms", type=float, default=0.0,
                   help="request deadline applied when the client sends neither "
                        "X-Request-Deadline-Ms nor deadline_s; expired requests fail 504 "
                        "before a dispatch (0 disables)")
    g.add_argument("--shed_enter_util", type=float, default=0.9,
                   help="load shedding: enter degraded mode (429 on POST, /healthz "
                        "'overloaded') when in-flight/max_inflight reaches this fraction")
    g.add_argument("--shed_exit_util", type=float, default=0.5,
                   help="load shedding: leave degraded mode once utilization falls back "
                        "under this fraction (hysteresis; must be <= --shed_enter_util)")
    g.add_argument("--shed_min_degraded_s", type=float, default=2.0,
                   help="minimum dwell in degraded mode before recovery is considered")
    g.add_argument("--no_load_shedding", action="store_true",
                   help="disable the degraded-mode shedder (bounded queues still reject "
                        "429 at admission)")
    g.add_argument("--events_out", type=str, default=None,
                   help="span event log (JSONL) for request-scoped tracing: every traced "
                        "request's queue-wait/compile/device decomposition lands here "
                        "under its trace_id")
    g.add_argument("--heartbeat_file", type=str, default=None,
                   help="periodic liveness file (obs/heartbeat.py)")
    g.add_argument("--heartbeat_interval_s", type=float, default=5.0,
                   help="heartbeat write cadence for --heartbeat_file")
    g.add_argument("--screen_max_pairs", type=int, default=512,
                   help="largest synchronous POST /screen (pairs); bigger screens are "
                        "refused 400 toward cli/screen.py. Indexed screens are exempt: "
                        "they stream decode micro-batches with partial-result flushes "
                        "under the deadline")
    g.add_argument("--index_path", type=str, default=None,
                   help="proteome-index directory (cli/index.py build) opened and "
                        "verified at startup; POST /screen with {\"indexed\": true} then "
                        "ranks partners against it. Reaches every fleet worker through "
                        "the shared base argv")
    g.add_argument("--parent_pid", type=int, default=0,
                   help="drain and exit when this process is no longer our parent (the "
                        "fleet supervisor sets it, so a hard-killed supervisor never "
                        "leaves workers serving; 0 disables)")
    f = p.add_argument_group(
        "fleet", "multi-worker serving (serving/fleet.py + router.py): a supervisor "
        "keeps N engine-worker processes alive behind an HTTP router with "
        "health-checked failover and zero-downtime warm rollover (POST "
        "/admin/rollover or SIGHUP)")
    f.add_argument("--workers", type=int, default=0,
                   help="> 0: run the fleet (supervisor + router on --port, N engine "
                        "workers on free ports, each capturing its own CUDA graphs); "
                        "0 = the single-engine server")
    f.add_argument("--fleet_stub_workers", action="store_true",
                   help="rehearsal fleet: workers are serving/worker_stub.py null "
                        "engines (no model, no device, sub-second startup)")
    f.add_argument("--fleet_dir", type=str, default=None,
                   help="supervisor state dir (heartbeats, worker logs, "
                        "fleet_state.json); default: a fresh temp dir")
    f.add_argument("--probe_interval_s", type=float, default=1.0,
                   help="supervisor monitor cadence: process poll + /healthz probe + "
                        "heartbeat staleness per tick")
    f.add_argument("--heartbeat_max_age_s", type=float, default=15.0,
                   help="a worker heartbeat older than this is stale (unroutable); 3x "
                        "older with a live process is wedged and gets SIGKILLed into "
                        "the restart path")
    f.add_argument("--restart_backoff_s", type=float, default=0.5,
                   help="base of the exponential restart backoff for crashed workers "
                        "(jittered, capped at 30s)")
    f.add_argument("--circuit_max_restarts", type=int, default=5,
                   help="restarts inside --circuit_window_s after which a flapping "
                        "worker's circuit opens (no more restarts; the rest of the "
                        "fleet keeps serving)")
    f.add_argument("--circuit_window_s", type=float, default=60.0,
                   help="sliding window for --circuit_max_restarts")
    f.add_argument("--fleet_warm_timeout_s", type=float, default=300.0,
                   help="rollover bound: how long a replacement worker may take to "
                        "report warm before the rollover aborts (old fleet keeps "
                        "serving)")
    f.add_argument("--rollover", action="store_true",
                   help="client mode: POST /admin/rollover to the fleet router at "
                        "--host/--port and exit (final stdout line is the fleet/v1 "
                        "contract)")
    f.add_argument("--rollover_ckpt", type=str, default=None,
                   help="with --rollover: checkpoint dir the replacement workers "
                        "restore (default: same as the running fleet)")
    f.add_argument("--rollover_signature", type=str, default=None,
                   help="with --rollover: required weights_signature the replacements "
                        "must report before traffic switches")
    f.add_argument("--autoscale", action="store_true",
                   help="with --workers: run the elastic capacity controller "
                        "(serving/autoscaler.py) — grow/shrink the worker set from "
                        "queue depth, shed pressure and router p99, with hysteresis, "
                        "cooldown, warm-before-adopt scale-up and drain-through "
                        "scale-down")
    f.add_argument("--autoscale_min_workers", type=int, default=1,
                   help="autoscaler floor: never drain below this many workers")
    f.add_argument("--autoscale_max_workers", type=int, default=4,
                   help="autoscaler ceiling: never spawn above this many workers")
    f.add_argument("--autoscale_interval_s", type=float, default=1.0,
                   help="autoscaler control period (signal sample + streak advance "
                        "per tick)")
    f.add_argument("--autoscale_queue_high", type=float, default=2.0,
                   help="mean in-flight per routable worker at/above which a poll "
                        "counts as a scale-UP breach")
    f.add_argument("--autoscale_queue_low", type=float, default=0.25,
                   help="mean in-flight per routable worker at/below which (with no "
                        "shed pressure) a poll counts as a scale-DOWN breach")
    f.add_argument("--autoscale_breach_polls", type=int, default=3,
                   help="consecutive breaching polls required before the autoscaler "
                        "acts (hysteresis)")
    f.add_argument("--autoscale_cooldown_s", type=float, default=10.0,
                   help="hold-down after any autoscale action")
    f.add_argument("--versions", action="store_true",
                   help="client mode: GET /admin/versions from the fleet router at "
                        "--host/--port and exit (final stdout line is the versions/v1 "
                        "contract)")


def add_screening_args(p: argparse.ArgumentParser) -> None:
    """Bulk-screening surface (cli/screen.py; deepinteract_tpu_torch.screening)."""
    g = p.add_argument_group("screening")
    g.add_argument("--chains_npz_dir", type=str, default=None,
                   help="directory of complex .npz files; each contributes "
                        "its two chains (<stem>:g1, <stem>:g2) to the "
                        "library")
    g.add_argument("--chains_pack_dir", type=str, default=None,
                   help="pre-padded memmap pack (data/packed.py) to split "
                        "into library chains")
    g.add_argument("--synthetic_chains", type=int, default=0,
                   help="generate N deterministic synthetic chains instead "
                        "of reading a library (smoke tests / benches)")
    g.add_argument("--synthetic_len", type=str, default="24,48",
                   help="LO,HI residue-count range for --synthetic_chains")
    g.add_argument("--query", type=str, default=None,
                   help="comma list of chain ids: score query-vs-library "
                        "instead of all-vs-all")
    g.add_argument("--include_self", action="store_true",
                   help="score the diagonal too (homodimer screening)")
    g.add_argument("--max_pairs", type=int, default=0,
                   help="truncate the pair list (0 = score everything)")
    g.add_argument("--top_k", type=int, default=10,
                   help="contact probabilities per pair summary; the "
                        "ranking score is their mean "
                        "(screening/scoring.py — the same helper behind "
                        "predict --top_k)")
    g.add_argument("--screen_batch", type=int, default=8,
                   help="pairs per decode dispatch (and chains per "
                        "encoder dispatch)")
    g.add_argument("--emb_cache_entries", type=int, default=4096,
                   help="in-memory embedding-cache capacity (chains)")
    g.add_argument("--emb_cache_dir", type=str, default=None,
                   help="spill directory for embeddings evicted from "
                        "memory (npz per chain; reloaded transparently)")
    g.add_argument("--out", type=str, default="screen_out",
                   help="output prefix: <out>.jsonl (ranked records) and "
                        "<out>.csv are written; the manifest defaults to "
                        "<out>.manifest.json")
    g.add_argument("--manifest", type=str, default=None,
                   help="progress-ledger path (atomic per-batch flush; an "
                        "existing matching manifest resumes the screen)")


def add_calibration_args(p: argparse.ArgumentParser) -> None:
    """Calibration-consumption surface shared by predict/screen/query/
    assemble (deepinteract_tpu_torch.calibration): point any scoring
    entry point at a fitted artifact and calibrated probabilities ride
    NEXT TO the raw ones (never instead of them)."""
    g = p.add_argument_group("calibration")
    g.add_argument("--calibration", type=str, default=None,
                   help="fitted calibration artifact (cli/calibrate.py "
                        "output); verified against the served weights' "
                        "signature before use — a map fitted for other "
                        "weights is refused as stale")
    g.add_argument("--allow_stale_calibration", action="store_true",
                   help="apply a calibration whose weights_signature "
                        "does not match the engine (integrity is still "
                        "verified; the probabilities may be garbage — "
                        "format debugging only)")


def add_assembly_args(p: argparse.ArgumentParser) -> None:
    """k-chain assembly surface (cli/assemble.py;
    deepinteract_tpu_torch.assembly)."""
    g = p.add_argument_group("assembly")
    g.add_argument("--edge_threshold", type=float, default=0.5,
                   help="interface-graph edge cut: pairs whose "
                        "calibrated interaction score (raw score when "
                        "no --calibration) reaches this become edges")
    g.add_argument("--no_control", action="store_true",
                   help="skip the input_indep control pass (the zeroed-"
                        "features honesty baseline reported next to "
                        "every assembly score)")
    g.add_argument("--no_maps", action="store_true",
                   help="do not persist the per-pair contact maps "
                        "(<out>.npz); rankings and the interface graph "
                        "are still written")


def add_index_args(p: argparse.ArgumentParser) -> None:
    """Proteome-index surface (cli/index.py, cli/query.py;
    deepinteract_tpu_torch.index)."""
    g = p.add_argument_group("proteome index")
    g.add_argument("--index_dir", type=str, default="index_out",
                   help="index directory: build/merge target, "
                        "verify/query source (manifest + partitions/)")
    g.add_argument("--partition_size", type=int, default=64,
                   help="chains per index partition shard (the build's "
                        "exactly-once unit of work)")
    g.add_argument("--merge_from", action="append", default=None,
                   metavar="DIR",
                   help="source index for 'merge' (repeat per source; "
                        "all must share the embedding identity and be "
                        "chain-disjoint)")
    g.add_argument("--top_m", type=int, default=32,
                   help="pre-filter survivors handed to the decoder per "
                        "query (the funnel neck; index/prefilter.py)")
    g.add_argument("--allow_stale", action="store_true",
                   help="query an index whose weights_signature no "
                        "longer matches the engine (rankings may be "
                        "garbage; meant for format debugging only)")


def add_engine_args(p: argparse.ArgumentParser) -> None:
    """What a split-phase CLI (screen, index, query, assemble, calibrate)
    builds its engine from: the bucket flags, a checkpoint or JAX weights."""
    add_bucket_args(p)
    add_restore_args(p)
    p.add_argument("--weights", type=str, default=None,
                   help="flat-path .npz of JAX variables (weights.save_npz)")


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
                      heartbeat_seconds=args.heartbeat_seconds,
                      viz_every_n_epochs=args.viz_every_n_epochs,
                      steps_per_dispatch=args.steps_per_dispatch,
                      eval_batches_per_dispatch=args.eval_batches_per_dispatch,
                      device_prefetch=args.device_prefetch,
                      span_log=not getattr(args, "no_span_log", False),
                      profile_dir=getattr(args, "profile_dir", None),
                      profile_steps=getattr(args, "profile_steps", 3))


def default_experiment_name(args: argparse.Namespace) -> str:
    """``--experiment_name``, else the reference's run name:
    LitGINI-b{batch}-gl{gnn_layers}-n{hidden}-e{hidden}-il{interact_layers}-i{interact_hidden}."""
    if getattr(args, "experiment_name", None):
        return args.experiment_name
    return (f"LitGINI-b{args.batch_size}-gl{args.num_gnn_layers}"
            f"-n{args.num_gnn_hidden_channels}-e{args.num_gnn_hidden_channels}"
            f"-il{args.num_interact_layers}-i{args.num_interact_hidden_channels}")


def make_metric_writer(args: argparse.Namespace):
    """The metric writer the logging flags ask for: a TensorBoard writer
    (``--tb_log_dir``), a W&B writer (``--use_wandb``, None without
    wandb), both behind a fan-out, or None."""
    from deepinteract_tpu_torch.training.wandb_logger import FanoutWriter, make_wandb_writer

    writers = []
    if getattr(args, "tb_log_dir", None):
        from tensorboardX import SummaryWriter

        writers.append(SummaryWriter(args.tb_log_dir))
    if getattr(args, "use_wandb", False):
        writers.append(make_wandb_writer(
            args.wandb_project, run_name=default_experiment_name(args),
            config={k: v for k, v in vars(args).items()
                    if isinstance(v, (int, float, str, bool, type(None)))},
            offline=args.offline))
    writers = [w for w in writers if w is not None]
    if not writers:
        return None
    return writers[0] if len(writers) == 1 else FanoutWriter(writers)
