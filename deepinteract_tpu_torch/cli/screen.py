"""Screen CLI — bulk all-vs-all (or query-vs-library) chain-pair scoring.

Port of ``deepinteract_tpu/cli/screen.py``. The docking-funnel workload:
rank candidate interface partners across a chain library with N encoder
passes + N^2 micro-batched decodes instead of N^2 full forwards
(``deepinteract_tpu_torch.screening``; on the card each encode and decode
key is one CUDA graph)::

    # all-vs-all over a directory of complex npz files
    python -m deepinteract_tpu_torch.cli.screen --chains_npz_dir complexes/ \\
        --ckpt_name ckpts/run1 --out runs/screen1

    # 12-chain synthetic smoke (no data, no checkpoint) on the CPU
    python -m deepinteract_tpu_torch.cli.screen --synthetic_chains 12 --out /tmp/s \\
        --device cpu

Outputs: ``<out>.jsonl`` (ranked pair records, best first), ``<out>.csv``
(spreadsheet-friendly columns), and an atomically-checkpointed manifest.
A SIGTERM'd screen exits 0 with everything scored so far durable; the
same command resumes and completes the remaining pairs exactly once.
Runs on the GPU unless ``--device cpu`` is given.

The FINAL stdout line is a machine-readable JSON contract
(``tools/check_cli_contract.py screen``): metric/value/unit plus pair
counts, the encode-reuse ratio and embedding-cache hit rate.
"""

from __future__ import annotations

import csv
import io
import json
import sys
import time

from deepinteract_tpu_torch.cli.args import (add_calibration_args, add_engine_args,
                                             add_screening_args, build_parser,
                                             model_config_from_args)
from deepinteract_tpu_torch.robustness import artifacts


def build_library(args):
    from deepinteract_tpu_torch.screening import ChainLibrary

    sources = [bool(args.chains_npz_dir), bool(args.chains_pack_dir),
               args.synthetic_chains > 0]
    if sum(sources) != 1:
        raise SystemExit("provide exactly one of --chains_npz_dir, "
                         "--chains_pack_dir, --synthetic_chains")
    if args.chains_npz_dir:
        return ChainLibrary.from_npz_dir(args.chains_npz_dir)
    if args.chains_pack_dir:
        return ChainLibrary.from_pack(args.chains_pack_dir)
    lo, hi = (int(v) for v in args.synthetic_len.split(","))
    return ChainLibrary.synthetic(args.synthetic_chains, lo, hi, seed=args.seed)


def split_phase_parser(doc: str):
    """The parser every split-phase CLI starts from: the model flags,
    ``--seed``, ``--device``, the engine's flags and the screening
    surface."""
    parser = build_parser(doc)
    add_engine_args(parser)
    add_screening_args(parser)
    return parser


def build_engine(args, tag: str):
    """The resident engine of a split-phase CLI (no result cache: these
    paths never replay whole pairs). Exits 2 when the device is missing."""
    from deepinteract_tpu_torch.device import resolve_device
    from deepinteract_tpu_torch.serving import EngineConfig, InferenceEngine

    if args.weights and args.ckpt_name:
        raise SystemExit(f"{tag}: give --weights or --ckpt_name, not both")
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        print(f"{tag}: {err}", file=sys.stderr)
        raise SystemExit(2)
    return InferenceEngine(
        model_config_from_args(args),
        ckpt_dir=args.ckpt_name,
        cfg=EngineConfig(
            max_batch=args.screen_batch,
            result_cache_size=0,
            diagonal_buckets=args.diagonal_buckets,
            pad_to_max_bucket=args.pad_to_max_bucket,
            input_indep=args.input_indep,
        ),
        seed=args.seed,
        metric_to_track=args.metric_to_track,
        device=device,
        weights=args.weights,
    )


def load_calibrator(args, engine, tag: str):
    """The ``--calibration`` artifact checked against the served weights
    (``--allow_stale_calibration`` skips only that check), or None."""
    if not args.calibration:
        return None
    from deepinteract_tpu_torch.calibration import load_calibration

    calibrator = load_calibration(args.calibration,
                                  expect_signature=engine.weights_signature(),
                                  allow_stale=args.allow_stale_calibration)
    print(f"{tag}: calibration {args.calibration} ({calibrator.method})", flush=True)
    return calibrator


def write_outputs(out_prefix: str, records) -> dict:
    """Ranked JSONL + CSV (atomic, robustness/artifacts.py); returns
    their paths."""
    jsonl_path = out_prefix + ".jsonl"
    lines = [json.dumps({"rank": rank, **rec})
             for rank, rec in enumerate(records, start=1)]
    artifacts.atomic_write(jsonl_path, "\n".join(lines) + ("\n" if lines else ""))
    csv_path = out_prefix + ".csv"
    buf = io.StringIO()
    w = csv.writer(buf)
    w.writerow(["rank", "pair_id", "chain1", "chain2", "n1", "n2",
                "score", "max_prob", "top_k"])
    for rank, rec in enumerate(records, start=1):
        w.writerow([rank, rec["pair_id"], rec["chain1"], rec["chain2"],
                    rec["n1"], rec["n2"], f"{rec['score']:.6f}",
                    f"{rec['max_prob']:.6f}", rec["top_k"]])
    artifacts.atomic_write(csv_path, buf.getvalue())
    return {"jsonl": jsonl_path, "csv": csv_path}


def main(argv=None) -> int:
    parser = split_phase_parser(__doc__)
    add_calibration_args(parser)
    args = parser.parse_args(argv)

    from deepinteract_tpu_torch.calibration.calibrator import annotate_records
    from deepinteract_tpu_torch.robustness.preemption import PreemptionGuard
    from deepinteract_tpu_torch.screening import (EmbeddingCache, ScreenConfig, ScreenManifest,
                                                  ScreenRunner, enumerate_pairs)

    library = build_library(args)
    pairs = enumerate_pairs(
        library,
        queries=(args.query.split(",") if args.query else None),
        include_self=args.include_self,
        max_pairs=args.max_pairs)
    print(f"screen: {len(library)} chains, {len(pairs)} pairs "
          f"(signature {library.signature()})", flush=True)

    engine = build_engine(args, "screen")
    try:
        runner = ScreenRunner(
            engine,
            cache=EmbeddingCache(capacity=args.emb_cache_entries,
                                 spill_dir=args.emb_cache_dir),
            cfg=ScreenConfig(top_k=args.top_k, decode_batch=args.screen_batch,
                             encode_batch=args.screen_batch))
        manifest_path = args.manifest or (args.out + ".manifest.json")
        manifest, resumed = ScreenManifest.load_or_create(
            manifest_path, library.signature(), len(pairs))
        if resumed:
            print(f"screen: resuming — {len(manifest.completed)}/{len(pairs)} "
                  f"pairs already scored in {manifest_path}", flush=True)
        calibrator = load_calibrator(args, engine, "screen")
        t0 = time.perf_counter()
        with PreemptionGuard(log=lambda m: print(m, flush=True)) as guard:
            result = runner.screen(library, pairs, manifest=manifest, guard=guard)
        elapsed = time.perf_counter() - t0
    finally:
        engine.close()

    annotate_records(result.records, calibrator)
    paths = write_outputs(args.out, result.records)
    if result.preempted:
        print(f"screen: preempted with {result.pairs_scored} pairs scored "
              f"this run ({len(manifest.completed)}/{len(pairs)} total "
              "durable); rerun the same command to finish", flush=True)
    pps = result.pairs_scored / elapsed if elapsed > 0 else 0.0
    contract = {
        "metric": "screen_pairs_per_sec",
        "value": round(pps, 3),
        "unit": "pairs/s",
        "chains": result.chains,
        "pairs_total": len(pairs),
        "pairs_scored": result.pairs_scored,
        "pairs_resumed": result.pairs_resumed,
        "encode_reuse_ratio": round(result.encode_reuse_ratio, 2),
        "emb_cache_hit_rate": result.summary()["emb_cache_hit_rate"],
        "decode_batches": result.decode_batches,
        "elapsed_s": round(elapsed, 3),
        "preempted": result.preempted,
        "resumed": result.resumed,
        "ranked_out": paths["jsonl"],
        "csv_out": paths["csv"],
        "manifest": manifest_path,
        "top_pair": ({k: result.records[0][k] for k in ("pair_id", "score", "max_prob")}
                     if result.records else None),
    }
    if calibrator is not None:
        contract["calibration"] = args.calibration
        contract["calibrated"] = True
    # FINAL stdout line = the machine-readable contract.
    print(json.dumps(contract), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
