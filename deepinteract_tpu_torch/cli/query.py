"""Query CLI — ranked interface partners for one chain from an index.

Port of ``deepinteract_tpu/cli/query.py``; runs on the GPU unless
``--device cpu`` is given.

The single-box ranked-partner path: "what does this chain bind?"
against a prebuilt proteome index (cli/index.py), paying one encoder
pass (zero when the query is index-resident), one pooled-embedding
pre-filter over the whole library, and contact decodes for only the
top-M survivors (``deepinteract_tpu_torch.index.funnel``)::

    # query an indexed chain against its own library
    python -m deepinteract_tpu_torch.cli.query --index_dir runs/idx1 \
        --query syn0007 --top_m 32 --out runs/q7

    # query an external chain (read from a complex npz library)
    python -m deepinteract_tpu_torch.cli.query --index_dir runs/idx1 \
        --chains_npz_dir complexes/ --query 1abc:g1 --out runs/q_abc

Outputs ``<out>.jsonl`` — ranked partner records, best first, each with
its decode score, prefilter score, and top contacts. The FINAL stdout
line is the ``query/v1`` machine contract
(tools/check_cli_contract.py).
"""

from __future__ import annotations

import json
import sys
import time

from deepinteract_tpu_torch.cli.args import add_calibration_args, add_index_args
from deepinteract_tpu_torch.cli.screen import (build_engine, build_library, load_calibrator,
                                               split_phase_parser)
from deepinteract_tpu_torch.robustness import artifacts


def write_ranked(out_prefix: str, records) -> str:
    """Ranked partner JSONL (atomic, robustness/artifacts.py)."""
    path = out_prefix + ".jsonl"
    lines = [json.dumps({"rank": rank, **rec})
             for rank, rec in enumerate(records, start=1)]
    artifacts.atomic_write(path,
                           "\n".join(lines) + ("\n" if lines else ""))
    return path


def main(argv=None) -> int:
    parser = split_phase_parser(__doc__)
    add_index_args(parser)
    add_calibration_args(parser)
    args = parser.parse_args(argv)
    if not args.query or "," in args.query:
        raise SystemExit("--query must name exactly one chain id")

    from deepinteract_tpu_torch.calibration.calibrator import annotate_records
    from deepinteract_tpu_torch.index import ChainIndex, IndexedQueryRunner, QueryConfig
    from deepinteract_tpu_torch.screening import EmbeddingCache

    index = ChainIndex.open(args.index_dir)
    print(f"query: index {args.index_dir} — {index.num_chains} chains in "
          f"{len(index.partition_ids())} partitions "
          f"(weights {index.weights_signature})", flush=True)
    engine = build_engine(args, "query")
    try:
        calibrator = load_calibrator(args, engine, "query")
        runner = IndexedQueryRunner(
            engine, index,
            cfg=QueryConfig(top_m=args.top_m, top_k=args.top_k,
                            decode_batch=args.screen_batch),
            cache=EmbeddingCache(capacity=args.emb_cache_entries,
                                 spill_dir=args.emb_cache_dir),
            allow_stale=args.allow_stale)
        t0 = time.perf_counter()
        external = (args.chains_npz_dir or args.chains_pack_dir
                    or args.synthetic_chains > 0)
        if external:
            library = build_library(args)
            entry = library[args.query]
            result = runner.query_from_raw(entry.chain_id, entry.raw)
        else:
            result = runner.query_from_index(args.query)
        elapsed = time.perf_counter() - t0
    finally:
        engine.close()

    annotate_records(result.records, calibrator)
    ranked_out = write_ranked(args.out, result.records)
    latency_ms = elapsed * 1e3
    contract = {
        "schema": "query/v1",
        "metric": "query_latency_ms",
        "value": round(latency_ms, 3),
        "unit": "ms",
        "ok": True,
        "query": result.query,
        "index_dir": args.index_dir,
        "chains": index.num_chains,
        "candidates": result.candidates,
        "top_m": args.top_m,
        "survivors": result.survivors,
        "pairs_decoded": result.pairs_decoded,
        "decode_batches": result.decode_batches,
        "prefilter_survivor_frac": round(
            result.prefilter_survivor_frac, 4),
        "partial": result.partial,
        "ranked_out": ranked_out,
        "elapsed_s": round(elapsed, 3),
        "top_partner": (
            {k: result.records[0][k]
             for k in ("partner", "score", "prefilter_score")}
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
