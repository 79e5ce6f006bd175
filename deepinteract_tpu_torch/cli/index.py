"""Index CLI — build, verify, and merge persistent proteome indexes.

Port of ``deepinteract_tpu/cli/index.py``. A proteome index
(``deepinteract_tpu_torch.index``) encodes a chain library ONCE through
the engine's encode graphs and lands it as durable, versioned embedding
shards that ranked-partner queries (cli/query.py) reuse — the storage
tier of the docking funnel. Indexes are byte-compatible with the JAX
package's::

    # build: 1k synthetic chains, resumable exactly-once
    python -m deepinteract_tpu_torch.cli.index build --synthetic_chains 1000 \\
        --index_dir runs/idx1 --ckpt_name ckpts/run1

    # verify every shard against its integrity sidecar + manifest
    python -m deepinteract_tpu_torch.cli.index verify --index_dir runs/idx1

    # splice disjoint same-version indexes into one
    python -m deepinteract_tpu_torch.cli.index merge --index_dir runs/all \
        --merge_from runs/idx1 --merge_from runs/idx2

A SIGTERM'd (or kill -9'd) build exits with every finished partition
durable; the same command resumes and encodes ONLY the remaining
partitions. A corrupt shard found on resume is quarantined and just
that partition rebuilt. ``build`` runs on the GPU unless ``--device cpu``
is given; ``verify`` and ``merge`` touch no device.

The FINAL stdout line is the ``index/v1`` machine contract
(tools/check_cli_contract.py).
"""

from __future__ import annotations

import json
import sys

from deepinteract_tpu_torch.cli.args import add_index_args
from deepinteract_tpu_torch.cli.screen import build_engine, build_library, split_phase_parser


def _contract(action: str, args, **kw) -> dict:
    """index/v1: one schema across build/verify/merge — absent counters
    are honest zeros, so callers parse every action the same way."""
    record = {
        "schema": "index/v1",
        "metric": "index_partitions",
        "value": 0,
        "unit": "partitions",
        "ok": False,
        "action": action,
        "index_dir": args.index_dir,
        "partitions": 0,
        "chains": 0,
        "buckets": [],
        "weights_signature": "",
        "library_signature": "",
        "resumed": False,
        "partitions_resumed": 0,
        "partitions_rebuilt": 0,
        "encodes_executed": 0,
        "corrupt": 0,
        "corrupt_paths": [],
        "preempted": False,
        "elapsed_s": 0.0,
    }
    record.update(kw)
    record["value"] = record["partitions"]
    return record


def _do_build(args) -> dict:
    from deepinteract_tpu_torch.index import ChainIndex, build_index
    from deepinteract_tpu_torch.robustness.preemption import PreemptionGuard
    from deepinteract_tpu_torch.screening import EmbeddingCache

    library = build_library(args)
    print(f"index build: {len(library)} chains -> {args.index_dir} "
          f"(signature {library.signature()})", flush=True)
    engine = build_engine(args, "index build")
    try:
        with PreemptionGuard(log=lambda m: print(m, flush=True)) as guard:
            result = build_index(
                engine, library, args.index_dir,
                partition_size=args.partition_size,
                encode_batch=args.screen_batch,
                cache=EmbeddingCache(capacity=args.emb_cache_entries,
                                     spill_dir=args.emb_cache_dir),
                guard=guard)
        buckets = []
        if not result.preempted:
            buckets = ChainIndex.open(args.index_dir).buckets()
        else:
            print("index build: preempted with "
                  f"{result.partitions_built} partitions landed this "
                  "run; rerun the same command to finish", flush=True)
        return _contract(
            "build", args,
            ok=not result.preempted,
            partitions=result.partitions_total,
            chains=result.chains,
            buckets=buckets,
            weights_signature=result.weights_signature,
            library_signature=result.library_signature,
            resumed=result.resumed,
            partitions_resumed=result.partitions_resumed,
            partitions_rebuilt=result.partitions_rebuilt,
            encodes_executed=result.encodes_executed,
            preempted=result.preempted,
            elapsed_s=round(result.elapsed_s, 3))
    finally:
        engine.close()


def _do_verify(args) -> dict:
    from deepinteract_tpu_torch.index import ChainIndex, verify_index

    report = verify_index(args.index_dir, quarantine=args.quarantine)
    buckets = (ChainIndex.open(args.index_dir).buckets()
               if report["ok"] else [])
    return _contract(
        "verify", args,
        ok=report["ok"],
        partitions=report["partitions"],
        chains=report["chains"],
        buckets=buckets,
        weights_signature=report["weights_signature"],
        library_signature=report["library_signature"],
        corrupt=report["corrupt"],
        corrupt_paths=report["corrupt_paths"][:20])


def _do_merge(args) -> dict:
    from deepinteract_tpu_torch.index import ChainIndex, merge_indexes

    if not args.merge_from or len(args.merge_from) < 2:
        raise SystemExit("merge needs at least two --merge_from sources")
    report = merge_indexes(args.merge_from, args.index_dir)
    return _contract(
        "merge", args,
        ok=report["ok"],
        partitions=report["partitions"],
        chains=report["chains"],
        buckets=ChainIndex.open(args.index_dir).buckets(),
        weights_signature=report["weights_signature"],
        library_signature=report["library_signature"])


def main(argv=None) -> int:
    parser = split_phase_parser(__doc__)
    add_index_args(parser)
    parser.add_argument("action", choices=("build", "verify", "merge"),
                        help="build: encode a library into the index "
                             "(resumable exactly-once); verify: audit "
                             "every shard; merge: splice disjoint "
                             "same-version indexes")
    parser.add_argument("--quarantine", action="store_true",
                        help="verify only: move corrupt shards aside "
                             "(.corrupt-<ts>) so the next build rebuilds "
                             "exactly the lost partitions")
    args = parser.parse_args(argv)

    if args.action == "build":
        record = _do_build(args)
    elif args.action == "verify":
        record = _do_verify(args)
    else:
        record = _do_merge(args)
    # FINAL stdout line = the machine-readable contract.
    print(json.dumps(record), flush=True)
    # A preempted build is a CLEAN stop (SIGTERM means "checkpoint and
    # yield", not failure) — exit 0 so supervisors reschedule instead of
    # alerting.
    return 0 if record["ok"] or record["preempted"] else 1


if __name__ == "__main__":
    sys.exit(main())
