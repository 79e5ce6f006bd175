"""Assemble CLI — score every chain pair of one k-chain complex.

Port of ``deepinteract_tpu/cli/assemble.py``; runs on the GPU unless
``--device cpu`` is given. The assembly workload: k chains in, C(k,2) oriented
pairs scored with ONE encoder pass per unique chain, an interface graph
(edges = pairs whose calibrated interaction score clears
``--edge_threshold``), a complex-level interactability score, and the
``input_indep`` control baseline riding next to every number::

    # 6 synthetic chains, everything-vs-everything
    python -m deepinteract_tpu_torch.cli.assemble --synthetic_chains 6 \
        --synthetic_len 20,40 --out runs/asm1

    # a real complex library, calibrated probabilities
    python -m deepinteract_tpu_torch.cli.assemble --chains_npz_dir complexes/ \
        --calibration runs/calibration.json --out runs/asm2

Outputs: ``<out>.jsonl`` (ranked pair records), ``<out>.maps.npz``
(per-pair contact maps, durable artifact), and ``<out>.assembly.json``
(the bundle manifest: interface graph + provenance, durable artifact
with an integrity sidecar, as the JAX package writes it). The FINAL stdout line is the
``assemble/v1`` machine contract (tools/check_cli_contract.py).
"""

from __future__ import annotations

import io
import json
import os
import sys
import time

from deepinteract_tpu_torch.cli.args import add_assembly_args, add_calibration_args
from deepinteract_tpu_torch.cli.screen import (build_engine, build_library, load_calibrator,
                                               split_phase_parser)
from deepinteract_tpu_torch.robustness import artifacts


def write_bundle(out_prefix: str, result, weights_signature: str,
                 calibration_path, write_maps: bool = True):
    """Persist the assembly outputs; returns (ranked, bundle, maps)
    paths. The jsonl is atomic; the maps npz and bundle manifest are
    durable artifacts (sidecar-verified)."""
    ranked_path = out_prefix + ".jsonl"
    lines = [json.dumps({"rank": rank, **rec})
             for rank, rec in enumerate(result.records, start=1)]
    artifacts.atomic_write(ranked_path,
                           "\n".join(lines) + ("\n" if lines else ""))

    maps_path = None
    if write_maps and result.maps:
        import numpy as np

        buf = io.BytesIO()
        np.savez(buf, **result.maps)
        maps_path = out_prefix + ".maps.npz"
        artifacts.atomic_write_artifact(
            maps_path, buf.getvalue(),
            kind="assembly-maps",
            extra={"weights_signature": weights_signature,
                   "pairs": result.pairs_total})

    from deepinteract_tpu_torch.assembly import ASSEMBLY_BUNDLE_KIND

    bundle_path = out_prefix + ".assembly.json"
    bundle = {
        "schema": "assembly-bundle/v1",
        "weights_signature": weights_signature,
        "calibration": calibration_path,
        "interface": result.interface,
        "files": {
            "ranked": os.path.basename(ranked_path),
            "maps": (os.path.basename(maps_path) if maps_path else None),
        },
        **result.summary(),
    }
    artifacts.atomic_write_artifact(
        bundle_path, json.dumps(bundle, sort_keys=True),
        kind=ASSEMBLY_BUNDLE_KIND,
        extra={"weights_signature": weights_signature})
    return ranked_path, bundle_path, maps_path


def main(argv=None) -> int:
    parser = split_phase_parser(__doc__)
    add_assembly_args(parser)
    add_calibration_args(parser)
    args = parser.parse_args(argv)

    from deepinteract_tpu_torch.assembly import AssemblyConfig, AssemblyRunner
    from deepinteract_tpu_torch.screening import EmbeddingCache

    library = build_library(args)
    chain_ids = ([c for c in args.query.split(",") if c]
                 if args.query else None)
    engine = build_engine(args, "assemble")
    try:
        calibrator = load_calibrator(args, engine, "assemble")
        runner = AssemblyRunner(
            engine,
            cache=EmbeddingCache(capacity=args.emb_cache_entries,
                                 spill_dir=args.emb_cache_dir),
            cfg=AssemblyConfig(
                top_k=args.top_k,
                decode_batch=args.screen_batch,
                encode_batch=args.screen_batch,
                edge_threshold=args.edge_threshold,
                control=not args.no_control,
                keep_maps=not args.no_maps,
            ),
            calibrator=calibrator)
        t0 = time.perf_counter()
        result = runner.assemble(library, chain_ids=chain_ids)
        elapsed = time.perf_counter() - t0
    finally:
        engine.close()

    ranked_out, bundle_out, maps_out = write_bundle(
        args.out, result, engine.weights_signature(), args.calibration,
        write_maps=not args.no_maps)
    summary = result.summary()
    contract = {
        "schema": "assemble/v1",
        "metric": "assembly_pairs_per_sec",
        "value": round(result.pairs_scored / max(elapsed, 1e-9), 3),
        "unit": "pairs/s",
        "ok": True,
        "chains": result.chains,
        "pairs_total": result.pairs_total,
        "pairs_scored": result.pairs_scored,
        "unique_encodes": result.unique_encodes,
        "encode_cache_hits": result.encode_cache_hits,
        "decode_batches": result.decode_batches,
        "interface_edges": summary["interface_edges"],
        "interactability": summary["interactability"],
        "control_score": summary["control_score"],
        "calibrated": result.calibrated,
        "calibration": args.calibration,
        "weights_signature": engine.weights_signature(),
        "ranked_out": ranked_out,
        "bundle_out": bundle_out,
        "maps_out": maps_out,
        "elapsed_s": round(elapsed, 3),
    }
    # FINAL stdout line = the machine-readable contract.
    print(json.dumps(contract), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
