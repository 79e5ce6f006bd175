"""Calibrate CLI — fit a probability calibration on held-out pairs.

Port of ``deepinteract_tpu/cli/calibrate.py``; runs on the GPU unless
``--device cpu`` is given.

Scores a held-out labeled pair set through the real split-phase runner,
fits temperature scaling (``--method temperature``, default) or
isotonic regression (``--method isotonic``) on the FIT half, measures
expected calibration error before/after on the EVAL half (proper
held-out: the two halves share no pair), and persists the fitted map as
a durable artifact keyed by the engine's ``weights_signature``::

    # synthetic rehearsal: deterministic miscalibrated labels
    python -m deepinteract_tpu_torch.cli.calibrate --synthetic_chains 8 \
        --synthetic_len 20,40 --calibration_out runs/calibration.json

    # real labels: an npz mapping pair_id -> binary contact map
    python -m deepinteract_tpu_torch.cli.calibrate --chains_npz_dir complexes/ \
        --labels_npz labels.npz --calibration_out runs/calibration.json

Every scoring entry point (predict/screen/query/assemble) then
applies it via ``--calibration runs/calibration.json`` — calibrated
probabilities ride next to the raw ones, never instead of them. The
FINAL stdout line is the ``calibrate/v1`` machine contract
(tools/check_cli_contract.py).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from deepinteract_tpu_torch.cli.screen import build_engine, build_library, split_phase_parser


def add_calibrate_args(parser) -> None:
    g = parser.add_argument_group("calibration fitting")
    g.add_argument("--calibration_out", type=str,
                   default="calibration.json",
                   help="artifact path for the fitted map (atomic write "
                        "+ sha256 sidecar)")
    g.add_argument("--method", choices=("temperature", "isotonic"),
                   default="temperature",
                   help="temperature = one scalar on the recovered "
                        "logit (Guo et al. 2017); isotonic = "
                        "pool-adjacent-violators step map")
    g.add_argument("--labels_npz", type=str, default=None,
                   help="npz of binary contact-map labels keyed by "
                        "pair_id ('chain1|chain2'); required for real "
                        "libraries, ignored with --synthetic_chains")
    g.add_argument("--miscal_temperature", type=float, default=2.5,
                   help="synthetic-label generator: the TRUE temperature "
                        "the model is (deterministically) miscalibrated "
                        "by — labels are drawn at sigmoid(logit/T)")
    g.add_argument("--ece_bins", type=int, default=15,
                   help="equal-width confidence bins for the ECE report")
    g.add_argument("--max_contacts", type=int, default=200_000,
                   help="cap on pooled contacts per half (fit/eval) — "
                        "keeps the numpy fit O(small) for huge maps")


def main(argv=None) -> int:
    parser = split_phase_parser(__doc__)
    add_calibrate_args(parser)
    args = parser.parse_args(argv)

    from deepinteract_tpu_torch.assembly import AssemblyConfig, AssemblyRunner
    from deepinteract_tpu_torch.calibration import (expected_calibration_error,
                                                    miscalibrated_labels, save_calibration)
    from deepinteract_tpu_torch.calibration.calibrator import fit_calibrator
    from deepinteract_tpu_torch.screening import EmbeddingCache

    library = build_library(args)
    engine = build_engine(args, "calibrate")
    t0 = time.perf_counter()
    try:
        # Score every library pair once through the real runner —
        # the probabilities being calibrated are EXACTLY the ones
        # screening/assembly will emit (same executables, same maps).
        runner = AssemblyRunner(
            engine,
            cache=EmbeddingCache(capacity=args.emb_cache_entries,
                                 spill_dir=args.emb_cache_dir),
            cfg=AssemblyConfig(top_k=args.top_k,
                               decode_batch=args.screen_batch,
                               encode_batch=args.screen_batch,
                               control=False))
        result = runner.assemble(library)
        signature = engine.weights_signature()
    finally:
        engine.close()

    labels_npz = None
    if args.labels_npz:
        labels_npz = np.load(args.labels_npz)
    pair_probs, pair_labels = [], []
    for rec in sorted(result.maps):
        probs = result.maps[rec]
        if labels_npz is not None:
            if rec not in getattr(labels_npz, "files", ()):
                continue
            labels = np.asarray(labels_npz[rec], dtype=np.float64)
            if labels.shape != probs.shape:
                raise SystemExit(
                    f"label map for {rec} has shape {labels.shape}, "
                    f"prediction is {probs.shape}")
        else:
            # Deterministic miscalibrated fixture: the true contact
            # rate is the model's probability at --miscal_temperature,
            # seeded per pair (crc32 — stable across processes, unlike
            # hash()) so the fit/eval halves stay independent.
            import zlib

            labels = miscalibrated_labels(
                probs, true_temperature=args.miscal_temperature,
                seed=zlib.crc32(rec.encode("utf-8")))
        pair_probs.append(probs.ravel())
        pair_labels.append(labels.ravel())
    if len(pair_probs) < 2:
        raise SystemExit(
            f"calibration needs >= 2 labeled pairs to hold one out, got "
            f"{len(pair_probs)} (of {result.pairs_total} scored)")

    # Held-out split at PAIR granularity: even pairs fit, odd pairs
    # evaluate — contacts of one map never straddle the split.
    fit_p = np.concatenate(pair_probs[0::2])[:args.max_contacts]
    fit_y = np.concatenate(pair_labels[0::2])[:args.max_contacts]
    eval_p = np.concatenate(pair_probs[1::2])[:args.max_contacts]
    eval_y = np.concatenate(pair_labels[1::2])[:args.max_contacts]

    cal = fit_calibrator(fit_p, fit_y, method=args.method,
                         weights_signature=signature)
    ece_raw = expected_calibration_error(eval_p, eval_y,
                                         bins=args.ece_bins)
    ece_cal = expected_calibration_error(cal.apply(eval_p), eval_y,
                                         bins=args.ece_bins)
    save_calibration(args.calibration_out, cal,
                     extra={"pairs": len(pair_probs),
                            "contacts_fit": int(fit_p.size)})
    elapsed = time.perf_counter() - t0

    contract = {
        "schema": "calibrate/v1",
        "metric": "ece_calibrated",
        "value": round(ece_cal, 6),
        "unit": "ece",
        "ok": True,
        "method": cal.method,
        "temperature": round(cal.temperature, 6),
        "pairs": len(pair_probs),
        "contacts_fit": int(fit_p.size),
        "contacts_eval": int(eval_p.size),
        "ece_raw": round(ece_raw, 6),
        "ece_calibrated": round(ece_cal, 6),
        "improved": bool(ece_cal < ece_raw),
        "weights_signature": signature,
        "calibration_out": args.calibration_out,
        "elapsed_s": round(elapsed, 3),
    }
    # FINAL stdout line = the machine-readable contract.
    print(json.dumps(contract), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
