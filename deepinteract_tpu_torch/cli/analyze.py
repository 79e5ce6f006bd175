"""Ops/analysis CLI: dataset statistics, split partitioning, leakage audit.

The reference ships these as separate click CLIs
(``builder/collect_dataset_statistics.py``, ``builder/log_dataset_statistics.py``,
``builder/partition_dataset_filenames.py``, ``builder/check_percent_identity.py``,
``misc/check_leakage.py``, ``misc/check_length.py`` — SURVEY.md §1 Lx); here
they are subcommands over the npz dataset tree, backed by
:mod:`deepinteract_tpu_torch.data.analysis`.

  python -m deepinteract_tpu_torch.cli.analyze stats --root DS [--csv_out s.csv]
  python -m deepinteract_tpu_torch.cli.analyze partition --root DS [--seed 42]
  python -m deepinteract_tpu_torch.cli.analyze leakage --root DS [--threshold 0.3]
  python -m deepinteract_tpu_torch.cli.analyze lengths --root DS

Port of ``deepinteract_tpu/cli/analyze.py`` (the port imports nothing of the
JAX package); it writes and prints what the JAX one does.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List


def _processed_paths(root: str) -> List[str]:
    paths = sorted(glob.glob(os.path.join(root, "processed", "**", "*.npz"),
                             recursive=True))
    if not paths:
        raise SystemExit(f"no processed npz complexes under {root}/processed")
    return paths


def _split_paths(root: str, mode: str) -> List[str]:
    split = os.path.join(root, f"pairs-postprocessed-{mode}.txt")
    with open(split) as f:
        names = [l.strip() for l in f if l.strip()]
    return [os.path.join(root, "processed", os.path.splitext(n)[0] + ".npz")
            for n in names]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("stats", help="per-complex + aggregate statistics")
    sp.add_argument("--root", required=True)
    sp.add_argument("--csv_out", default=None)

    pp = sub.add_parser("partition", help="size-filter + random split files")
    pp.add_argument("--root", required=True)
    pp.add_argument("--seed", type=int, default=42)

    lp = sub.add_parser("leakage", help="train-vs-test sequence-identity audit")
    lp.add_argument("--root", required=True)
    lp.add_argument("--threshold", type=float, default=0.3)

    np_ = sub.add_parser("lengths", help="chain-length distribution audit")
    np_.add_argument("--root", required=True)

    args = p.parse_args(argv)

    from deepinteract_tpu_torch.data import analysis

    if args.cmd == "stats":
        agg = analysis.collect_statistics(_processed_paths(args.root),
                                          csv_out=args.csv_out)
        print(json.dumps(agg))
    elif args.cmd == "partition":
        from deepinteract_tpu_torch.data.io import complex_lengths_from_file

        paths = _processed_paths(args.root)
        nl = []
        for path in paths:
            rel = os.path.relpath(path, os.path.join(args.root, "processed"))
            nl.append((rel, *complex_lengths_from_file(path)))
        splits = analysis.partition_filenames(nl, seed=args.seed)
        analysis.write_split_files(args.root, splits)
        print(json.dumps({k: len(v) for k, v in splits.items()}))
    elif args.cmd == "leakage":
        leaks = analysis.check_leakage(
            _split_paths(args.root, "train"), _split_paths(args.root, "test"),
            threshold=args.threshold,
        )
        for cand, test_name, pid in leaks:
            print(f"LEAK {cand} ~ {test_name}: {pid:.2f}")
        print(json.dumps({"num_leaks": len(leaks)}))
        return 1 if leaks else 0
    elif args.cmd == "lengths":
        print(json.dumps(analysis.length_audit(_processed_paths(args.root))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
