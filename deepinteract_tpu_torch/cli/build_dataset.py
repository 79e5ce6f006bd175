"""Bulk dataset builder: a directory of PDB pairs -> npz dataset tree.

The L1 "builder" entry point (reference:
``project/datasets/builder/process_complexes_into_dicts.py`` +
``partition_dataset_filenames.py``; orchestration at
deepinteract_utils.py:611-850): featurize every complex, write
``processed/<name>.npz``, filter by the reference's size limits, and emit
``pairs-postprocessed-{train,val,test}.txt`` split files (random 80/20
train/test with 25% of train as val — partition_dataset_filenames.py:44-110)
so the result is immediately consumable by ``cli.train``.

Input conventions (checked in order):
  * ``<name>_l_*.pdb`` + ``<name>_r_*.pdb`` pairs anywhere under --input_dir
    (the reference's left/right unbound naming, e.g. 4heq_l_u.pdb), or
  * ``--bound --chain1 A --chain2 B``: every ``*.pdb`` is a bound complex
    split into two chains.

Port of ``deepinteract_tpu/cli/build_dataset.py`` (the port imports nothing of the
JAX package); it writes and prints what the JAX one does.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Tuple

from deepinteract_tpu_torch import constants


def _unique_name(path_no_ext: str, input_dir: str) -> str:
    """Collision-free complex name: the extension-less path relative to the
    input root with separators flattened ('setA/1abc' and 'setB/1abc' stay
    distinct). The caller strips the extension — stripping here would
    corrupt dotted stems like '1abc.pdb1'."""
    rel = os.path.relpath(path_no_ext, input_dir)
    return rel.replace(os.sep, "__")


def find_pairs(input_dir: str) -> List[Tuple[str, str, str]]:
    """(name, left_path, right_path) for every _l_/_r_ pair found (pairs are
    matched within their directory; names stay unique across directories)."""
    lefts: Dict[str, str] = {}
    rights: Dict[str, str] = {}
    for dirpath, _, files in os.walk(input_dir):
        for f in sorted(files):
            if not f.endswith(".pdb"):
                continue
            base = f[: -len(".pdb")]
            for tag, bucket in (("_l_", lefts), ("_r_", rights)):
                if tag in base:
                    stem = base.split(tag)[0]
                    key = _unique_name(os.path.join(dirpath, stem), input_dir)
                    bucket[key] = os.path.join(dirpath, f)
    names = sorted(set(lefts) & set(rights))
    return [(n, lefts[n], rights[n]) for n in names]


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True,
                   help="dataset root; processed/ + split files land here")
    p.add_argument("--bound", action="store_true",
                   help="treat each .pdb as a bound complex of two chains")
    p.add_argument("--chain1", default="A")
    p.add_argument("--chain2", default="B")
    p.add_argument("--knn", type=int, default=constants.KNN)
    p.add_argument("--geo_nbrhd_size", type=int, default=constants.GEO_NBRHD_SIZE)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no_size_filter", action="store_true",
                   help="keep complexes beyond RESIDUE_COUNT_LIMIT (the "
                        "tiled decoder can train on them)")
    p.add_argument("--overwrite", action="store_true")
    args = p.parse_args(argv)

    from deepinteract_tpu_torch.pipeline.pair import (
        convert_bound_complex_to_pair,
        convert_pdb_pair_to_complex,
    )

    processed = os.path.join(args.output_dir, "processed")
    os.makedirs(processed, exist_ok=True)

    if args.bound:
        jobs = [
            (_unique_name(os.path.join(dirpath, f[: -len(".pdb")]), args.input_dir),
             os.path.join(dirpath, f), None)
            for dirpath, _, files in os.walk(args.input_dir)
            for f in sorted(files) if f.endswith(".pdb")
        ]
    else:
        jobs = find_pairs(args.input_dir)
    if not jobs:
        print("no input complexes found", file=sys.stderr)
        return 1

    from deepinteract_tpu_torch.data import analysis
    from deepinteract_tpu_torch.data.io import complex_lengths_from_file

    kept: List[Tuple[str, int, int]] = []  # (rel npz name, n1, n2)
    t0 = time.time()
    for i, (name, left, right) in enumerate(jobs):
        out = os.path.join(processed, f"{name}.npz")
        rel = f"{name}.npz"
        if os.path.exists(out) and not args.overwrite:
            kept.append((rel, *complex_lengths_from_file(out)))
            continue
        try:
            if args.bound:
                raw = convert_bound_complex_to_pair(
                    left, args.chain1, args.chain2, output_npz=None,
                    knn=args.knn, geo_nbrhd_size=args.geo_nbrhd_size,
                    seed=args.seed,
                )
            else:
                raw = convert_pdb_pair_to_complex(
                    left, right, output_npz=None,
                    knn=args.knn, geo_nbrhd_size=args.geo_nbrhd_size,
                    seed=args.seed, complex_name=name,
                )
        except Exception as exc:
            print(f"[{i + 1}/{len(jobs)}] {name}: SKIPPED ({exc})", file=sys.stderr)
            continue
        n1 = raw["graph1"]["node_feats"].shape[0]
        n2 = raw["graph2"]["node_feats"].shape[0]
        from deepinteract_tpu_torch.data.io import save_complex_npz

        os.makedirs(os.path.dirname(out), exist_ok=True)
        save_complex_npz(out, raw["graph1"], raw["graph2"], raw["examples"],
                         complex_name=name)
        kept.append((rel, n1, n2))
        print(f"[{i + 1}/{len(jobs)}] {name}: {n1}x{n2} residues, "
              f"{int(raw['examples'][:, 2].sum())} contacts", file=sys.stderr)

    # One split implementation for the whole framework: the reference's
    # size-filter + 80/20 + 25%-val partition (analysis.partition_filenames,
    # partition_dataset_filenames.py:44-110). --no_size_filter keeps
    # over-limit complexes (the tiled decoder can train on them).
    no_filter = args.no_size_filter
    splits = analysis.partition_filenames(
        kept, seed=args.seed,
        max_residues=10 ** 9 if no_filter else constants.RESIDUE_COUNT_LIMIT,
        max_pairs=10 ** 18 if no_filter else None,
    )
    analysis.write_split_files(args.output_dir, splits)
    n_split = sum(len(v) for v in splits.values())
    if n_split < len(kept):
        print(f"size filter dropped {len(kept) - n_split} complex(es) from "
              f"the splits (npz files kept on disk)", file=sys.stderr)
    print(f"built {len(kept)} complexes ({n_split} in splits) into "
          f"{args.output_dir} in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
