"""Dataset ops/analysis tooling: statistics, split partitioning, leakage.

Reference equivalents (SURVEY.md §1 Lx, §2.3):
  * dataset statistics   — ``builder/collect_dataset_statistics.py`` /
    ``log_dataset_statistics.py`` (dips_plus_utils.py:686-827)
  * split partitioner    — ``builder/partition_dataset_filenames.py`` (size
    filters + random 80/20 train/test with 25% of train as val)
  * sequence-identity / leakage audit — ``check_percent_identity``
    (deepinteract_utils.py:865-921) and ``misc/check_leakage.py:37-53``
  * length audit         — ``misc/check_length.py``

All operate on the npz complex tree (``data.io``); alignment-based identity
uses a simple O(nm) Needleman-Wunsch (the reference uses Bio.pairwise2
``globalxx`` — match=1, no mismatch/gap penalties — whose score equals the
LCS length, which is exactly what ``_global_align_score`` computes).

Port of ``deepinteract_tpu/data/analysis.py`` (the port imports nothing of the
JAX package); it writes and prints what the JAX one does.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepinteract_tpu_torch import constants
from deepinteract_tpu_torch.data.io import load_complex_npz


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------

def complex_statistics(raw: Dict) -> Dict[str, float]:
    """Per-complex stats row (reference ``collect_dataset_statistics``)."""
    n1 = raw["graph1"]["node_feats"].shape[0]
    n2 = raw["graph2"]["node_feats"].shape[0]
    examples = raw["examples"]
    num_pos = int(examples[:, 2].sum())
    return {
        "num_nodes_1": n1,
        "num_nodes_2": n2,
        "num_pairs": int(examples.shape[0]),
        "num_pos_contacts": num_pos,
        "pos_rate": num_pos / max(examples.shape[0], 1),
        "fits_residue_limit": int(
            n1 <= constants.RESIDUE_COUNT_LIMIT and n2 <= constants.RESIDUE_COUNT_LIMIT
        ),
    }


def collect_statistics(npz_paths: Sequence[str], csv_out: Optional[str] = None) -> Dict:
    rows = []
    for path in npz_paths:
        row = complex_statistics(load_complex_npz(path))
        row["target"] = os.path.splitext(os.path.basename(path))[0]
        rows.append(row)
    agg = {
        "num_complexes": len(rows),
        "num_valid_pairs": sum(r["fits_residue_limit"] for r in rows),
        "total_pos_contacts": sum(r["num_pos_contacts"] for r in rows),
        "median_n1": float(np.median([r["num_nodes_1"] for r in rows])) if rows else 0.0,
        "median_n2": float(np.median([r["num_nodes_2"] for r in rows])) if rows else 0.0,
    }
    if csv_out and rows:
        cols = [c for c in rows[0] if c != "target"]
        # di: allow[artifact-write] offline analysis report, regenerated by rerunning the scan
        with open(csv_out, "w") as f:
            f.write("target," + ",".join(cols) + "\n")
            for r in rows:
                f.write(r["target"] + "," + ",".join(str(r[c]) for c in cols) + "\n")
    return agg


# ---------------------------------------------------------------------------
# Split partitioning
# ---------------------------------------------------------------------------

def partition_filenames(
    names_and_lengths: Sequence[Tuple[str, int, int]],
    seed: int = 42,
    test_frac: float = 0.2,
    val_frac_of_train: float = 0.25,
    max_residues: int = constants.RESIDUE_COUNT_LIMIT,
    max_pairs: Optional[int] = None,
) -> Dict[str, List[str]]:
    """Size-filter + random split (reference
    ``builder/partition_dataset_filenames.py:44-110``: drops complexes whose
    chains exceed the residue limit or whose pair count exceeds 256^2, then
    80/20 train/test with 25% of train as val). ``max_pairs`` defaults to
    the reference's RESIDUE_COUNT_LIMIT^2 pair-area cap."""
    if max_pairs is None:
        max_pairs = constants.RESIDUE_COUNT_LIMIT ** 2
    eligible = [
        name for name, n1, n2 in names_and_lengths
        if n1 <= max_residues and n2 <= max_residues and n1 * n2 < max_pairs
    ]
    rng = random.Random(seed)
    rng.shuffle(eligible)
    n_test = int(len(eligible) * test_frac)
    test, trainval = eligible[:n_test], eligible[n_test:]
    n_val = int(len(trainval) * val_frac_of_train)
    val, train = trainval[:n_val], trainval[n_val:]
    return {"train": sorted(train), "val": sorted(val), "test": sorted(test)}


def write_split_files(root: str, splits: Dict[str, List[str]]) -> None:
    for mode, names in splits.items():
        # di: allow[artifact-write] offline dataset-build output, regenerated by rerunning the split
        with open(os.path.join(root, f"pairs-postprocessed-{mode}.txt"), "w") as f:
            f.write("\n".join(names) + ("\n" if names else ""))


# ---------------------------------------------------------------------------
# Sequence identity / leakage
# ---------------------------------------------------------------------------

_RES_TO_CHAR = {i: c for i, c in enumerate("WFKPDARCVTGSHLEYINMQ")}  # ALLOWABLE_RESNAMES order


def sequence_of(raw_graph: Dict) -> str:
    """1-letter sequence recovered from the residue-type one-hot block."""
    onehot = raw_graph["node_feats"][:, constants.NODE_RESNAME_ONE_HOT]
    idx = np.argmax(onehot, axis=1)
    known = onehot.sum(axis=1) > 0
    return "".join(_RES_TO_CHAR[int(i)] if k else "X" for i, k in zip(idx, known))


def _global_align_score(a: str, b: str) -> int:
    """Needleman-Wunsch with match=1, mismatch=0, gap=0 — equivalent to the
    LCS length, matching Bio.pairwise2.align.globalxx scoring used by the
    reference (deepinteract_utils.py:882-913; see module docstring)."""
    if not a or not b:
        return 0
    prev = np.zeros(len(b) + 1, dtype=np.int32)
    for ca in a:
        cur = np.zeros_like(prev)
        bs = np.frombuffer(b.encode(), dtype=np.uint8)
        match = (bs == ord(ca)).astype(np.int32)
        for j in range(1, len(b) + 1):
            cur[j] = max(prev[j], cur[j - 1], prev[j - 1] + match[j - 1])
        prev = cur
    return int(prev[-1])


def percent_identity(seq_a: str, seq_b: str) -> float:
    """Reference convention: alignment score / min(len_a, len_b)
    (check_percent_identity, deepinteract_utils.py:899-913)."""
    denom = min(len(seq_a), len(seq_b))
    if denom == 0:
        return 0.0
    return _global_align_score(seq_a, seq_b) / denom


def check_leakage(
    candidate_paths: Sequence[str],
    test_paths: Sequence[str],
    threshold: float = 0.3,
) -> List[Tuple[str, str, float]]:
    """Flag candidate complexes whose either chain exceeds ``threshold``
    identity with any test-set chain (reference misc/check_leakage.py:37-53,
    30% CD-HIT-style cutoff)."""
    test_seqs = []
    for path in test_paths:
        raw = load_complex_npz(path)
        test_seqs.append((os.path.basename(path), sequence_of(raw["graph1"])))
        test_seqs.append((os.path.basename(path), sequence_of(raw["graph2"])))
    leaks = []
    for path in candidate_paths:
        raw = load_complex_npz(path)
        for chain in (sequence_of(raw["graph1"]), sequence_of(raw["graph2"])):
            for test_name, test_seq in test_seqs:
                pid = percent_identity(chain, test_seq)
                if pid > threshold:
                    leaks.append((os.path.basename(path), test_name, pid))
                    break
            else:
                continue
            break
    return leaks


def length_audit(npz_paths: Sequence[str]) -> Dict[str, float]:
    """Chain-length distribution summary (reference misc/check_length.py)."""
    lengths = []
    for path in npz_paths:
        raw = load_complex_npz(path)
        lengths.append(raw["graph1"]["node_feats"].shape[0])
        lengths.append(raw["graph2"]["node_feats"].shape[0])
    arr = np.asarray(lengths) if lengths else np.zeros(1)
    return {
        "min": float(arr.min()),
        "median": float(np.median(arr)),
        "mean": float(arr.mean()),
        "max": float(arr.max()),
        "over_limit_frac": float((arr > constants.RESIDUE_COUNT_LIMIT).mean()),
    }
