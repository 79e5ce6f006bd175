"""Per-complex evaluation metrics + median aggregation + CSV export.

Numpy copy of ``deepinteract_tpu/training/metrics.py``; the CSV is written
through :func:`atomic_write` below instead of ``robustness.artifacts``.

Reference semantics reproduced exactly:

* top-k precision/recall over pairs sorted by positive-class probability
  (``deepinteract_utils.py:977-995``): prec = (#true in top k) / k,
  recall = (#true in top k) / (#positives).
* The k grid {10, L//10, L//5} (precision) and {L, L//2, L//5} (recall),
  where **L = n1 + n2 during validation** (``deepinteract_modules.py:1946``)
  but **L = min(n1, n2) at test time** (``:2045``) — a reference discrepancy
  that is part of the published-metric contract, so we keep it.
* Binary metrics follow torchmetrics' multiclass ``average=None`` with the
  class-1 slot selected (``deepinteract_modules.py:1563-1579``): per-class
  "accuracy" is therefore the class-1 recall (a torchmetrics quirk the
  reference inherits), precision/recall/F1 are the usual class-1 one-vs-rest
  definitions, AUROC is one-vs-rest on the class-1 probability, and AUPRC is
  class-1 average precision. Predictions are thresholded at
  ``pos_prob_threshold`` (default 0.5, ``deepinteract_modules.py:1483``).
* Epoch aggregation is the **median over complexes** after a cross-device
  all-gather (``deepinteract_modules.py:1984-2016,2103-2165``); degenerate
  complexes (metrics undefined, e.g. AUROC with no negatives) contribute NaN
  and are skipped via nanmedian.
* Per-target CSV columns match ``test_epoch_end``
  (``deepinteract_modules.py:2130-2145``).

All of this runs on host (numpy): per-complex sorting of ~64K pairs is not
worth a device round-trip, and the reference likewise computes these on
unbatched per-complex tensors.
"""

from __future__ import annotations

import math
import os
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np


def atomic_write(path: str, text: str) -> None:
    """Write ``text`` to ``path`` through a temporary file in the same
    directory and a rename, so a reader never sees a torn file."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-", suffix=os.path.basename(path))
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def top_k_prec(sorted_indices: np.ndarray, labels: np.ndarray, k: int) -> float:
    """Reference ``calculate_top_k_prec`` (deepinteract_utils.py:977-984).
    Guard: the reference divides by k and would crash on k == 0 (chains
    shorter than 10 residues at L//10); we clamp k to 1."""
    k = max(int(k), 1)
    return float(labels[sorted_indices[:k]].sum()) / k


def top_k_recall(sorted_indices: np.ndarray, labels: np.ndarray, k: int) -> float:
    """Reference ``calculate_top_k_recall`` (deepinteract_utils.py:987-995).
    NaN when the complex has no positive labels (reference would divide by
    zero); skipped by nanmedian at aggregation."""
    k = max(int(k), 1)
    num_pos = float(labels.sum())
    if num_pos == 0:
        return float("nan")
    return float(labels[sorted_indices[:k]].sum()) / num_pos


def topk_suite(pos_probs: np.ndarray, labels: np.ndarray, l: int) -> Dict[str, float]:
    """The six top-k metrics over one complex's flattened pair list."""
    order = np.argsort(-pos_probs, kind="stable")
    return {
        "top_10_prec": top_k_prec(order, labels, 10),
        "top_l_by_10_prec": top_k_prec(order, labels, l // 10),
        "top_l_by_5_prec": top_k_prec(order, labels, l // 5),
        "top_l_recall": top_k_recall(order, labels, l),
        "top_l_by_2_recall": top_k_recall(order, labels, l // 2),
        "top_l_by_5_recall": top_k_recall(order, labels, l // 5),
    }


def binary_suite(
    pos_probs: np.ndarray, labels: np.ndarray, threshold: float = 0.5
) -> Dict[str, float]:
    """Class-1 acc/prec/recall/F1/AUROC/AUPRC for one complex."""
    labels = labels.astype(bool)
    pred_pos = pos_probs >= threshold
    tp = float(np.sum(pred_pos & labels))
    fp = float(np.sum(pred_pos & ~labels))
    n_pos = float(labels.sum())
    n_neg = float((~labels).sum())

    recall = tp / n_pos if n_pos else float("nan")
    prec = tp / (tp + fp) if (tp + fp) else 0.0
    f1 = 2 * prec * recall / (prec + recall) if (prec + recall) else 0.0
    return {
        "acc": recall,  # torchmetrics multiclass per-class accuracy == recall
        "prec": prec,
        "recall": recall,
        "f1": f1,
        "auroc": _auroc(pos_probs, labels, n_pos, n_neg),
        "auprc": _average_precision(pos_probs, labels, n_pos),
    }


def _auroc(pos_probs, labels, n_pos, n_neg) -> float:
    """Rank-based (Mann-Whitney U) AUROC; NaN when one class is absent."""
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(pos_probs, kind="stable")
    ranks = np.empty(len(pos_probs), dtype=np.float64)
    # Average ranks over ties.
    sorted_p = pos_probs[order]
    _, inv, counts = np.unique(sorted_p, return_inverse=True, return_counts=True)
    cum = np.cumsum(counts)
    avg_rank_per_group = cum - (counts - 1) / 2.0
    ranks[order] = avg_rank_per_group[inv]
    r_pos = ranks[labels].sum()
    return float((r_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _average_precision(pos_probs, labels, n_pos) -> float:
    """AP = sum_i (R_i - R_{i-1}) P_i over descending-probability order."""
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-pos_probs, kind="stable")
    hits = labels[order].astype(np.float64)
    cum_tp = np.cumsum(hits)
    precision = cum_tp / np.arange(1, len(hits) + 1)
    return float(np.sum(precision * hits) / n_pos)


def complex_metrics(
    pos_probs: np.ndarray,
    labels: np.ndarray,
    n1: int,
    n2: int,
    stage: str = "val",
    threshold: float = 0.5,
    ce: Optional[float] = None,
) -> Dict[str, float]:
    """All per-complex metrics for one (flattened) pair list.

    ``stage`` selects the reference's L convention: 'val' -> L = n1 + n2
    (deepinteract_modules.py:1946), 'test' -> L = min(n1, n2) (:2045).
    """
    l = (n1 + n2) if stage == "val" else min(n1, n2)
    out = topk_suite(pos_probs, labels, l)
    out.update(binary_suite(pos_probs, labels, threshold))
    if ce is not None:
        out["ce"] = float(ce)
    return out


def aggregate_median(per_complex: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """Median over complexes per metric (reference's ``med_*`` logging),
    NaN-skipping; ``ce`` is averaged (reference logs per-step ce with
    Lightning's default mean reduction)."""
    if not per_complex:
        return {}
    keys = per_complex[0].keys()
    out = {}
    for key in keys:
        vals = np.asarray([m[key] for m in per_complex], dtype=np.float64)
        if key == "ce":
            out[key] = float(np.nanmean(vals))
        else:
            out[f"med_{key}"] = float(np.nanmedian(vals)) if not np.all(np.isnan(vals)) else float("nan")
    return out


TOPK_CSV_COLUMNS = (
    "top_10_prec",
    "top_l_by_10_prec",
    "top_l_by_5_prec",
    "top_l_recall",
    "top_l_by_2_recall",
    "top_l_by_5_recall",
    "target",
)


def write_topk_csv(
    per_complex: Sequence[Dict[str, float]],
    targets: Sequence[str],
    path: str,
) -> None:
    """Per-target CSV matching the reference's ``*_top_metrics.csv``
    (deepinteract_modules.py:2130-2145): pandas-style with an index column."""
    lines = ["," + ",".join(TOPK_CSV_COLUMNS)]
    for i, (metrics, target) in enumerate(zip(per_complex, targets)):
        row = [str(i)]
        for col in TOPK_CSV_COLUMNS[:-1]:
            v = metrics.get(col, float("nan"))
            row.append(repr(v) if not math.isnan(v) else "")
        row.append(str(target))
        lines.append(",".join(row))
    atomic_write(path, "\n".join(lines) + "\n")


def gather_pair_predictions(probs: np.ndarray, examples: np.ndarray, example_mask: np.ndarray):
    """Extract (pos_probs, labels) for one complex from dense [L1, L2, 2]
    softmax output using its flattened (i, j, label) example list — the
    flat-index gather of ``deepinteract_modules.py:2030-2034``."""
    ex = examples[example_mask]
    pos_probs = probs[ex[:, 0], ex[:, 1], 1]
    return np.asarray(pos_probs), ex[:, 2].astype(np.int64)
