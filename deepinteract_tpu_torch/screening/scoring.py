"""Per-pair summary scoring: one implementation, two consumers.

Port of ``deepinteract_tpu/screening/scoring.py`` (numpy).

Screening ranks candidate partners by a scalar per chain pair; the
predict CLI's ``--top_k`` flag reports the same ranked contacts for a
single complex. Both call :func:`pair_summary`, so the two outputs can
never disagree about what "top-k contact probability" means.

The score is the MEAN of the top-k contact probabilities: a single
spurious high pixel ranks below k consistent ones, while a genuinely
interacting pair (whose interface spans many residue pairs) saturates
the average — the standard interface-propensity summary for partner
retrieval.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def pair_summary(probs: np.ndarray, top_k: int = 10) -> Dict:
    """Ranked summary of a depadded ``[n1, n2]`` contact-probability map.

    Returns ``score`` (mean of the top-k probabilities — the ranking
    key), ``max_prob``, the effective ``top_k`` (clamped to the map
    size), and ``top_contacts`` as ``(i, j, p)`` triplets in descending
    probability order.
    """
    probs = np.asarray(probs)
    if probs.ndim != 2:
        raise ValueError(f"pair_summary wants a [n1, n2] map, got "
                         f"shape {probs.shape}")
    flat = probs.ravel()
    k = max(1, min(int(top_k), flat.size))
    idx = np.argpartition(flat, flat.size - k)[-k:]
    order = idx[np.argsort(flat[idx])[::-1]]
    n2 = probs.shape[1]
    contacts: List[Dict] = [
        {"i": int(f // n2), "j": int(f % n2), "p": round(float(flat[f]), 6)}
        for f in order
    ]
    return {
        "score": float(flat[order].mean()),
        "max_prob": float(flat[order[0]]),
        "top_k": k,
        "top_contacts": contacts,
    }


def rank_records(records: List[Dict]) -> List[Dict]:
    """Descending-score ordering with a deterministic tie-break on the
    pair id (stable across resumes and re-runs of the same library)."""
    return sorted(records,
                  key=lambda r: (-r["score"], r.get("pair_id", "")))
