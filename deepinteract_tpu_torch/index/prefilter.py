"""Embedding-space pre-filter: the mouth of the docking funnel.

Port of ``deepinteract_tpu/index/prefilter.py``.

Ranks every indexed chain against a query with one matrix-vector
product over cached pooled embeddings, so the expensive contact decoder
only ever sees the top-M survivors. The score is the cosine between
l2-normalized masked mean-pools of the encoder embeddings — a bilinear
form ``pool(q)^T pool(c)`` that is symmetric in its arguments, the same
transpose-invariance contract ``screening/scoring.py``'s
``pair_summary`` keeps for the full decode score (which chain is "1"
and which is "2" must never change a ranking).

Cost shape (the FlashAttention lesson applied at the storage tier):
the resident working set is ``[N, C]`` pooled vectors, the scan is one
GEMV, and only ``M << N`` chains pay the ``[bucket1 x bucket2]`` decode.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from deepinteract_tpu_torch.obs import metrics as obs_metrics

_PREFILTERED = obs_metrics.counter(
    "di_index_prefilter_chains_total",
    "Library chains ranked by the embedding-space pre-filter")


def pooled_embedding(feats: np.ndarray, n: int) -> np.ndarray:
    """l2-normalized masked mean-pool of one chain's padded embeddings
    (``feats [bucket, C]``, true length ``n``). Padding rows are
    excluded so two chains differing only in bucket pad agree."""
    n = max(1, min(int(n), feats.shape[0]))
    vec = np.asarray(feats[:n], np.float32).mean(axis=0)
    norm = float(np.linalg.norm(vec))
    if norm > 0.0:
        vec = vec / norm
    return vec


def bilinear_scores(query_vec: np.ndarray,
                    pooled: np.ndarray) -> np.ndarray:
    """Cosine scores of a ``[k, C]`` pooled block against the query
    vector — symmetric (score(q, c) == score(c, q)) by construction."""
    return np.asarray(pooled, np.float32) @ np.asarray(query_vec,
                                                       np.float32)


def prefilter(index, query_vec: np.ndarray, top_m: int,
              partitions: Optional[Iterable[str]] = None,
              exclude: Tuple[str, ...] = (),
              ) -> Tuple[List[Dict], int]:
    """Rank the selected partitions' chains against ``query_vec``.

    Returns (survivors, candidates): the top-``top_m`` chains as
    ``{"chain_id", "score", "partition_id", "row", "bucket", "n"}``
    dicts in deterministic ``(-score, chain_id)`` order, and the total
    number of candidates scanned (``exclude`` drops the query itself
    when it is index-resident). ``top_m <= 0`` means uncapped — every
    candidate survives, so per-partition rankings can be gathered into a
    globally exact one."""
    ranked: List[Dict] = []
    candidates = 0
    skip = set(exclude)
    for pid, chain_ids, lengths, pooled in index.iter_pooled(partitions):
        scores = bilinear_scores(query_vec, pooled)
        bucket = int(index.partition(pid)["bucket"])
        for row, cid in enumerate(chain_ids):
            if cid in skip:
                continue
            candidates += 1
            ranked.append({"chain_id": cid, "score": float(scores[row]),
                           "partition_id": pid, "row": row,
                           "bucket": bucket, "n": int(lengths[row])})
    ranked.sort(key=lambda r: (-r["score"], r["chain_id"]))
    _PREFILTERED.inc(candidates)
    if int(top_m) > 0:
        ranked = ranked[:int(top_m)]
    return ranked, candidates
