"""The indexed query funnel: encode query -> pre-filter -> decode top-M.

Port of ``deepinteract_tpu/index/funnel.py``.

One :class:`IndexedQueryRunner` turns "what does this chain bind?" into
a ranked-partner list against a :class:`~deepinteract_tpu_torch.index.format.
ChainIndex`, paying the docking-funnel cost shape: ONE encoder pass for
the query (zero when the query is index-resident), one GEMV over pooled
embeddings for the whole library, and decode micro-batches over only
the top-M pre-filter survivors.

Decode dispatch mirrors ``screening/runner.py`` exactly — canonical
``bucket1 <= bucket2`` orientation, power-of-two slot padding, the same
decode graphs — so an index query and a live screen share the engine's
inventory. The ``di_index_pairs_decoded_total``
counter (and per-result ``pairs_decoded``) is the testable proof that
the decoder runs on survivors only, never the full library.

Deadline semantics: the serving path (``on_deadline="partial"``) flushes
what is already ranked with ``partial=True`` at the next batch boundary
instead of burning the budget's corpse; CLI paths keep the raising
behavior (their work is not latency-bound).
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepinteract_tpu_torch.index.prefilter import pooled_embedding, prefilter
from deepinteract_tpu_torch.obs import metrics as obs_metrics
from deepinteract_tpu_torch.obs import spans as obs_spans
from deepinteract_tpu_torch.screening.embcache import EmbeddingCache
from deepinteract_tpu_torch.screening.library import ChainEntry, ChainLibrary
from deepinteract_tpu_torch.screening.manifest import pair_id
from deepinteract_tpu_torch.screening.runner import (
    ScreenConfig,
    ScreenRunner,
    _slots,
)
from deepinteract_tpu_torch.screening.scoring import pair_summary, rank_records
from deepinteract_tpu_torch.serving.admission import (
    DeadlineExceeded,
    expired_counter,
)

_QUERIES = obs_metrics.counter(
    "di_index_queries_total", "Ranked-partner queries served")
_DECODED = obs_metrics.counter(
    "di_index_pairs_decoded_total",
    "Pre-filter survivors decoded by index queries (the funnel neck)")
_DECODE_BATCHES = obs_metrics.counter(
    "di_index_decode_batches_total", "Index-query decode dispatches")
_PARTIAL = obs_metrics.counter(
    "di_index_partial_results_total",
    "Index queries flushed partially at deadline expiry")


@dataclasses.dataclass(frozen=True)
class QueryConfig:
    """Funnel knobs (CLI surface: ``cli/query.py``)."""

    top_m: int = 32        # pre-filter survivors fed to the decoder
    top_k: int = 10        # contacts kept per pair summary
    decode_batch: int = 8  # survivor pairs per decode dispatch


@dataclasses.dataclass
class QueryResult:
    """One ranked-partner query's outcome."""

    query: str
    records: List[Dict]      # decode-ranked survivors (rank_records)
    prefilter_ranked: List[Dict]  # survivors in prefilter order
    candidates: int          # chains scanned by the prefilter
    survivors: int
    pairs_decoded: int
    decode_batches: int
    encodes_executed: int
    partial: bool
    encode_seconds: float
    decode_seconds: float

    @property
    def prefilter_survivor_frac(self) -> float:
        return self.survivors / max(1, self.candidates)

    def summary(self) -> Dict:
        return {
            "candidates": self.candidates,
            "survivors": self.survivors,
            "pairs_decoded": self.pairs_decoded,
            "decode_batches": self.decode_batches,
            "encodes_executed": self.encodes_executed,
            "prefilter_survivor_frac": round(
                self.prefilter_survivor_frac, 4),
            "partial": self.partial,
            "encode_seconds": round(self.encode_seconds, 3),
            "decode_seconds": round(self.decode_seconds, 3),
        }


class IndexedQueryRunner:
    """Schedules ranked-partner queries over a resident engine + index.

    Refuses to run when the index was built under different weights
    than the engine serves (the sidecar-backed ``weights_signature``
    check) unless ``allow_stale`` — a stale ranking is worse than a
    refused one."""

    def __init__(self, engine, index,
                 cfg: QueryConfig = QueryConfig(),
                 cache: Optional[EmbeddingCache] = None,
                 allow_stale: bool = False):
        self.engine = engine
        self.index = index
        self.cfg = cfg
        self._runner = ScreenRunner(
            engine, cache=cache,
            cfg=ScreenConfig(top_k=cfg.top_k,
                             decode_batch=cfg.decode_batch,
                             encode_batch=cfg.decode_batch))
        if not allow_stale and (index.weights_signature
                                != engine.weights_signature()):
            raise ValueError(
                f"stale index: built under weights "
                f"{index.weights_signature!r} but the engine serves "
                f"{engine.weights_signature()!r} (rebuild the index or "
                f"pass allow_stale)")

    # -- query embedding sources ------------------------------------------

    def query_from_raw(self, chain_id: str, raw: Dict[str, np.ndarray],
                       **kw) -> QueryResult:
        """Query with a chain supplied as a raw graph (one encoder
        pass, embedding-cache backed)."""
        n = int(raw["node_feats"].shape[0])
        lib = ChainLibrary([ChainEntry(chain_id, raw, n)])
        t0 = time.perf_counter()
        with obs_spans.span("index_query_encode", chains=1):
            emb, executed, _, _ = self._runner.ensure_embeddings(
                lib, [chain_id], deadline=kw.get("deadline"))
        feats, nq, bq = emb[chain_id]
        return self._query(chain_id, feats, nq, bq,
                           encode_seconds=time.perf_counter() - t0,
                           encodes_executed=executed, **kw)

    def query_from_index(self, chain_id: str, **kw) -> QueryResult:
        """Query with an index-resident chain: zero encoder passes."""
        feats, nq, bq = self.index.chain_feats(chain_id)
        return self._query(chain_id, feats, nq, bq,
                           encode_seconds=0.0, encodes_executed=0, **kw)

    # -- the funnel --------------------------------------------------------

    def _query(self, chain_id: str, q_feats: np.ndarray, nq: int,
               bq: int, encode_seconds: float, encodes_executed: int,
               partitions=None, deadline=None,
               on_deadline: str = "raise") -> QueryResult:
        if on_deadline not in ("raise", "partial"):
            raise ValueError(f"on_deadline must be 'raise' or 'partial',"
                             f" got {on_deadline!r}")
        _QUERIES.inc()
        q_vec = pooled_embedding(q_feats, nq)
        survivors, candidates = prefilter(
            self.index, q_vec, self.cfg.top_m, partitions=partitions,
            exclude=(chain_id,))

        # Group survivors by decode signature, canonical b1 <= b2 with
        # chain-id tie-break on equal buckets — the exact orientation
        # ScreenRunner.screen uses (swap only on strictly greater
        # bucket, enumeration order otherwise). The decoder is not
        # bit-symmetric under swapping its arguments, so matching the
        # screen's orientation is what makes funnel and bulk-screen
        # scores byte-identical for the same pair.
        groups = defaultdict(list)  # (b1, b2, query_is_1) -> [survivor]
        for s in survivors:
            bc = s["bucket"]
            if bq < bc or (bq == bc and chain_id <= s["chain_id"]):
                groups[(bq, bc, True)].append(s)
            else:
                groups[(bc, bq, False)].append(s)

        records: List[Dict] = []
        decoded = 0
        decode_batches = 0
        partial = False
        t0 = time.perf_counter()
        with obs_spans.span("index_query_decode", survivors=len(survivors)):
            for (b1, b2, q_first), items in sorted(
                    groups.items(), key=lambda kv: kv[0][:2]):
                if partial:
                    break
                for lo in range(0, len(items), self.cfg.decode_batch):
                    if deadline is not None and deadline.expired:
                        expired_counter("index_query")
                        if on_deadline == "partial":
                            partial = True
                            _PARTIAL.inc()
                            break
                        raise DeadlineExceeded(
                            "index query deadline "
                            f"({deadline.budget_s * 1e3:.0f}ms) expired "
                            f"during decode ({decoded}/{len(survivors)} "
                            "survivors decoded)")
                    chunk = items[lo:lo + self.cfg.decode_batch]
                    slots = _slots(len(chunk), self.cfg.decode_batch)
                    rows = chunk + [chunk[0]] * (slots - len(chunk))
                    cand = [self.index.chain_feats(s["chain_id"])
                            for s in rows]
                    if q_first:
                        feats1 = np.stack([q_feats] * slots)
                        feats2 = np.stack([c[0] for c in cand])
                        n1s = [nq] * slots
                        n2s = [c[1] for c in cand]
                    else:
                        feats1 = np.stack([c[0] for c in cand])
                        feats2 = np.stack([q_feats] * slots)
                        n1s = [c[1] for c in cand]
                        n2s = [nq] * slots
                    mask1 = np.stack([np.arange(b1) < n for n in n1s])
                    mask2 = np.stack([np.arange(b2) < n for n in n2s])
                    args = (feats1, feats2, mask1, mask2)
                    entry = self.engine.decode_executable(b1, b2, slots, args)
                    probs = self.engine.replay_to_host(entry, *args)
                    for i, s in enumerate(chunk):
                        n1, n2 = n1s[i], n2s[i]
                        records.append({
                            # Canonical (sorted) pair id: the same pair
                            # names the same record whether it came from
                            # a query funnel or a bulk screen.
                            "pair_id": pair_id(
                                *sorted((chain_id, s["chain_id"]))),
                            "chain1": chain_id if q_first
                            else s["chain_id"],
                            "chain2": s["chain_id"] if q_first
                            else chain_id,
                            "query": chain_id,
                            "partner": s["chain_id"],
                            "n1": n1, "n2": n2, "bucket": [b1, b2],
                            "prefilter_score": s["score"],
                            "partition_id": s["partition_id"],
                            **pair_summary(probs[i, :n1, :n2],
                                           self.cfg.top_k),
                        })
                    decoded += len(chunk)
                    decode_batches += 1
                    _DECODED.inc(len(chunk))
                    _DECODE_BATCHES.inc()
        return QueryResult(
            query=chain_id,
            records=rank_records(records),
            prefilter_ranked=survivors,
            candidates=candidates,
            survivors=len(survivors),
            pairs_decoded=decoded,
            decode_batches=decode_batches,
            encodes_executed=encodes_executed,
            partial=partial,
            encode_seconds=encode_seconds,
            decode_seconds=time.perf_counter() - t0)
