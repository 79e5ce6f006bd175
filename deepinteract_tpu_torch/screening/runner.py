"""The screen runner: pair scheduler over the split-phase graphs.

Port of ``deepinteract_tpu/screening/runner.py``. Work plan for one
screen (all-vs-all or query-vs-library):

1. **Encode phase** — unique chains are grouped by (chain bucket, shape
   signature), batched, and pushed through the engine's encode entry (a
   CUDA graph per key on the card, ``serving/graphs.py``, with K1 in
   every GT layer); every embedding lands in the content-addressed
   :class:`~deepinteract_tpu_torch.screening.embcache.EmbeddingCache`, so each
   chain is encoded at most once per screen (and zero times when a
   previous screen or a killed run already cached it).
2. **Decode phase** — pairs are grouped by (bucket1, bucket2), micro-
   batched to the decode entry over stacked cached embeddings, and
   summarized to a scalar ranking score
   (:func:`~deepinteract_tpu_torch.screening.scoring.pair_summary`).
3. **Checkpointing** — the manifest is flushed atomically after every
   decode batch; a :class:`PreemptionGuard` request stops the screen
   at the next batch boundary with everything scored so far durable, and
   a rerun completes the remaining pairs exactly once.

The naive alternative — ``engine.predict`` per pair — re-encodes every
chain O(N) times; the split-phase path pays N encoder passes for N^2
decodes (``chip_smoke.py`` phase 10 times both on the card).

Every entry's output is copied to the host under the engine's exec lock
(``InferenceEngine.replay_to_host``): all graphs share one memory pool,
so an output is valid only until the next replay of any key.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepinteract_tpu_torch.data.graph import pad_graph, stack_graphs
from deepinteract_tpu_torch.obs import metrics as obs_metrics
from deepinteract_tpu_torch.obs import spans as obs_spans
from deepinteract_tpu_torch.screening.embcache import EmbeddingCache, chain_hash
from deepinteract_tpu_torch.screening.library import ChainLibrary
from deepinteract_tpu_torch.screening.manifest import ScreenManifest, pair_id
from deepinteract_tpu_torch.screening.scoring import pair_summary, rank_records
from deepinteract_tpu_torch.serving.admission import DeadlineExceeded, expired_counter

_ENCODED = obs_metrics.counter(
    "di_screen_encoded_chains_total",
    "Chain encoder passes executed by screens (cache misses)")
_ENCODE_BATCHES = obs_metrics.counter(
    "di_screen_encode_batches_total", "Coalesced encoder dispatches")
_PAIRS = obs_metrics.counter(
    "di_screen_pairs_scored_total", "Chain pairs decoded and scored")
_DECODE_BATCHES = obs_metrics.counter(
    "di_screen_decode_batches_total", "Coalesced decode dispatches")
_PREEMPTIONS = obs_metrics.counter(
    "di_screen_preemptions_total",
    "Screens stopped early by a preemption request")


@dataclasses.dataclass(frozen=True)
class ScreenConfig:
    """Runner knobs (CLI surface: ``cli/screen.py``)."""

    top_k: int = 10            # contacts kept per pair summary
    decode_batch: int = 8      # pairs per decode dispatch
    encode_batch: int = 8      # chains per encoder dispatch


@dataclasses.dataclass
class ScreenResult:
    """One run's outcome; ``records`` covers the WHOLE screen (resumed
    pairs included), counters cover only this run."""

    records: List[Dict]
    pairs_total: int
    pairs_scored: int
    pairs_resumed: int
    chains: int
    encodes_executed: int
    encode_cache_hits: int
    encode_batches: int
    decode_batches: int
    preempted: bool
    resumed: bool
    encode_seconds: float
    decode_seconds: float
    emb_cache: Dict

    @property
    def encode_reuse_ratio(self) -> float:
        """Embedding uses per encoder pass: 2 per scored pair, amortized
        over the encodes actually executed (the naive per-pair loop is
        pinned at 1.0 by construction)."""
        uses = 2 * self.pairs_scored
        return uses / max(1, self.encodes_executed)

    def summary(self) -> Dict:
        return {
            "pairs_total": self.pairs_total,
            "pairs_scored": self.pairs_scored,
            "pairs_resumed": self.pairs_resumed,
            "chains": self.chains,
            "encodes_executed": self.encodes_executed,
            "encode_cache_hits": self.encode_cache_hits,
            "encode_reuse_ratio": round(self.encode_reuse_ratio, 2),
            "decode_batches": self.decode_batches,
            "preempted": self.preempted,
            "resumed": self.resumed,
            "encode_seconds": round(self.encode_seconds, 3),
            "decode_seconds": round(self.decode_seconds, 3),
            "emb_cache_hit_rate": round(self.emb_cache.get("hit_rate", 0.0),
                                        3),
        }


def _slots(n: int, cap: int) -> int:
    """Next power-of-two batch size, capped — the engine's batch-inventory
    policy (``InferenceEngine._batch_slots``) applied to a caller-chosen
    cap so encode/decode inventories stay O(log cap) per bucket."""
    return min(1 << (max(1, n) - 1).bit_length(), max(1, cap))


class ScreenRunner:
    """Schedules one or more screens over a resident engine + embedding
    cache. Thread-compatible with the engine's /predict traffic: encode and
    decode dispatches go straight to the engine's entries under its exec
    lock, never through the micro-batch scheduler."""

    def __init__(self, engine, cache: Optional[EmbeddingCache] = None,
                 cfg: ScreenConfig = ScreenConfig()):
        self.engine = engine
        # Explicit None check: an EMPTY EmbeddingCache is falsy (__len__),
        # and `cache or ...` would silently replace the caller's shared
        # cache with a private one.
        self.cache = cache if cache is not None else EmbeddingCache()
        self.cfg = cfg

    # -- per-chain helpers -------------------------------------------------

    def _chain_key(self, entry, bucket: int) -> str:
        """Embedding identity: chain content + bucket + everything else
        the encoder output depends on (weights, control flag, dtype)."""
        return chain_hash(entry.raw, extra=(
            "emb", bucket, self.engine.weights_signature(),
            self.engine.cfg.input_indep,
            self.engine.model.cfg.gnn.compute_dtype))

    def _padded_graph(self, entry, bucket: int):
        raw = entry.raw
        if self.engine.cfg.input_indep:
            raw = dict(raw,
                       node_feats=np.zeros_like(raw["node_feats"]),
                       edge_feats=np.zeros_like(raw["edge_feats"]))
        return pad_graph(raw, bucket)

    @staticmethod
    def _chain_sig(raw: Dict[str, np.ndarray]) -> Tuple[int, int, int, int]:
        return (int(raw["nbr_idx"].shape[1]),
                int(raw["src_nbr_eids"].shape[2]),
                int(raw["node_feats"].shape[1]),
                int(raw["edge_feats"].shape[2]))

    # -- encode phase ------------------------------------------------------

    def ensure_embeddings(self, library: ChainLibrary,
                          chain_ids: Sequence[str],
                          deadline=None):
        """Encode every chain in ``chain_ids`` not already cached.
        Returns (chain_id -> (feats, n, bucket), encodes_executed,
        cache_hits, encode_batches). Chains of equal content (one cache
        key) share one encode, also within a call: the JAX runner encodes
        each id that missed the cache, the port each missing key.
        ``deadline`` (a ``serving.admission.Deadline``) is checked before
        each encoder dispatch — an expired budget raises
        :class:`DeadlineExceeded` instead of burning more device work for
        a client that gave up."""
        out: Dict[str, Tuple[np.ndarray, int, int]] = {}
        todo = defaultdict(list)  # (bucket, sig) -> [(key, entry, [ids])]
        pending: Dict[str, List[str]] = {}  # key -> the ids it answers
        hits = 0
        for cid in chain_ids:
            entry = library[cid]
            bucket = self.engine.chain_bucket(entry.n)
            key = self._chain_key(entry, bucket)
            if key in pending:
                pending[key].append(cid)
                continue
            cached = self.cache.get(key)
            if cached is not None:
                out[cid] = (cached[0], cached[1], bucket)
                hits += 1
            else:
                pending[key] = [cid]
                todo[(bucket, self._chain_sig(entry.raw))].append(
                    (key, entry, pending[key]))
        executed = 0
        batches = 0
        for (bucket, sig), items in sorted(todo.items(),
                                           key=lambda kv: kv[0][:1]):
            for lo in range(0, len(items), self.cfg.encode_batch):
                if deadline is not None and deadline.expired:
                    expired_counter("screen")
                    raise DeadlineExceeded(
                        f"screen deadline ({deadline.budget_s * 1e3:.0f}ms)"
                        f" expired during encode ({executed} chains done)")
                chunk = items[lo:lo + self.cfg.encode_batch]
                slots = _slots(len(chunk), self.cfg.encode_batch)
                graphs = [self._padded_graph(e, bucket)
                          for _, e, _ in chunk]
                graphs.extend([graphs[0]] * (slots - len(chunk)))
                graph_batch = stack_graphs(graphs)
                graph_entry = self.engine.encode_executable(
                    bucket, sig, slots, graph_batch)
                feats = self.engine.replay_to_host(graph_entry, graph_batch)
                for i, (key, entry, cids) in enumerate(chunk):
                    self.cache.put(key, feats[i], entry.n)
                    for cid in cids:
                        out[cid] = (feats[i], entry.n, bucket)
                executed += len(chunk)
                batches += 1
                _ENCODED.inc(len(chunk))
                _ENCODE_BATCHES.inc()
        return out, executed, hits, batches

    # -- full screen -------------------------------------------------------

    def screen(
        self,
        library: ChainLibrary,
        pairs: Sequence[Tuple[str, str]],
        manifest: Optional[ScreenManifest] = None,
        guard=None,
        after_batch: Optional[Callable[[int], None]] = None,
        trace_id: str = "",
        deadline=None,
    ) -> ScreenResult:
        """Score ``pairs`` (chain-id tuples); see module docstring.

        ``guard`` is a PreemptionGuard (or any object with a
        ``requested`` flag) polled at decode-batch boundaries.
        ``after_batch(num_batches)`` is a test hook (fault injection).
        ``trace_id`` (request-scoped tracing, obs/reqtrace.py) labels
        this screen's span events so one id connects the HTTP response,
        ``events.jsonl``, and the phase histograms. ``deadline`` (a
        ``serving.admission.Deadline``; a synchronous screen's budget)
        is enforced at encode- and decode-batch boundaries —
        expiry raises :class:`DeadlineExceeded` (manifest-backed CLI
        screens keep using ``guard`` + resume instead: their half-done
        work is durable, a synchronous HTTP screen's is not)."""
        trace_attrs = {"trace_id": trace_id} if trace_id else {}
        resumed_pairs = 0
        resumed = False
        if manifest is not None:
            before = len(pairs)
            pairs = manifest.remaining(pairs)
            resumed_pairs = before - len(pairs)
            resumed = resumed_pairs > 0

        needed = sorted({cid for p in pairs for cid in p})
        t0 = time.perf_counter()
        with obs_spans.span("screen_encode", chains=len(needed),
                            **trace_attrs):
            emb, executed, enc_hits, enc_batches = self.ensure_embeddings(
                library, needed, deadline=deadline)
        encode_s = time.perf_counter() - t0

        # Pairs are oriented so bucket1 <= bucket2: the top-k summary is
        # transpose-invariant, and canonical orientation halves the
        # decode-executable inventory for asymmetric libraries. The
        # recorded chain1/chain2 match the orientation actually decoded.
        groups = defaultdict(list)  # (b1, b2) -> [(pid, c1, c2)]
        for c1, c2 in pairs:
            pid = pair_id(c1, c2)
            if emb[c1][2] > emb[c2][2]:
                c1, c2 = c2, c1
            groups[(emb[c1][2], emb[c2][2])].append((pid, c1, c2))

        scored = 0
        decode_batches = 0
        preempted = False
        run_records: List[Dict] = []
        t0 = time.perf_counter()
        with obs_spans.span("screen_decode", pairs=len(pairs),
                            **trace_attrs):
            for (b1, b2), items in sorted(groups.items()):
                if preempted:
                    break
                for lo in range(0, len(items), self.cfg.decode_batch):
                    if guard is not None and getattr(guard, "requested",
                                                     False):
                        preempted = True
                        _PREEMPTIONS.inc()
                        break
                    if deadline is not None and deadline.expired:
                        expired_counter("screen")
                        raise DeadlineExceeded(
                            "screen deadline "
                            f"({deadline.budget_s * 1e3:.0f}ms) expired "
                            f"during decode ({scored}/{len(pairs)} pairs "
                            "scored)")
                    chunk = items[lo:lo + self.cfg.decode_batch]
                    slots = _slots(len(chunk), self.cfg.decode_batch)
                    rows = chunk + [chunk[0]] * (slots - len(chunk))
                    feats1 = np.stack([emb[c1][0] for _, c1, _ in rows])
                    feats2 = np.stack([emb[c2][0] for _, _, c2 in rows])
                    mask1 = np.stack([np.arange(b1) < emb[c1][1]
                                      for _, c1, _ in rows])
                    mask2 = np.stack([np.arange(b2) < emb[c2][1]
                                      for _, _, c2 in rows])
                    args = (feats1, feats2, mask1, mask2)
                    entry = self.engine.decode_executable(b1, b2, slots, args)
                    probs = self.engine.replay_to_host(entry, *args)
                    for i, (pid, c1, c2) in enumerate(chunk):
                        n1, n2 = emb[c1][1], emb[c2][1]
                        record = {
                            "pair_id": pid,
                            "chain1": c1, "chain2": c2,
                            "n1": n1, "n2": n2,
                            "bucket": [b1, b2],
                            **pair_summary(probs[i, :n1, :n2],
                                           self.cfg.top_k),
                        }
                        run_records.append(record)
                        if manifest is not None:
                            manifest.mark_done(pid, record)
                    scored += len(chunk)
                    decode_batches += 1
                    _PAIRS.inc(len(chunk))
                    _DECODE_BATCHES.inc()
                    if manifest is not None:
                        # Atomic per-batch checkpoint: a kill after this
                        # line never re-scores the batch; a kill before
                        # it re-scores at most one batch, but only into a
                        # manifest that never recorded it — exactly-once
                        # COMPLETION either way.
                        manifest.flush()
                    if after_batch is not None:
                        after_batch(decode_batches)
        decode_s = time.perf_counter() - t0

        if manifest is not None:
            # The manifest's ledger covers resumed pairs too, so a
            # resumed run's ranked output spans the WHOLE screen.
            manifest.flush()
            records = rank_records(manifest.records())
        else:
            records = rank_records(run_records)
        return ScreenResult(
            records=records,
            pairs_total=len(pairs) + resumed_pairs,
            pairs_scored=scored,
            pairs_resumed=resumed_pairs,
            chains=len(needed),
            encodes_executed=executed,
            encode_cache_hits=enc_hits,
            encode_batches=enc_batches,
            decode_batches=decode_batches,
            preempted=preempted,
            resumed=resumed,
            encode_seconds=encode_s,
            decode_seconds=decode_s,
            emb_cache=self.cache.stats(),
        )
