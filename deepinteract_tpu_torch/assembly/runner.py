"""The assembly runner: all C(k,2) pairs of one complex, encode-once.

Port of ``deepinteract_tpu/assembly/runner.py``.

Work plan for one assembly:

1. **Encode phase** — delegated to
   :meth:`ScreenRunner.ensure_embeddings`, so each UNIQUE chain pays
   exactly one encoder pass per embedding identity (content + bucket +
   weights + control flag + dtype) no matter how many pairs reference
   it; ``di_assembly_encodes_total`` counts the passes actually
   executed — the encode-once contract the tests assert.
2. **Decode phase** — the pair loop replicates ScreenRunner's decode
   scheduling EXACTLY (canonical bucket orientation incl. the
   strictly-greater swap, ``_slots`` power-of-two padding, first-row
   fill, sorted (b1, b2) group order), because the decoder is not
   bit-symmetric under argument swap: assembly per-pair scores must be
   byte-identical to a bulk screen of the same pairs. Unlike the
   screen, the full depadded ``[n1, n2]`` contact map is retained per
   pair (the assembly bundle persists them).
3. **Assembly** — records are ranked, calibrated when a fitted
   :class:`~deepinteract_tpu_torch.calibration.Calibrator` is attached (raw
   scores always preserved alongside), thresholded into the interface
   graph, and reduced to the complex-level interactability score. An
   optional control pass re-scores every pair with zeroed node/edge
   features (the ``input_indep`` control) so the result
   carries its honesty baseline.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepinteract_tpu_torch.obs import metrics as obs_metrics
from deepinteract_tpu_torch.obs import spans as obs_spans
from deepinteract_tpu_torch.screening.embcache import EmbeddingCache
from deepinteract_tpu_torch.screening.library import ChainEntry
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

ASSEMBLY_BUNDLE_KIND = "assembly-bundle"  # sidecar kind (the JAX fsck dispatches on it)

_RUNS = obs_metrics.counter(
    "di_assembly_runs_total", "Assemblies scored")
_CHAINS = obs_metrics.counter(
    "di_assembly_chains_total", "Unique chains entering assemblies")
_ENCODES = obs_metrics.counter(
    "di_assembly_encodes_total",
    "Encoder passes executed by assemblies (unique-chain cache misses)")
_ENCODE_HITS = obs_metrics.counter(
    "di_assembly_encode_cache_hits_total",
    "Assembly chains served straight from the embedding cache")
_PAIRS = obs_metrics.counter(
    "di_assembly_pairs_scored_total", "Assembly chain pairs decoded")
_DECODE_BATCHES = obs_metrics.counter(
    "di_assembly_decode_batches_total",
    "Coalesced assembly decode dispatches")


@dataclasses.dataclass(frozen=True)
class AssemblyConfig:
    """Runner knobs (CLI surface: ``cli/assemble.py``)."""

    top_k: int = 10            # contacts kept per pair summary
    decode_batch: int = 8      # pairs per decode dispatch
    encode_batch: int = 8      # chains per encoder dispatch
    edge_threshold: float = 0.5  # interface-graph edge cut (on the
    # calibrated score when a calibrator is attached, raw otherwise)
    control: bool = True       # also score the input_indep control pass
    keep_maps: bool = True     # retain full [n1, n2] maps per pair


@dataclasses.dataclass
class AssemblyResult:
    """One assembly's outcome. ``records`` are ranked best-first; raw
    ``score`` fields are byte-identical to a ScreenRunner screen of the
    same pairs, calibrated/control fields ride alongside."""

    records: List[Dict]
    maps: Dict[str, np.ndarray]       # pair_id -> raw [n1, n2] map
    chain_ids: List[str]
    chains: int
    pairs_total: int
    pairs_scored: int
    unique_encodes: int               # encoder passes actually executed
    encode_cache_hits: int
    encode_batches: int
    decode_batches: int
    interface: Dict                   # {"nodes": [...], "edges": [...]}
    interactability: float            # mean effective pair score
    control_score: Optional[float]    # input_indep baseline (None = off)
    calibrated: bool
    encode_seconds: float
    decode_seconds: float
    emb_cache: Dict

    def summary(self) -> Dict:
        return {
            "chains": self.chains,
            "pairs_total": self.pairs_total,
            "pairs_scored": self.pairs_scored,
            "unique_encodes": self.unique_encodes,
            "encode_cache_hits": self.encode_cache_hits,
            "decode_batches": self.decode_batches,
            "interface_edges": len(self.interface["edges"]),
            "interactability": round(self.interactability, 6),
            "control_score": (round(self.control_score, 6)
                              if self.control_score is not None else None),
            "calibrated": self.calibrated,
            "encode_seconds": round(self.encode_seconds, 3),
            "decode_seconds": round(self.decode_seconds, 3),
            "emb_cache_hit_rate": round(
                self.emb_cache.get("hit_rate", 0.0), 3),
        }


class _ZeroedLibrary:
    """Library view whose chains carry zeroed node/edge features — the
    input_indep control identity (distinct embedding-cache keys come
    from hashing the zeroed raw, so control embeddings never collide
    with the real ones)."""

    def __init__(self, library):
        self._library = library

    def __getitem__(self, chain_id: str) -> ChainEntry:
        e = self._library[chain_id]
        raw = dict(e.raw,
                   node_feats=np.zeros_like(e.raw["node_feats"]),
                   edge_feats=np.zeros_like(e.raw["edge_feats"]))
        return ChainEntry(e.chain_id, raw, e.n)


class AssemblyRunner:
    """Schedules one assembly over a resident engine + embedding cache
    (both shareable with ScreenRunner — same cache keys, same split-phase
    graphs, so a chain screened earlier costs zero encodes here)."""

    def __init__(self, engine, cache: Optional[EmbeddingCache] = None,
                 cfg: AssemblyConfig = AssemblyConfig(), calibrator=None):
        self.engine = engine
        self.cache = cache if cache is not None else EmbeddingCache()
        self.cfg = cfg
        self.calibrator = calibrator
        self._screen = ScreenRunner(
            engine, cache=self.cache,
            cfg=ScreenConfig(top_k=cfg.top_k,
                             decode_batch=cfg.decode_batch,
                             encode_batch=cfg.encode_batch))

    def assemble(self, library, chain_ids: Optional[Sequence[str]] = None,
                 deadline=None, trace_id: str = "") -> AssemblyResult:
        """Score every pair of ``chain_ids`` (default: the whole
        library, in library order). ``deadline`` is enforced at encode-
        and decode-batch boundaries (DeadlineExceeded — a synchronous
        assembly's budget)."""
        ids = list(chain_ids) if chain_ids else list(library.ids())
        if len(ids) < 2:
            raise ValueError(f"an assembly needs at least 2 chains, "
                             f"got {len(ids)}")
        if len(set(ids)) != len(ids):
            raise ValueError("assembly chain ids must be unique")
        pairs = [(ids[i], ids[j])
                 for i in range(len(ids)) for j in range(i + 1, len(ids))]
        trace_attrs = {"trace_id": trace_id} if trace_id else {}

        t0 = time.perf_counter()
        with obs_spans.span("assembly_encode", chains=len(ids),
                            **trace_attrs):
            emb, executed, hits, enc_batches = \
                self._screen.ensure_embeddings(library, sorted(ids),
                                               deadline=deadline)
        encode_s = time.perf_counter() - t0
        _CHAINS.inc(len(ids))
        _ENCODES.inc(executed)
        _ENCODE_HITS.inc(hits)

        t1 = time.perf_counter()
        records, maps, decode_batches = self._decode_pairs(
            emb, pairs, deadline=deadline, trace_attrs=trace_attrs)
        decode_s = time.perf_counter() - t1
        _PAIRS.inc(len(pairs))
        _DECODE_BATCHES.inc(decode_batches)
        _RUNS.inc()

        if self.calibrator is not None:
            for rec in records:
                cal_map = self.calibrator.apply(maps[rec["pair_id"]])
                cal = pair_summary(cal_map, self.cfg.top_k)
                rec["calibrated_score"] = cal["score"]
                rec["calibrated_max_prob"] = cal["max_prob"]
                for contact in rec["top_contacts"]:
                    contact["p_cal"] = round(float(self.calibrator.apply(
                        np.asarray(contact["p"]))), 6)
        records = rank_records(records)

        control_score = None
        if self.cfg.control:
            control_score = self._control_pass(library, pairs, records,
                                               deadline=deadline,
                                               trace_id=trace_id)

        def effective(rec: Dict) -> float:
            return rec.get("calibrated_score", rec["score"])

        edges = []
        for rec in records:
            if effective(rec) >= self.cfg.edge_threshold:
                edge = {"chain1": rec["chain1"], "chain2": rec["chain2"],
                        "pair_id": rec["pair_id"],
                        "score": rec["score"]}
                if "calibrated_score" in rec:
                    edge["calibrated_score"] = rec["calibrated_score"]
                edges.append(edge)
        interface = {"nodes": ids, "edges": edges}
        interactability = float(np.mean([effective(r) for r in records]))

        if not self.cfg.keep_maps:
            maps = {}
        return AssemblyResult(
            records=records,
            maps=maps,
            chain_ids=ids,
            chains=len(ids),
            pairs_total=len(pairs),
            pairs_scored=len(pairs),
            unique_encodes=executed,
            encode_cache_hits=hits,
            encode_batches=enc_batches,
            decode_batches=decode_batches,
            interface=interface,
            interactability=interactability,
            control_score=control_score,
            calibrated=self.calibrator is not None,
            encode_seconds=encode_s,
            decode_seconds=decode_s,
            emb_cache=self.cache.stats(),
        )

    # -- decode loop (ScreenRunner-parity scheduling) ----------------------

    def _decode_pairs(self, emb, pairs, deadline=None, trace_attrs=None,
                      ) -> Tuple[List[Dict], Dict[str, np.ndarray], int]:
        # Canonical orientation: bucket1 <= bucket2, swapping ONLY on
        # strictly greater — identical to ScreenRunner.screen, which is
        # what makes the per-pair summaries byte-identical.
        groups = defaultdict(list)  # (b1, b2) -> [(pid, c1, c2)]
        for c1, c2 in pairs:
            pid = pair_id(c1, c2)
            if emb[c1][2] > emb[c2][2]:
                c1, c2 = c2, c1
            groups[(emb[c1][2], emb[c2][2])].append((pid, c1, c2))

        records: List[Dict] = []
        maps: Dict[str, np.ndarray] = {}
        decode_batches = 0
        with obs_spans.span("assembly_decode", pairs=len(pairs),
                            **(trace_attrs or {})):
            for (b1, b2), items in sorted(groups.items()):
                for lo in range(0, len(items), self.cfg.decode_batch):
                    if deadline is not None and deadline.expired:
                        expired_counter("assembly")
                        raise DeadlineExceeded(
                            "assembly deadline "
                            f"({deadline.budget_s * 1e3:.0f}ms) expired "
                            f"during decode ({len(records)}/{len(pairs)} "
                            "pairs scored)")
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
                        depadded = probs[i, :n1, :n2]
                        records.append({
                            "pair_id": pid,
                            "chain1": c1, "chain2": c2,
                            "n1": n1, "n2": n2,
                            "bucket": [b1, b2],
                            **pair_summary(depadded, self.cfg.top_k),
                        })
                        maps[pid] = np.array(depadded)
                    decode_batches += 1
        return records, maps, decode_batches

    # -- input_indep control ----------------------------------------------

    def _control_pass(self, library, pairs, records, deadline=None,
                      trace_id: str = "") -> float:
        """Score the same oriented pairs with zeroed input features and
        annotate each record with its per-pair ``control_score``. The
        return value is the complex-level control mean — what an input-
        independent model claims about this assembly; a real prediction
        should separate from it. (When the ENGINE itself runs with
        cfg.input_indep, main and control passes coincide by design.)"""
        result = self._screen.screen(_ZeroedLibrary(library), list(pairs),
                                     trace_id=trace_id, deadline=deadline)
        by_pid = {r["pair_id"]: r["score"] for r in result.records}
        for rec in records:
            rec["control_score"] = round(by_pid[rec["pair_id"]], 6)
        return float(np.mean(list(by_pid.values())))
