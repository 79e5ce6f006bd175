"""Content-addressed per-chain embedding cache: encode once, decode many.

Port of ``deepinteract_tpu/screening/embcache.py``: the same keys (a
:func:`chain_hash` is the JAX digest for the same arrays and extras) and
the same spill files, so either package reads the other's spill.

A screened chain's encoder output is a pure function of its featurized
arrays, the padded bucket, and the served weights — so an exact content
hash is a sound cache key (the same argument ``serving/cache.py`` makes
for whole-complex results, one level down the split forward). The cache
holds the PADDED ``[bucket, C]`` float32 embedding plus the real length,
so a hit feeds the decode batch without any re-layout.

Two tiers:

* **in-memory LRU** — bounded by entry count; the working set of an
  all-vs-all screen is the library itself, so the default capacity covers
  thousands of chains before eviction matters;
* **optional on-disk npz spill** — entries evicted from memory are written
  to ``spill_dir`` (robustness/artifacts.py: atomic write + SHA-256
  integrity sidecar) and transparently reloaded on a later get, so a
  library larger than memory still encodes each chain once per screen,
  and a RESUMED screen (robustness/preemption.py) skips re-encoding
  everything the killed run already paid for. A spill read is VERIFIED
  before np.load ever parses it: a truncated or bit-flipped file is
  quarantined and served as a miss (the chain is re-encoded), never
  admitted as a silently wrong embedding; a payload whose sidecar hasn't
  landed yet (concurrent spill mid-write, or a kill between the two
  writes) is a plain miss and is healed whole by the next re-spill.
"""

from __future__ import annotations

import hashlib
import io
import os
import threading
from collections import OrderedDict
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np

from deepinteract_tpu_torch.data.io import GRAPH_KEYS
from deepinteract_tpu_torch.obs import metrics as obs_metrics
from deepinteract_tpu_torch.robustness import artifacts

SPILL_KIND = "embcache-spill"

_HITS = obs_metrics.counter(
    "di_screen_embedding_cache_hits_total",
    "Chain encodes skipped because the embedding was cached")
_MISSES = obs_metrics.counter(
    "di_screen_embedding_cache_misses_total",
    "Embedding-cache lookups that required an encoder pass")
_SPILLS = obs_metrics.counter(
    "di_screen_embedding_cache_spills_total",
    "Embeddings evicted from memory and written to the spill dir")


def chain_hash(raw_chain: Dict[str, np.ndarray], extra: Iterable = ()) -> str:
    """SHA-256 over one chain's model-visible arrays (the per-chain half
    of ``serving/cache.content_hash``). ``extra`` mixes in everything else
    the embedding depends on: bucket, weights identity, input_indep,
    compute dtype."""
    h = hashlib.sha256()
    for key in GRAPH_KEYS:
        a = np.ascontiguousarray(raw_chain[key])
        h.update(f"{key}:{a.dtype.str}:{a.shape}".encode())
        h.update(a.tobytes())
    for item in extra:
        h.update(repr(item).encode())
    return h.hexdigest()


class EmbeddingCache:
    """Thread-safe LRU of padded chain embeddings with optional disk spill.

    Values are ``(feats [bucket, C] float32, n real residues)``. Returned
    arrays are read-only views — the decode path stacks copies anyway, and
    a client mutating a cached embedding must fail loudly.
    """

    def __init__(self, capacity: int = 4096,
                 spill_dir: Optional[str] = None):
        self.capacity = int(capacity)
        self.spill_dir = spill_dir
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
            # A killed run's mid-flight spill leaves only an orphaned
            # tmp; its destination is whole or absent (atomic replace).
            artifacts.sweep_tmp(spill_dir, prefix="emb_")
        self._entries: "OrderedDict[str, Tuple[np.ndarray, int]]" = (
            OrderedDict())
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._spills = 0
        self._spill_hits = 0

    # -- key ---------------------------------------------------------------

    def _spill_path(self, key: str) -> str:
        return os.path.join(self.spill_dir, f"emb_{key}.npz")

    # -- access ------------------------------------------------------------

    def get(self, key: str) -> Optional[Tuple[np.ndarray, int]]:
        with self._lock:
            if self.capacity > 0 and key in self._entries:
                self._entries.move_to_end(key)
                self._hits += 1
                _HITS.inc()
                return self._entries[key]
        if self.spill_dir:
            path = self._spill_path(key)
            if os.path.exists(path):
                if not os.path.exists(artifacts.sidecar_path(path)):
                    # Payload landed but no sidecar YET: a concurrent
                    # _spill is between its two writes (or a kill landed
                    # there). A miss — NOT a quarantine of a healthy
                    # mid-write file; _spill heals the sidecar on the
                    # re-spill after this miss's re-encode.
                    with self._lock:
                        self._misses += 1
                    _MISSES.inc()
                    return None
                try:
                    # Integrity gate BEFORE the deserializer: without it,
                    # only np.load's format checks stood between a
                    # flipped bit and a wrong embedding — and a bit flip
                    # inside the float payload passes format checks.
                    raw = artifacts.verify_read(path, kind=SPILL_KIND)
                    with np.load(io.BytesIO(raw), allow_pickle=False) as z:
                        feats = np.asarray(z["feats"], dtype=np.float32)
                        n = int(z["n"])
                except (artifacts.ArtifactError, ValueError,
                        KeyError) as exc:
                    # Positive corruption (hash/length/sidecar mismatch)
                    # or verified-bytes-that-won't-deserialize (writer
                    # bug): quarantine and re-encode (a miss), never
                    # kill the screen or admit garbage.
                    if os.path.exists(path):
                        artifacts.quarantine(path, SPILL_KIND, str(exc))
                    with self._lock:
                        self._misses += 1
                    _MISSES.inc()
                    return None
                except OSError:
                    # TRANSIENT read failure (or the file vanished): a
                    # plain miss — the intact spill stays in place for
                    # the next attempt, no false corruption signal.
                    with self._lock:
                        self._misses += 1
                    _MISSES.inc()
                    return None
                feats.setflags(write=False)
                with self._lock:
                    self._hits += 1
                    self._spill_hits += 1
                _HITS.inc()
                self._admit(key, feats, n)
                return feats, n
        with self._lock:
            self._misses += 1
        _MISSES.inc()
        return None

    def put(self, key: str, feats: np.ndarray, n: int) -> None:
        feats = np.asarray(feats, dtype=np.float32)
        feats.setflags(write=False)
        self._admit(key, feats, int(n))

    def _admit(self, key: str, feats: np.ndarray, n: int) -> None:
        evicted = []
        with self._lock:
            if self.capacity > 0:
                self._entries[key] = (feats, n)
                self._entries.move_to_end(key)
                while len(self._entries) > self.capacity:
                    evicted.append(self._entries.popitem(last=False))
            elif self.spill_dir:
                evicted.append((key, (feats, n)))  # disk-only mode
        for ekey, (efeats, en) in evicted:
            self._spill(ekey, efeats, en)

    def _spill(self, key: str, feats: np.ndarray, n: int) -> None:
        if not self.spill_dir:
            return
        path = self._spill_path(key)
        if (os.path.exists(path)
                and os.path.exists(artifacts.sidecar_path(path))):
            # Complete pair already on disk (content-addressed: same key
            # = same bytes). A payload WITHOUT its sidecar — a kill
            # between the two writes — is rewritten whole, healing it.
            return
        try:
            # Serialize in memory, then one atomic_write + sidecar: the
            # destination is only ever a COMPLETE npz with a matching
            # hash, so a reader (or a resumed run) can verify-then-load.
            # The key already binds weights_signature/bucket/dtype
            # (chain_hash extras), so sidecar extras carry only n.
            buf = io.BytesIO()
            np.savez(buf, feats=feats, n=np.int64(n))
            artifacts.atomic_write_artifact(
                path, buf.getvalue(), SPILL_KIND, extra={"n": int(n)})
            with self._lock:
                self._spills += 1
            _SPILLS.inc()
        except OSError:
            # Failed spill (disk full / injected storage fault): drop the
            # entry — it will be re-encoded — and let the startup sweep
            # collect any orphaned tmp.
            pass

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self._hits + self._misses
            return {
                "capacity": self.capacity,
                "size": len(self._entries),
                "spill_dir": self.spill_dir,
                "hits": self._hits,
                "misses": self._misses,
                "spills": self._spills,
                "spill_hits": self._spill_hits,
                "hit_rate": (self._hits / total) if total else 0.0,
                "resident_bytes": sum(
                    f.nbytes for f, _ in self._entries.values()),
            }
