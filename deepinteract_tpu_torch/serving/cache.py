"""LRU result cache keyed on a content hash of the featurized complex.

Port of ``deepinteract_tpu/serving/cache.py``. A contact map is a pure
function of the featurized inputs plus the loaded weights, so an exact
content hash is a sound cache key. The hash covers every input array the
model consumes (both chains' node/edge features, coordinates, topology)
plus any engine-level flags that change the math (``input_indep``). It is
byte for byte the JAX package's: one raw dict gives one hex digest in
both packages.

The cache stores *depadded* host results (``[n1, n2]`` float32 maps), so
hits cost zero device work and are bucket-policy independent.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, Iterable, Optional

import numpy as np

# The schema's own list of per-chain arrays, so the key covers every
# input array even if the schema grows.
from deepinteract_tpu_torch.data.io import GRAPH_KEYS as _HASHED_GRAPH_KEYS


def content_hash(raw: Dict, extra: Iterable = ()) -> str:
    """SHA-256 over the featurized complex's model-visible arrays.

    ``extra`` mixes in engine-level knobs that change the output for the
    same input (e.g. ``input_indep``); shapes and dtypes are hashed
    alongside the bytes so e.g. a [N,K] int32 and an [N*K] int32 with the
    same payload cannot alias."""
    h = hashlib.sha256()
    for graph_key in ("graph1", "graph2"):
        g = raw[graph_key]
        for key in _HASHED_GRAPH_KEYS:
            a = np.ascontiguousarray(g[key])
            h.update(f"{graph_key}.{key}:{a.dtype.str}:{a.shape}".encode())
            h.update(a.tobytes())
    for item in extra:
        h.update(repr(item).encode())
    return h.hexdigest()


class ResultCache:
    """Thread-safe LRU of prediction results.

    ``capacity <= 0`` disables caching (every ``get`` misses, ``put`` is a
    no-op) so one code path serves both configurations."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._entries: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            if self.capacity <= 0 or key not in self._entries:
                self._misses += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            return self._entries[key]

    def put(self, key: str, value: Any) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self._hits + self._misses
            return {
                "capacity": self.capacity,
                "size": len(self._entries),
                "hits": self._hits,
                "misses": self._misses,
                "hit_rate": (self._hits / total) if total else 0.0,
            }
