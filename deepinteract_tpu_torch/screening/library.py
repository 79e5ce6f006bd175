"""Chain libraries: the input side of a bulk screen.

Port of ``deepinteract_tpu/screening/library.py``: the same chain ids,
raw arrays and signatures for the same sources (``synthetic`` draws from
the port's own featurizer and generator, bitwise equal to the JAX ones).

A screen operates on CHAINS, not complexes — the unit the shared-weight
encoder leg consumes. Every in-repo storage format is a *complex* (two
chains), so a library is assembled by splitting complexes: each
``.npz`` (``data/io.py`` schema) or packed-memmap item (``data/
packed.py``) contributes its two chains as ``<name>:g1`` / ``<name>:g2``.
A synthetic generator covers tests and benches.

Chains are kept as raw featurizer dicts (``GRAPH_KEYS`` arrays,
unpadded); padding to the engine's chain bucket happens at encode time so
one library serves every bucket policy.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from deepinteract_tpu_torch.data.graph import ProteinGraph
from deepinteract_tpu_torch.data.io import GRAPH_KEYS, load_complex_npz

from deepinteract_tpu_torch.screening.embcache import chain_hash


@dataclasses.dataclass(frozen=True)
class ChainEntry:
    """One library chain: stable id, raw featurizer arrays, real length."""

    chain_id: str
    raw: Dict[str, np.ndarray]
    n: int


class ChainLibrary:
    """Ordered collection of chains with stable ids and a content
    signature (manifest compatibility check across resumes)."""

    def __init__(self, chains: Sequence[ChainEntry]):
        if not chains:
            raise ValueError("chain library is empty")
        ids = [c.chain_id for c in chains]
        if len(set(ids)) != len(ids):
            dupes = sorted({i for i in ids if ids.count(i) > 1})[:5]
            raise ValueError(f"duplicate chain ids in library: {dupes}")
        self.chains: List[ChainEntry] = list(chains)
        self._by_id = {c.chain_id: c for c in self.chains}

    def __len__(self) -> int:
        return len(self.chains)

    def __getitem__(self, chain_id: str) -> ChainEntry:
        return self._by_id[chain_id]

    def ids(self) -> List[str]:
        return [c.chain_id for c in self.chains]

    def signature(self) -> str:
        """Content signature over ids + per-chain array hashes: a resumed
        manifest written for a DIFFERENT library must not be trusted."""
        h = hashlib.sha256()
        for c in self.chains:
            h.update(f"{c.chain_id}:{c.n}:".encode())
            h.update(chain_hash(c.raw).encode())
        return h.hexdigest()[:16]

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_complex_files(cls, paths: Sequence[str]) -> "ChainLibrary":
        """Each complex ``.npz`` contributes chains ``<stem>:g1`` and
        ``<stem>:g2``."""
        chains = []
        for path in paths:
            raw = load_complex_npz(path)
            stem = os.path.splitext(os.path.basename(path))[0]
            for part in ("g1", "g2"):
                graph = raw["graph1" if part == "g1" else "graph2"]
                chains.append(ChainEntry(
                    chain_id=f"{stem}:{part}",
                    raw={k: np.asarray(graph[k]) for k in GRAPH_KEYS},
                    n=int(graph["node_feats"].shape[0])))
        return cls(chains)

    @classmethod
    def from_npz_dir(cls, directory: str) -> "ChainLibrary":
        paths = sorted(glob.glob(os.path.join(directory, "*.npz")))
        if not paths:
            raise FileNotFoundError(f"no .npz complexes under {directory}")
        return cls.from_complex_files(paths)

    @classmethod
    def from_pack(cls, pack_dir: str) -> "ChainLibrary":
        """Chains out of a pre-padded memmap pack (``data/packed.py``):
        rows are de-padded back to their real lengths (padding is appended
        at the tail, so a ``[:n]`` slice is exact)."""
        from deepinteract_tpu_torch.data.packed import PackedDataset

        ds = PackedDataset(pack_dir)
        fields = [f.name for f in dataclasses.fields(ProteinGraph)]
        chains = []
        for idx in range(len(ds)):
            # The stored leaves (int32 indices, as the JAX package reads
            # them), so chain hashes match across the packages.
            leaves = ds.padded_leaves([idx], ds.bucket_of(idx))
            stem = os.path.splitext(os.path.basename(ds.target_of(idx)))[0]
            for i, part in enumerate(("g1", "g2")):
                graph = dict(zip(fields, leaves[i * len(fields):(i + 1) * len(fields)]))
                n = int(np.asarray(graph["num_nodes"]).reshape(-1)[0])
                raw = {k: np.asarray(graph[k])[0, :n] for k in GRAPH_KEYS}
                chains.append(ChainEntry(chain_id=f"{stem}:{part}",
                                         raw=raw, n=n))
        return cls(chains)

    @classmethod
    def synthetic(cls, num_chains: int, len_lo: int = 24, len_hi: int = 48,
                  seed: int = 0, knn: Optional[int] = None,
                  geo_nbrhd_size: Optional[int] = None) -> "ChainLibrary":
        """Deterministic synthetic library (tests / bench / smoke)."""
        from deepinteract_tpu_torch import constants
        from deepinteract_tpu_torch.data import features as F
        from deepinteract_tpu_torch.data.synthetic import (
            random_backbone,
            random_residue_feats,
        )

        knn = knn or constants.KNN
        geo = geo_nbrhd_size or constants.GEO_NBRHD_SIZE
        rng = np.random.default_rng(seed)
        chains = []
        for i in range(num_chains):
            n = int(rng.integers(max(len_lo, knn + 1), len_hi + 1))
            raw = F.featurize_chain(
                random_backbone(n, rng), random_residue_feats(n, rng),
                knn=knn, geo_nbrhd_size=geo, rng=rng)
            chains.append(ChainEntry(chain_id=f"syn{i:04d}", raw=raw, n=n))
        return cls(chains)


def enumerate_pairs(
    library: ChainLibrary,
    queries: Optional[Iterable[str]] = None,
    include_self: bool = False,
    max_pairs: int = 0,
) -> List[Tuple[str, str]]:
    """The screen's work list, in deterministic order.

    All-vs-all (default): unordered pairs ``(i, j)`` with ``i < j`` in
    library order (plus the diagonal under ``include_self`` — homodimer
    screening). Query mode: every query against the full library, one
    entry per unordered pair (two queries never produce both
    orientations). ``max_pairs`` truncates the list (0 = no cap).
    """
    ids = library.ids()
    pairs: List[Tuple[str, str]] = []
    seen = set()
    if queries:
        queries = list(queries)
        missing = [q for q in queries if q not in set(ids)]
        if missing:
            raise KeyError(f"query chains not in library: {missing[:5]}")
        for q in queries:
            for other in ids:
                if other == q and not include_self:
                    continue
                key = frozenset((q, other))
                if key in seen:
                    continue
                seen.add(key)
                pairs.append((q, other))
    else:
        for a in range(len(ids)):
            start = a if include_self else a + 1
            for b in range(start, len(ids)):
                pairs.append((ids[a], ids[b]))
    if max_pairs and len(pairs) > max_pairs:
        pairs = pairs[:max_pairs]
    return pairs
