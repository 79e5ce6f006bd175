"""Pre-padded per-bucket memmap pack: batch assembly as mmap + stack.

Port of ``deepinteract_tpu/data/packed.py`` (numpy only). The per-item
host path (npz decompress -> pad -> re-layout in ``to_paired_complex``)
runs on the data-loading cores; a pack stores every complex ALREADY
PADDED to its shape bucket, one ``.npy`` per leaf per bucket, written
once by :func:`pack_dataset`. Batch assembly then is ``np.stack`` over
rows of ``np.load(..., mmap_mode='r')`` arrays — no decompression, no
padding, no re-layout, and the OS page cache absorbs re-reads.

The files are the JAX package's: the leaves of a ``PairedComplex`` in
field order (``graph1``'s eight, ``graph2``'s eight, then ``examples``,
``example_mask``, ``contact_map``), integers stored as int32 as the JAX
package pads them, so either package reads the other's pack.
:meth:`PackedDataset.padded_batch` returns the port's ``PairedComplex``
with the port's int64 indices, equal to ``to_paired_complex`` +
``stack_complexes`` of the same items.

Storage cost: pad ratio x raw size (a p128-bucket complex stores its full
128-row layout). That trade is the point — disk for host CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from deepinteract_tpu_torch.data.graph import PairedComplex, ProteinGraph
from deepinteract_tpu_torch.robustness import artifacts

INDEX_NAME = "pack_index.json"
_PACK_VERSION = 1
_GRAPH_FIELDS = tuple(f.name for f in dataclasses.fields(ProteinGraph))
_TAIL_FIELDS = ("examples", "example_mask", "contact_map")
NUM_LEAVES = 2 * len(_GRAPH_FIELDS) + len(_TAIL_FIELDS)


def _leaves(pc: PairedComplex) -> List[np.ndarray]:
    """The pack's leaves of one padded complex, in the JAX flattening
    order, integers as int32."""
    tensors = ([getattr(pc.graph1, f) for f in _GRAPH_FIELDS]
               + [getattr(pc.graph2, f) for f in _GRAPH_FIELDS]
               + [getattr(pc, f) for f in _TAIL_FIELDS])
    out = []
    for t in tensors:
        a = np.asarray(t)
        out.append(a.astype(np.int32) if a.dtype == np.int64 else a)
    return out


def _complex(leaves: Sequence[np.ndarray]) -> PairedComplex:
    """The port's batched ``PairedComplex`` from stacked pack leaves."""
    def as_t(a):
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)

    g = len(_GRAPH_FIELDS)
    graphs = [ProteinGraph(**{f: as_t(leaves[i * g + j]) for j, f in enumerate(_GRAPH_FIELDS)})
              for i in range(2)]
    return PairedComplex(graphs[0], graphs[1],
                         **{f: as_t(leaves[2 * g + j]) for j, f in enumerate(_TAIL_FIELDS)})


def _bucket_key(bucket: Tuple[int, int]) -> str:
    return f"{bucket[0]}x{bucket[1]}"


def _leaf_path(out_dir: str, bucket: Tuple[int, int], leaf_idx: int) -> str:
    return os.path.join(out_dir, f"bucket_{_bucket_key(bucket)}_leaf{leaf_idx}.npy")


def pack_dataset(dataset, out_dir: str, item_bucket_fn, signature: str = "") -> str:
    """Write ``dataset`` as a pre-padded pack under ``out_dir``.

    ``item_bucket_fn(n1, n2) -> (b1, b2)`` decides each complex's bucket —
    pass the owning loader's bucket function so pack-time buckets match
    plan-time buckets. ``signature`` should encode the bucket-fn flags (and
    anything else that changes pack content): an existing index is reused
    ONLY when version, signature, item count AND the per-item length list
    all match — a pack built under different flags or over changed data is
    rebuilt, not silently served stale.
    """
    from deepinteract_tpu_torch.data.io import to_paired_complex

    index_path = os.path.join(out_dir, INDEX_NAME)
    lengths = list(dataset.lengths())
    if os.path.exists(index_path):
        with open(index_path) as fh:
            existing = json.load(fh)
        if (existing.get("version") == _PACK_VERSION
                and existing.get("signature", "") == signature
                and existing.get("num_items") == len(lengths)
                and existing.get("lengths") == [list(map(int, ln)) for ln in lengths]):
            return out_dir
    os.makedirs(out_dir, exist_ok=True)

    groups: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    for idx, (n1, n2) in enumerate(lengths):
        groups[tuple(item_bucket_fn(n1, n2))].append(idx)

    index = {
        "version": _PACK_VERSION,
        "signature": signature,
        "num_items": len(lengths),
        "lengths": [list(map(int, ln)) for ln in lengths],
        "targets": [str(dataset.target_of(i)) for i in range(len(lengths))],
        "buckets": {},
    }
    for bucket, idxs in sorted(groups.items()):
        writers = None
        for row, idx in enumerate(idxs):
            raw = dataset[idx]
            leaves = _leaves(to_paired_complex(raw, n_pad1=bucket[0], n_pad2=bucket[1],
                                               input_indep=raw.get("input_indep", False)))
            if writers is None:
                writers = [np.lib.format.open_memmap(
                    _leaf_path(out_dir, bucket, i), mode="w+", dtype=leaf.dtype,
                    shape=(len(idxs),) + leaf.shape) for i, leaf in enumerate(leaves)]
            for w, leaf in zip(writers, leaves):
                w[row] = leaf
        for w in writers:
            w.flush()
        index["buckets"][_bucket_key(bucket)] = {
            "bucket": list(bucket), "indices": idxs, "num_leaves": len(writers)}
    artifacts.atomic_write(index_path, json.dumps(index))
    return out_dir


class PackedDataset:
    """Loader-facing view of a pack directory: ``lengths`` / ``target_of``
    / ``__len__``, plus ``bucket_of(idx)`` (the pack-time bucket) and
    ``padded_batch(indices, bucket)`` (mmap + stack)."""

    def __init__(self, pack_dir: str):
        self.pack_dir = pack_dir
        with open(os.path.join(pack_dir, INDEX_NAME)) as fh:
            self._index = json.load(fh)
        if self._index.get("version") != _PACK_VERSION:
            raise ValueError(f"pack version {self._index.get('version')} != {_PACK_VERSION}")
        self._lengths = [tuple(ln) for ln in self._index["lengths"]]
        self._targets = list(self._index["targets"])
        # idx -> (bucket, row-in-bucket)
        self._where: Dict[int, Tuple[Tuple[int, int], int]] = {}
        for info in self._index["buckets"].values():
            bucket = tuple(info["bucket"])
            for row, idx in enumerate(info["indices"]):
                self._where[idx] = (bucket, row)
        self._mmaps: Dict[Tuple[int, int], List[np.ndarray]] = {}

    def __len__(self) -> int:
        return self._index["num_items"]

    def lengths(self) -> List[tuple]:
        return list(self._lengths)

    def target_of(self, idx: int) -> str:
        return self._targets[idx]

    def bucket_of(self, idx: int) -> Tuple[int, int]:
        return self._where[idx][0]

    def _bucket_mmaps(self, bucket: Tuple[int, int]) -> List[np.ndarray]:
        if bucket not in self._mmaps:
            n = self._index["buckets"][_bucket_key(bucket)]["num_leaves"]
            if n != NUM_LEAVES:
                raise ValueError(f"pack bucket {bucket} has {n} leaves, a PairedComplex "
                                 f"has {NUM_LEAVES}")
            self._mmaps[bucket] = [np.load(_leaf_path(self.pack_dir, bucket, i),
                                           mmap_mode="r") for i in range(n)]
        return self._mmaps[bucket]

    def padded_leaves(self, indices: Sequence[int], bucket: Tuple[int, int]) -> List[np.ndarray]:
        """The stacked leaves of ``indices`` (all in ``bucket``) as stored:
        numpy, integers int32, in the JAX flattening order."""
        bucket = tuple(bucket)
        rows = []
        for idx in indices:
            b, row = self._where[idx]
            if b != bucket:
                raise ValueError(f"item {idx} packed for bucket {b}, requested {bucket} — "
                                 "loader bucket rules must match pack-time rules")
            rows.append(row)
        return [np.stack([mm[r] for r in rows]) for mm in self._bucket_mmaps(bucket)]

    def padded_batch(self, indices: Sequence[int], bucket: Tuple[int, int]) -> PairedComplex:
        """Stacked ``PairedComplex`` batch for ``indices`` (all in
        ``bucket``) — equal to per-item ``to_paired_complex`` +
        ``stack_complexes`` by construction of the pack."""
        return _complex(self.padded_leaves(indices, bucket))

    def __getitem__(self, idx: int):
        raise TypeError("PackedDataset items are pre-padded; read them with padded_batch, "
                        "not as per-item raw dicts")
