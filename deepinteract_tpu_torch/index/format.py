"""On-disk proteome-index format: partitioned npz shards + manifest.

Port of ``deepinteract_tpu/index/format.py``.

Layout (one directory per index)::

    <index_dir>/
        index_manifest.json            # partition table (+ sidecar)
        build_ledger.json              # exactly-once build state
        partitions/
            part-b0064-0000.npz        # padded embeddings (+ sidecar)
            part-b0064-0001.npz
            part-b0128-0000.npz

Every shard holds the padded per-chain encoder embeddings for one
(bucket, sequence) partition — exactly what ``ScreenRunner``'s decode
phase consumes — plus the mean-pooled prefilter vectors so a query can
rank the whole partition without touching the full feature tensors'
semantics. All writes go through ``robustness/artifacts.py``: tmp +
fsync + rename with an integrity sidecar whose ``extra`` carries the
``weights_signature`` the embeddings were computed under, so
``verify_read(..., expect={"weights_signature": ...})`` turns version
drift into a typed :class:`StaleArtifact` for free.

Shard npz keys::

    feats      float32 [k, bucket, C]   padded encoder embeddings
    pooled     float32 [k, C]           l2-normalized masked mean-pool
    lengths    int64   [k]              true residue counts
    chain_ids  str     [k]              library chain ids

The manifest is the partition table: which chains live in which shard,
under which bucket, computed under which weights/library signatures.
The embedding identity fields (``weights_signature``, ``input_indep``,
``compute_dtype``) mirror ``ScreenRunner._chain_key`` so an index is
bound to the same cache-key space as the live embedding cache.
"""

from __future__ import annotations

import io
import json
import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from deepinteract_tpu_torch.robustness import artifacts

INDEX_FORMAT_VERSION = 1
INDEX_MANIFEST_KIND = "index-manifest"
INDEX_SHARD_KIND = "index-shard"
MANIFEST_BASENAME = "index_manifest.json"
LEDGER_BASENAME = "build_ledger.json"
PARTITIONS_DIRNAME = "partitions"

# Manifest keys every reader validates before trusting the table.
_MANIFEST_REQUIRED = ("format_version", "weights_signature",
                      "library_signature", "input_indep", "compute_dtype",
                      "feat_dim", "partition_size", "num_chains",
                      "partitions")
_PARTITION_REQUIRED = ("partition_id", "file", "bucket", "chains",
                       "lengths")


def partition_id(bucket: int, seq: int) -> str:
    return f"part-b{bucket:04d}-{seq:04d}"


def shard_path(index_dir: str, pid: str) -> str:
    return os.path.join(index_dir, PARTITIONS_DIRNAME, f"{pid}.npz")


def manifest_path(index_dir: str) -> str:
    return os.path.join(index_dir, MANIFEST_BASENAME)


def ledger_path(index_dir: str) -> str:
    return os.path.join(index_dir, LEDGER_BASENAME)


def write_partition(index_dir: str, pid: str, bucket: int,
                    chain_ids: Sequence[str], lengths: Sequence[int],
                    feats: np.ndarray, pooled: np.ndarray,
                    weights_signature: str) -> str:
    """Serialize one shard and land it durably (atomic + sidecar)."""
    if feats.shape[0] != len(chain_ids) or pooled.shape[0] != len(chain_ids):
        raise ValueError(
            f"shard {pid}: {len(chain_ids)} chains but feats "
            f"{feats.shape} / pooled {pooled.shape}")
    path = shard_path(index_dir, pid)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf,
             feats=np.asarray(feats, np.float32),
             pooled=np.asarray(pooled, np.float32),
             lengths=np.asarray(lengths, np.int64),
             chain_ids=np.asarray(list(chain_ids)))
    artifacts.atomic_write_artifact(
        path, buf.getvalue(), INDEX_SHARD_KIND,
        version=INDEX_FORMAT_VERSION,
        extra={"weights_signature": weights_signature,
               "partition_id": pid, "bucket": int(bucket),
               "num_chains": len(chain_ids)})
    return path


def read_partition(path: str,
                   expect_signature: Optional[str] = None
                   ) -> Dict[str, Any]:
    """Verified shard read: sidecar first, then a pickle-free np.load.

    Raises :class:`artifacts.CorruptArtifact` on byte damage or a
    structurally invalid payload, :class:`artifacts.StaleArtifact` when
    ``expect_signature`` no longer matches the sidecar."""
    expect = ({"weights_signature": expect_signature}
              if expect_signature is not None else None)
    raw = artifacts.verify_read(path, kind=INDEX_SHARD_KIND, expect=expect)
    try:
        with np.load(io.BytesIO(raw), allow_pickle=False) as data:
            out = {"feats": data["feats"], "pooled": data["pooled"],
                   "lengths": data["lengths"],
                   "chain_ids": [str(c) for c in data["chain_ids"]]}
    except (ValueError, KeyError, OSError) as exc:
        raise artifacts.CorruptArtifact(path, f"undecodable shard: {exc}")
    k = len(out["chain_ids"])
    if (out["feats"].ndim != 3 or out["pooled"].ndim != 2
            or out["feats"].shape[0] != k or out["pooled"].shape[0] != k
            or out["lengths"].shape != (k,)):
        raise artifacts.CorruptArtifact(
            path, f"inconsistent shard shapes for {k} chains: "
                  f"feats {out['feats'].shape} pooled {out['pooled'].shape}"
                  f" lengths {out['lengths'].shape}")
    return out


def write_manifest(index_dir: str, manifest: Dict[str, Any]) -> str:
    missing = [k for k in _MANIFEST_REQUIRED if k not in manifest]
    if missing:
        raise ValueError(f"index manifest missing keys {missing}")
    path = manifest_path(index_dir)
    os.makedirs(index_dir, exist_ok=True)
    artifacts.atomic_write_artifact(
        path, json.dumps(manifest, indent=1, sort_keys=True).encode(),
        INDEX_MANIFEST_KIND, version=INDEX_FORMAT_VERSION,
        extra={"weights_signature": manifest["weights_signature"],
               "library_signature": manifest["library_signature"]})
    return path


def read_manifest(index_dir: str,
                  require_sidecar: bool = True) -> Dict[str, Any]:
    """Verified manifest read + structural validation."""
    path = manifest_path(index_dir)
    manifest = artifacts.verify_json(path, kind=INDEX_MANIFEST_KIND,
                                     require_sidecar=require_sidecar)
    missing = [k for k in _MANIFEST_REQUIRED if k not in manifest]
    if missing:
        raise artifacts.CorruptArtifact(
            path, f"manifest missing keys {missing}")
    for part in manifest["partitions"]:
        bad = [k for k in _PARTITION_REQUIRED if k not in part]
        if bad:
            raise artifacts.CorruptArtifact(
                path, f"partition entry missing keys {bad}: "
                      f"{part.get('partition_id', '?')}")
    return manifest


class ChainIndex:
    """Read-side handle: manifest table + lazily loaded, verified shards.

    Shard loads are cached (an index partition is immutable once built);
    a shard that fails verification is quarantined on the spot and the
    typed error propagates, so a serving worker answers 500/400 instead
    of ranking against garbage embeddings."""

    def __init__(self, index_dir: str, manifest: Dict[str, Any]):
        self.index_dir = index_dir
        self.manifest = manifest
        self._parts = {p["partition_id"]: p
                       for p in manifest["partitions"]}
        self._loaded: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._chain_loc: Dict[str, Tuple[str, int]] = {}
        for p in manifest["partitions"]:
            for row, cid in enumerate(p["chains"]):
                self._chain_loc[cid] = (p["partition_id"], row)

    @classmethod
    def open(cls, index_dir: str) -> "ChainIndex":
        return cls(index_dir, read_manifest(index_dir))

    # -- manifest views ----------------------------------------------------

    @property
    def weights_signature(self) -> str:
        return str(self.manifest["weights_signature"])

    @property
    def library_signature(self) -> str:
        return str(self.manifest["library_signature"])

    @property
    def num_chains(self) -> int:
        return int(self.manifest["num_chains"])

    @property
    def feat_dim(self) -> int:
        return int(self.manifest["feat_dim"])

    def partition_ids(self) -> List[str]:
        return sorted(self._parts)

    def partition(self, pid: str) -> Dict[str, Any]:
        return self._parts[pid]

    def buckets(self) -> List[int]:
        return sorted({int(p["bucket"]) for p in self._parts.values()})

    def chain_ids(self) -> List[str]:
        return sorted(self._chain_loc)

    def __contains__(self, chain_id: str) -> bool:
        return chain_id in self._chain_loc

    # -- shard access ------------------------------------------------------

    def load_partition(self, pid: str) -> Dict[str, Any]:
        """Verified shard payload, cached; quarantines on corruption."""
        with self._lock:
            hit = self._loaded.get(pid)
        if hit is not None:
            return hit
        path = shard_path(self.index_dir, pid)
        try:
            data = read_partition(
                path, expect_signature=self.weights_signature)
        except FileNotFoundError as exc:
            # The manifest promises this shard; its absence (lost or
            # already quarantined) is damage, not a lookup miss.
            raise artifacts.CorruptArtifact(
                path, "manifest lists this shard but it is missing on "
                "disk; rebuild the partition") from exc
        except artifacts.CorruptArtifact:
            artifacts.quarantine(path, INDEX_SHARD_KIND,
                                 "failed verification on read")
            raise
        if data["chain_ids"] != list(self._parts[pid]["chains"]):
            artifacts.quarantine(path, INDEX_SHARD_KIND,
                                 "chain ids disagree with manifest")
            raise artifacts.CorruptArtifact(
                path, "shard chain ids disagree with the manifest")
        with self._lock:
            self._loaded[pid] = data
        return data

    def iter_pooled(self, partitions: Optional[Iterable[str]] = None):
        """Yield (pid, chain_ids, lengths, pooled) per selected shard —
        the prefilter's scan surface."""
        for pid in (sorted(partitions) if partitions is not None
                    else self.partition_ids()):
            if pid not in self._parts:
                raise KeyError(f"unknown index partition {pid!r}")
            data = self.load_partition(pid)
            yield pid, data["chain_ids"], data["lengths"], data["pooled"]

    def chain_feats(self, chain_id: str) -> Tuple[np.ndarray, int, int]:
        """(padded feats [bucket, C], n, bucket) for an indexed chain —
        lets a query that already lives in the index skip its encoder
        pass entirely."""
        if chain_id not in self._chain_loc:
            raise KeyError(f"chain {chain_id!r} is not in the index")
        pid, row = self._chain_loc[chain_id]
        data = self.load_partition(pid)
        return (data["feats"][row], int(data["lengths"][row]),
                int(self._parts[pid]["bucket"]))

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            resident = len(self._loaded)
        return {"index_dir": self.index_dir,
                "chains": self.num_chains,
                "partitions": len(self._parts),
                "buckets": self.buckets(),
                "feat_dim": self.feat_dim,
                "weights_signature": self.weights_signature,
                "library_signature": self.library_signature,
                "partitions_resident": resident}
