"""Index builds: resumable exactly-once encodes, verify, and merge.

Port of ``deepinteract_tpu/index/builder.py``.

A build encodes a whole chain library once through the engine's encode
graphs and lands it as partitioned shards. The unit of work
is one PARTITION (a bucket-homogeneous slice of the library), and the
:class:`~deepinteract_tpu_torch.screening.manifest.ScreenManifest`
machinery is reused verbatim as the build ledger: shard write first,
then ``mark_done`` + atomic ``flush``, so a kill -9 anywhere re-encodes
at most the one partition whose shard landed but whose ledger entry did
not — every partition is COMPLETED exactly once across runs.

Resume re-verifies every ledger-complete shard against its integrity
sidecar before trusting it: a corrupt or missing shard is quarantined
and its ledger entry discarded, so a rebuild re-encodes ONLY the lost
partition.

``verify`` and ``merge`` are the fsck-shaped companions: verify walks
every shard against the manifest; merge splices disjoint same-version
indexes into one (shards are re-verified, renumbered, and re-written
through the same atomic path — never byte-copied unaudited).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepinteract_tpu_torch.index import format as idx_format
from deepinteract_tpu_torch.index.prefilter import pooled_embedding
from deepinteract_tpu_torch.obs import metrics as obs_metrics
from deepinteract_tpu_torch.robustness import artifacts
from deepinteract_tpu_torch.screening.embcache import EmbeddingCache
from deepinteract_tpu_torch.screening.library import ChainLibrary
from deepinteract_tpu_torch.screening.manifest import ScreenManifest
from deepinteract_tpu_torch.screening.runner import ScreenConfig, ScreenRunner

_PARTITIONS_BUILT = obs_metrics.counter(
    "di_index_partitions_built_total", "Index partitions encoded+landed")
_PARTITIONS_REBUILT = obs_metrics.counter(
    "di_index_partitions_rebuilt_total",
    "Ledger-complete partitions re-encoded after shard corruption")


@dataclasses.dataclass
class BuildResult:
    """One build run's outcome (counters cover THIS run; the manifest
    covers the whole index)."""

    index_dir: str
    partitions_total: int
    partitions_built: int
    partitions_resumed: int
    partitions_rebuilt: int
    chains: int
    encodes_executed: int
    encode_batches: int
    preempted: bool
    resumed: bool
    elapsed_s: float
    weights_signature: str
    library_signature: str

    def summary(self) -> Dict:
        return {
            "index_dir": self.index_dir,
            "partitions": self.partitions_total,
            "partitions_built": self.partitions_built,
            "partitions_resumed": self.partitions_resumed,
            "partitions_rebuilt": self.partitions_rebuilt,
            "chains": self.chains,
            "encodes_executed": self.encodes_executed,
            "encode_batches": self.encode_batches,
            "preempted": self.preempted,
            "resumed": self.resumed,
            "elapsed_s": round(self.elapsed_s, 3),
            "weights_signature": self.weights_signature,
            "library_signature": self.library_signature,
        }


def plan_partitions(engine, library: ChainLibrary,
                    partition_size: int
                    ) -> List[Tuple[str, int, List[str]]]:
    """Deterministic partition plan: chains grouped by engine bucket
    (library order preserved within a bucket), chunked to
    ``partition_size``, ids numbered per bucket — the same plan on every
    resume, which is what makes the ledger's partition ids stable."""
    if partition_size < 1:
        raise ValueError(f"partition_size must be >= 1, "
                         f"got {partition_size}")
    by_bucket: Dict[int, List[str]] = {}
    for cid in library.ids():
        by_bucket.setdefault(engine.chain_bucket(library[cid].n),
                             []).append(cid)
    plan = []
    for bucket in sorted(by_bucket):
        cids = by_bucket[bucket]
        for seq, lo in enumerate(range(0, len(cids), partition_size)):
            plan.append((idx_format.partition_id(bucket, seq), bucket,
                         cids[lo:lo + partition_size]))
    return plan


def _build_signature(engine, library: ChainLibrary,
                     partition_size: int) -> str:
    """What the build ledger is bound to: same identity fields as
    ``ScreenRunner._chain_key`` plus the partition plan shape."""
    return "|".join([
        "index-build", library.signature(), engine.weights_signature(),
        str(bool(engine.cfg.input_indep)),
        str(engine.model.cfg.gnn.compute_dtype),
        f"ps{int(partition_size)}"])


def build_index(engine, library: ChainLibrary, index_dir: str,
                partition_size: int = 64, encode_batch: int = 8,
                cache: Optional[EmbeddingCache] = None, guard=None,
                deadline=None, after_partition=None) -> BuildResult:
    """Encode ``library`` into a durable index at ``index_dir``.

    ``guard`` is a PreemptionGuard polled at partition boundaries;
    a preempted build exits cleanly with the ledger durable and resumes
    exactly-once. ``after_partition(num_done)`` is a test hook."""
    t0 = time.perf_counter()
    plan = plan_partitions(engine, library, partition_size)
    signature = _build_signature(engine, library, partition_size)
    ledger, resumed = ScreenManifest.load_or_create(
        idx_format.ledger_path(index_dir), signature, len(plan))

    # Trust-but-verify resume: a ledger-complete partition whose shard
    # is gone or corrupt is quarantined + discarded, so ONLY it rebuilds.
    rebuilt = 0
    if resumed:
        for pid, _, _ in plan:
            if pid not in ledger.completed:
                continue
            path = idx_format.shard_path(index_dir, pid)
            try:
                idx_format.read_partition(
                    path, expect_signature=engine.weights_signature())
            except artifacts.ArtifactError as exc:
                artifacts.quarantine(path, idx_format.INDEX_SHARD_KIND,
                                     f"resume verification: {exc}")
                ledger.discard(pid)
                rebuilt += 1
                _PARTITIONS_REBUILT.inc()
        if rebuilt:
            ledger.flush()
    resumed_parts = len([pid for pid, _, _ in plan
                         if pid in ledger.completed])

    runner = ScreenRunner(
        engine, cache=cache,
        cfg=ScreenConfig(encode_batch=encode_batch,
                         decode_batch=encode_batch))
    built = 0
    encodes = 0
    enc_batches = 0
    preempted = False
    for pid, bucket, cids in plan:
        if pid in ledger.completed:
            continue
        if guard is not None and getattr(guard, "requested", False):
            preempted = True
            break
        emb, executed, _, batches = runner.ensure_embeddings(
            library, cids, deadline=deadline)
        encodes += executed
        enc_batches += batches
        feats = np.stack([emb[cid][0] for cid in cids])
        pooled = np.stack([pooled_embedding(emb[cid][0], emb[cid][1])
                           for cid in cids])
        lengths = [library[cid].n for cid in cids]
        path = idx_format.write_partition(
            index_dir, pid, bucket, cids, lengths, feats, pooled,
            engine.weights_signature())
        # Shard durable BEFORE the ledger entry: a kill between the two
        # re-encodes this one partition into an identical shard — never
        # a ledger entry pointing at nothing.
        ledger.mark_done(pid, {
            "partition_id": pid, "file": path, "bucket": bucket,
            "chains": list(cids), "lengths": [int(n) for n in lengths]})
        ledger.flush()
        built += 1
        _PARTITIONS_BUILT.inc()
        if after_partition is not None:
            after_partition(built)

    if ledger.done:
        _write_manifest_from_ledger(engine, library, index_dir,
                                    partition_size, plan, ledger)
    return BuildResult(
        index_dir=index_dir,
        partitions_total=len(plan),
        partitions_built=built,
        partitions_resumed=resumed_parts,
        partitions_rebuilt=rebuilt,
        chains=len(library),
        encodes_executed=encodes,
        encode_batches=enc_batches,
        preempted=preempted,
        resumed=resumed,
        elapsed_s=time.perf_counter() - t0,
        weights_signature=engine.weights_signature(),
        library_signature=library.signature())


def _write_manifest_from_ledger(engine, library, index_dir,
                                partition_size, plan, ledger) -> None:
    parts = []
    feat_dim = 0
    for pid, bucket, _ in plan:
        rec = ledger.completed[pid]
        rel = idx_format.shard_path("", pid).lstrip("/")
        parts.append({"partition_id": pid, "file": rel,
                      "bucket": int(bucket),
                      "chains": list(rec["chains"]),
                      "lengths": [int(n) for n in rec["lengths"]]})
    if plan:
        first = idx_format.read_partition(
            idx_format.shard_path(index_dir, plan[0][0]),
            expect_signature=engine.weights_signature())
        feat_dim = int(first["feats"].shape[-1])
    idx_format.write_manifest(index_dir, {
        "format_version": idx_format.INDEX_FORMAT_VERSION,
        "weights_signature": engine.weights_signature(),
        "library_signature": library.signature(),
        "input_indep": bool(engine.cfg.input_indep),
        "compute_dtype": str(engine.model.cfg.gnn.compute_dtype),
        "feat_dim": feat_dim,
        "partition_size": int(partition_size),
        "num_chains": len(library),
        "partitions": parts})


def verify_index(index_dir: str, quarantine: bool = False) -> Dict:
    """Walk every shard against the manifest + sidecars. Returns a
    report; never raises for per-shard damage (that is the report's
    job)."""
    report = {"index_dir": index_dir, "ok": False, "partitions": 0,
              "verified": 0, "corrupt": 0, "corrupt_paths": [],
              "chains": 0, "weights_signature": "",
              "library_signature": ""}
    manifest = idx_format.read_manifest(index_dir)
    report["partitions"] = len(manifest["partitions"])
    report["chains"] = int(manifest["num_chains"])
    report["weights_signature"] = manifest["weights_signature"]
    report["library_signature"] = manifest["library_signature"]
    for part in manifest["partitions"]:
        path = idx_format.shard_path(index_dir, part["partition_id"])
        try:
            data = idx_format.read_partition(
                path, expect_signature=manifest["weights_signature"])
            if data["chain_ids"] != list(part["chains"]):
                raise artifacts.CorruptArtifact(
                    path, "shard chain ids disagree with the manifest")
            report["verified"] += 1
        except artifacts.ArtifactError as exc:
            report["corrupt"] += 1
            report["corrupt_paths"].append(path)
            if quarantine:
                artifacts.quarantine(path, idx_format.INDEX_SHARD_KIND,
                                     str(exc))
    report["ok"] = report["corrupt"] == 0
    return report


def merge_indexes(sources: Sequence[str], out_dir: str) -> Dict:
    """Splice disjoint same-version indexes into one at ``out_dir``.

    Every source shard is re-verified and re-written through the atomic
    artifact path under a renumbered partition id. The merged
    ``library_signature`` is derived from the sorted source signatures
    (the raw chains are not on hand to re-derive a ChainLibrary one)."""
    if len(sources) < 2:
        raise ValueError("merge needs at least two source indexes")
    manifests = [(src, idx_format.read_manifest(src)) for src in sources]
    head = manifests[0][1]
    for src, m in manifests[1:]:
        for key in ("weights_signature", "input_indep", "compute_dtype",
                    "feat_dim"):
            if m[key] != head[key]:
                raise ValueError(
                    f"cannot merge {src}: {key} {m[key]!r} != "
                    f"{head[key]!r} (indexes must share the embedding "
                    "identity)")
    seen: Dict[str, str] = {}
    for src, m in manifests:
        for part in m["partitions"]:
            for cid in part["chains"]:
                if cid in seen:
                    raise ValueError(
                        f"cannot merge: chain {cid!r} appears in both "
                        f"{seen[cid]} and {src}")
                seen[cid] = src

    parts = []
    seq_by_bucket: Dict[int, int] = {}
    for src, m in manifests:
        for part in m["partitions"]:
            data = idx_format.read_partition(
                idx_format.shard_path(src, part["partition_id"]),
                expect_signature=head["weights_signature"])
            bucket = int(part["bucket"])
            seq = seq_by_bucket.get(bucket, 0)
            seq_by_bucket[bucket] = seq + 1
            pid = idx_format.partition_id(bucket, seq)
            idx_format.write_partition(
                out_dir, pid, bucket, data["chain_ids"],
                [int(n) for n in data["lengths"]], data["feats"],
                data["pooled"], head["weights_signature"])
            parts.append({
                "partition_id": pid,
                "file": idx_format.shard_path("", pid).lstrip("/"),
                "bucket": bucket, "chains": list(data["chain_ids"]),
                "lengths": [int(n) for n in data["lengths"]]})
    merged_sig = "merge-" + hashlib.sha256("|".join(
        sorted(m["library_signature"] for _, m in manifests)).encode()
    ).hexdigest()[:16]
    idx_format.write_manifest(out_dir, {
        "format_version": idx_format.INDEX_FORMAT_VERSION,
        "weights_signature": head["weights_signature"],
        "library_signature": merged_sig,
        "input_indep": head["input_indep"],
        "compute_dtype": head["compute_dtype"],
        "feat_dim": head["feat_dim"],
        "partition_size": int(head["partition_size"]),
        "num_chains": len(seen),
        "partitions": parts})
    return {"index_dir": out_dir, "ok": True, "sources": list(sources),
            "partitions": len(parts), "chains": len(seen),
            "weights_signature": head["weights_signature"],
            "library_signature": merged_sig}
