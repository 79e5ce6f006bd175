"""Proteome index: a persistent, sharded embedding index.

Port of ``deepinteract_tpu/index/``, file for file: an index built by
either package is read, verified, merged and queried by the other. The
layer above the screening embedding cache: a
durable, versioned on-disk index over an entire chain library, plus the
query funnel that ranks every library chain against a query with a cheap
embedding-space pre-filter and streams only the top-M survivors into the
expensive contact decoder.

    format.py    on-disk shard/manifest format + ChainIndex reader
    builder.py   resumable exactly-once index builds, verify, merge
    prefilter.py pooled-embedding bilinear pre-filter (the funnel mouth)
    funnel.py    IndexedQueryRunner: encode query -> prefilter -> decode
"""

from deepinteract_tpu_torch.index.builder import (
    BuildResult,
    build_index,
    merge_indexes,
    plan_partitions,
    verify_index,
)
from deepinteract_tpu_torch.index.format import (
    INDEX_MANIFEST_KIND,
    INDEX_SHARD_KIND,
    MANIFEST_BASENAME,
    PARTITIONS_DIRNAME,
    ChainIndex,
    manifest_path,
    read_manifest,
    read_partition,
    shard_path,
    write_manifest,
    write_partition,
)
from deepinteract_tpu_torch.index.funnel import (
    IndexedQueryRunner,
    QueryConfig,
    QueryResult,
)
from deepinteract_tpu_torch.index.prefilter import (
    bilinear_scores,
    pooled_embedding,
    prefilter,
)

__all__ = [
    "INDEX_MANIFEST_KIND",
    "INDEX_SHARD_KIND",
    "MANIFEST_BASENAME",
    "PARTITIONS_DIRNAME",
    "BuildResult",
    "ChainIndex",
    "IndexedQueryRunner",
    "QueryConfig",
    "QueryResult",
    "bilinear_scores",
    "build_index",
    "manifest_path",
    "merge_indexes",
    "plan_partitions",
    "pooled_embedding",
    "prefilter",
    "read_manifest",
    "read_partition",
    "shard_path",
    "verify_index",
    "write_manifest",
    "write_partition",
]
