"""Bulk screening: all-vs-all chain-pair scoring over the serving engine.

Port of ``deepinteract_tpu/screening/`` (numpy on the host, the split
phase on the card as CUDA graphs, ``serving/graphs.py``).

The model is siamese by construction (one shared-weight Geometric
Transformer leg per chain, then an interaction stem + decoder), so an
N-chain screen needs N encoder passes and N^2 cheap decodes — this
package turns the serving stack into exactly that pipeline:

* :mod:`~deepinteract_tpu_torch.screening.library` — chain libraries from npz
  dirs / packed memmaps / synthetic generators, plus pair enumeration;
* :mod:`~deepinteract_tpu_torch.screening.embcache` — content-addressed
  embedding cache (in-memory LRU + optional npz spill);
* :mod:`~deepinteract_tpu_torch.screening.runner` — the pair scheduler over
  the engine's split-phase encode and decode graphs;
* :mod:`~deepinteract_tpu_torch.screening.manifest` — atomic progress ledger
  with exactly-once preemption resume;
* :mod:`~deepinteract_tpu_torch.screening.scoring` — top-k contact summary
  shared with ``cli/predict.py --top_k``.

Entry point: ``python -m deepinteract_tpu_torch.cli.screen``.
"""

from deepinteract_tpu_torch.screening.embcache import (  # noqa: F401
    EmbeddingCache,
    chain_hash,
)
from deepinteract_tpu_torch.screening.library import (  # noqa: F401
    ChainEntry,
    ChainLibrary,
    enumerate_pairs,
)
from deepinteract_tpu_torch.screening.manifest import (  # noqa: F401
    ScreenManifest,
    pair_id,
)
from deepinteract_tpu_torch.screening.runner import (  # noqa: F401
    ScreenConfig,
    ScreenResult,
    ScreenRunner,
)
from deepinteract_tpu_torch.screening.scoring import (  # noqa: F401
    pair_summary,
    rank_records,
)
