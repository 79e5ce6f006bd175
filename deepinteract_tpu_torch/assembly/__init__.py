"""k-chain assembly scoring.

Port of ``deepinteract_tpu/assembly/``. A complex with k chains has
C(k, 2) chain pairs; this package scores
all of them with one encoder pass per UNIQUE chain (the screening
embedding cache, counter-asserted), micro-batched contact decodes through
the engine's split-phase graphs, and assembles the per-assembly result:
per-pair contact maps, an interface graph (edges = pairs whose
calibrated interaction score clears a threshold), a complex-level
interactability score, and the ``input_indep`` control score — the
wired-in honesty baseline every ranking is reported next to.
"""

from deepinteract_tpu_torch.assembly.runner import (
    ASSEMBLY_BUNDLE_KIND,
    AssemblyConfig,
    AssemblyResult,
    AssemblyRunner,
)

__all__ = [
    "ASSEMBLY_BUNDLE_KIND",
    "AssemblyConfig",
    "AssemblyResult",
    "AssemblyRunner",
]
