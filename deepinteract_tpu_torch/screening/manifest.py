"""Screen job manifest: atomic progress checkpoints + exactly-once resume.

Port of ``deepinteract_tpu/screening/manifest.py``; the file format is
the same, so either package resumes a manifest the other wrote.

A bulk screen is long-running batch work on preemptible capacity, so it
gets the same discipline as training: progress is flushed
atomically (tmp + ``os.replace``) after every decode batch, and a
SIGTERM'd screen rerun against the same manifest scores ONLY the
remaining pairs — each pair is decoded exactly once across the runs.

The manifest stores each completed pair's full score record, so the final
ranked JSONL/CSV can always be regenerated from the manifest alone — a
resumed run's output covers the whole screen, not just its own slice.
The library signature guards against resuming over different data.

Durability (robustness/artifacts.py): flushes carry a SHA-256 integrity
sidecar and loads verify it before parsing. A corrupt manifest (torn,
truncated, bit-flipped — or one whose sidecar is) is quarantined aside
with a logged reason and the screen starts FRESH: loudly recoverable —
the lost batches are simply re-derived and re-scored, which costs
compute but can never adopt a wrong ledger. A sidecar-less manifest from
an older run still resumes (legacy-unverified, warned).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

from deepinteract_tpu_torch.robustness import artifacts

logger = logging.getLogger(__name__)

MANIFEST_VERSION = 1
MANIFEST_KIND = "screen-manifest"


def pair_id(chain1: str, chain2: str) -> str:
    return f"{chain1}|{chain2}"


class ScreenManifest:
    """Completed-pair ledger with atomic flushes."""

    def __init__(self, path: str, signature: str, total_pairs: int,
                 completed: Optional[Dict[str, Dict]] = None):
        self.path = path
        self.signature = signature
        self.total_pairs = int(total_pairs)
        self.completed: Dict[str, Dict] = dict(completed or {})
        self._dirty = False

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def load_or_create(cls, path: str, signature: str,
                       total_pairs: int) -> Tuple["ScreenManifest", bool]:
        """(manifest, resumed). An existing manifest is resumed only when
        it verifies against its integrity sidecar AND its version and
        library signature match. A corrupt file is quarantined (fresh
        start — lost batches re-derive); a mismatched-but-intact one is
        kept aside as ``<path>.stale`` rather than silently merged into a
        different screen."""
        artifacts.sweep_tmp(os.path.dirname(os.path.abspath(path)),
                            prefix=os.path.basename(path))
        if os.path.exists(path):
            data = None
            try:
                raw = artifacts.verify_read(path, kind=MANIFEST_KIND,
                                            require_sidecar=False)
                data = json.loads(raw.decode("utf-8"))
            except (artifacts.ArtifactError, UnicodeDecodeError,
                    json.JSONDecodeError) as exc:
                # Positive corruption (hash/length mismatch, unreadable
                # sidecar, or unparseable verified bytes): quarantine and
                # start fresh — loud, recoverable, never adopted.
                artifacts.quarantine(path, MANIFEST_KIND, str(exc))
            except OSError as exc:
                # TRANSIENT read failure (flaky FS), not corruption: the
                # ledger may be intact, so keep it aside as .stale rather
                # than letting the fresh manifest's first flush overwrite
                # it (pre-integrity behavior, preserved).
                logger.warning("could not read screen manifest %s (%s); "
                               "keeping it aside as .stale", path, exc)
            if (data and data.get("version") == MANIFEST_VERSION
                    and data.get("signature") == signature):
                return cls(path, signature, total_pairs,
                           completed=data.get("completed", {})), True
            if os.path.exists(path):
                try:
                    os.replace(path, path + ".stale")
                except OSError:
                    pass
        return cls(path, signature, total_pairs), False

    def mark_done(self, pid: str, record: Dict) -> None:
        self.completed[pid] = record
        self._dirty = True

    def discard(self, pid: str) -> bool:
        """Un-complete one work unit (True when it was completed). The
        index builder uses this when a LEDGER-complete partition's shard
        turns out corrupt on disk: quarantine the shard, discard its
        ledger entry, and only that partition is rebuilt."""
        if pid in self.completed:
            del self.completed[pid]
            self._dirty = True
            return True
        return False

    def flush(self) -> None:
        """Atomic write; called after every decode batch and on
        preemption. A reader never sees a torn manifest."""
        if not self._dirty and os.path.exists(self.path):
            return
        payload = {
            "version": MANIFEST_VERSION,
            "signature": self.signature,
            "total_pairs": self.total_pairs,
            "num_completed": len(self.completed),
            "completed": self.completed,
        }
        artifacts.atomic_write_artifact(
            self.path, json.dumps(payload), MANIFEST_KIND,
            version=MANIFEST_VERSION,
            extra={"signature": self.signature})
        self._dirty = False

    # -- queries -----------------------------------------------------------

    def remaining(self, pairs: Sequence[Tuple[str, str]]
                  ) -> List[Tuple[str, str]]:
        return [p for p in pairs if pair_id(*p) not in self.completed]

    def records(self) -> List[Dict]:
        return list(self.completed.values())

    @property
    def done(self) -> bool:
        return len(self.completed) >= self.total_pairs
