"""Durable artifacts: atomic writes, integrity sidecars, verified reads,
quarantine.

Port of ``deepinteract_tpu/robustness/artifacts.py`` without its telemetry
counters. The on-disk schema is the JAX module's, byte for byte (the same
JSON fields, ``SCHEMA``, ``SIDECAR_SUFFIX`` and ``CHECKPOINT_KIND``), so
each package verifies the other's sidecars.

* :func:`atomic_write`: tmp + flush + fsync + ``os.replace`` + directory
  fsync. A reader sees the old content or the new, never a mixture; a
  crash leaves at worst an orphaned ``*.tmp`` that :func:`sweep_tmp`
  removes.
* Integrity sidecars: ``<name>.integrity.json`` holds the SHA-256, byte
  length and schema kind/version of a file (plus caller extras), or of
  every file under a directory (:func:`write_tree_sidecar`, used for
  checkpoint steps). :func:`verify_file` / :func:`verify_read` /
  :func:`verify_tree` check the bytes on disk against it before anything
  deserializes them, raising :class:`CorruptArtifact` or
  :class:`StaleArtifact`.
* :func:`quarantine` moves a corrupt artifact and its sidecar aside as
  ``<name>.corrupt-<ts>`` and logs one reason line.

The artifact is replaced first and its sidecar second; a crash between
the two leaves a stale sidecar, which verification rejects (fail-closed).

Fault sites (``robustness/faults.py``): ``storage.write`` before the tmp
is written, ``storage.fsync`` once the tmp holds the content,
``storage.replace`` before the rename, ``storage.read`` poisons a
verified read.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Union

from deepinteract_tpu_torch.robustness import faults

logger = logging.getLogger(__name__)

SCHEMA = "artifact-integrity/v1"
SIDECAR_SUFFIX = ".integrity.json"
TMP_SUFFIX = ".tmp"

# Schema kind of checkpoint-step tree sidecars. The JAX package names the
# class after orbax; the port keeps the string so that both packages label
# (and verify) a checkpoint step alike.
CHECKPOINT_KIND = "orbax-checkpoint"


class ArtifactError(RuntimeError):
    """Base of the typed artifact-integrity failures."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"{path}: {reason}")
        self.path = path
        self.reason = reason


class CorruptArtifact(ArtifactError):
    """The bytes on disk do not match the integrity sidecar (truncation,
    bit flip, torn write, unreadable sidecar). Quarantine and recover;
    never deserialize."""


class StaleArtifact(ArtifactError):
    """The artifact is intact but not the one the reader wants (schema
    kind or an ``expect`` field disagrees)."""


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def sidecar_path(path: str) -> str:
    return path + SIDECAR_SUFFIX


def fsync_dir(directory: str) -> None:
    """fsync a directory so a rename inside it is durable."""
    fd = os.open(directory or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write(path: str, data: Union[bytes, str], *, fsync: bool = True) -> None:
    """Write ``data`` to ``path`` so a reader sees the old content or the
    new, never a mixture, and (with ``fsync``) so the new content survives
    power loss once this returns. A failure part way leaves an orphaned
    ``<path>.<pid>.tmp``, as a kill would; :func:`sweep_tmp` removes it."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    faults.maybe_raise("storage.write", lambda: OSError("injected storage.write fault"))
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.{os.getpid()}{TMP_SUFFIX}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        faults.maybe_raise("storage.fsync", lambda: OSError("injected storage.fsync fault"))
        if fsync:
            os.fsync(f.fileno())
    faults.maybe_raise("storage.replace", lambda: OSError("injected storage.replace fault"))
    os.replace(tmp, path)
    if fsync:
        fsync_dir(directory)


def _write_manifest(path: str, manifest: Dict[str, Any],
                    extra: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    manifest["written_at"] = time.time()
    if extra:
        manifest["extra"] = dict(extra)
    atomic_write(sidecar_path(path), json.dumps(manifest, sort_keys=True))
    return manifest


def _file_manifest(kind: str, version: int, digest: str, nbytes: int) -> Dict[str, Any]:
    return {"schema": SCHEMA, "kind": kind, "version": int(version), "sha256": digest,
            "bytes": int(nbytes)}


def write_sidecar(path: str, kind: str, version: int = 1,
                  extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Hash an existing file and write its integrity sidecar. Returns the
    manifest."""
    return _write_manifest(path, _file_manifest(kind, version, sha256_file(path),
                                                os.path.getsize(path)), extra)


def atomic_write_artifact(path: str, data: Union[bytes, str], kind: str, version: int = 1,
                          extra: Optional[Dict[str, Any]] = None) -> None:
    """:func:`atomic_write` plus its integrity sidecar, hashed from the
    bytes in memory (one write pass, no re-read)."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    atomic_write(path, data)
    _write_manifest(path, _file_manifest(kind, version, hashlib.sha256(data).hexdigest(),
                                         len(data)), extra)


def read_sidecar(path: str) -> Optional[Dict[str, Any]]:
    """The parsed sidecar of ``path``; None when there is none;
    :class:`CorruptArtifact` when it is there but unreadable."""
    sc = sidecar_path(path)
    if not os.path.exists(sc):
        return None
    try:
        with open(sc, encoding="utf-8") as f:
            manifest = json.load(f)
    except (OSError, ValueError) as exc:
        raise CorruptArtifact(path, f"unreadable integrity sidecar: {exc}")
    if not isinstance(manifest, dict) or manifest.get("schema") != SCHEMA:
        found = manifest.get("schema") if isinstance(manifest, dict) else type(manifest).__name__
        raise CorruptArtifact(path, f"sidecar schema {found!r} != {SCHEMA}")
    return manifest


def _check_identity(path: str, manifest: Dict[str, Any], kind: Optional[str],
                    expect: Optional[Dict[str, Any]] = None) -> None:
    if kind is not None and manifest.get("kind") != kind:
        raise StaleArtifact(path, f"kind {manifest.get('kind')!r} != expected {kind!r}")
    for key, want in (expect or {}).items():
        got = (manifest.get("extra") or {}).get(key)
        if got != want:
            raise StaleArtifact(path, f"{key} {got!r} != expected {want!r}")


def _check_manifest(path: str, manifest: Dict[str, Any], kind: Optional[str],
                    expect: Optional[Dict[str, Any]], size: int, digest: str) -> None:
    _check_identity(path, manifest, kind, expect)
    if size != manifest.get("bytes"):
        raise CorruptArtifact(path, f"truncated: {size} bytes on disk, sidecar recorded "
                                    f"{manifest.get('bytes')}")
    if digest != manifest.get("sha256"):
        raise CorruptArtifact(path, f"sha256 mismatch: {digest[:12]}… on disk, sidecar "
                                    f"recorded {str(manifest.get('sha256'))[:12]}…")


def _sidecar_or_none(path: str, require_sidecar: bool) -> Optional[Dict[str, Any]]:
    if faults.fire("storage.read"):
        raise CorruptArtifact(path, "injected storage.read corruption")
    manifest = read_sidecar(path)
    if manifest is None and require_sidecar:
        raise CorruptArtifact(path, "integrity sidecar missing")
    return manifest


def verify_file(path: str, kind: Optional[str] = None, *, require_sidecar: bool = True,
                expect: Optional[Dict[str, Any]] = None) -> Optional[Dict[str, Any]]:
    """Check ``path`` against its sidecar with a streamed hash. Returns the
    manifest, or None when there is no sidecar and ``require_sidecar`` is
    False. Raises FileNotFoundError, :class:`CorruptArtifact` or
    :class:`StaleArtifact`."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    manifest = _sidecar_or_none(path, require_sidecar)
    if manifest is not None:
        _check_manifest(path, manifest, kind, expect, os.path.getsize(path), sha256_file(path))
    return manifest


def verify_read(path: str, kind: Optional[str] = None, *, require_sidecar: bool = True,
                expect: Optional[Dict[str, Any]] = None) -> bytes:
    """Read the artifact once and verify exactly those bytes; returns them."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    manifest = _sidecar_or_none(path, require_sidecar)
    with open(path, "rb") as f:
        data = f.read()
    if manifest is not None:
        _check_manifest(path, manifest, kind, expect, len(data),
                        hashlib.sha256(data).hexdigest())
    return data


def verify_json(path: str, kind: Optional[str] = None, *, require_sidecar: bool = True,
                expect: Optional[Dict[str, Any]] = None) -> Any:
    """Verified read + JSON decode; a decode failure is a CorruptArtifact."""
    raw = verify_read(path, kind, require_sidecar=require_sidecar, expect=expect)
    try:
        return json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as exc:
        raise CorruptArtifact(path, f"verified bytes are not JSON: {exc}")


def _tree_files(dir_path: str) -> Dict[str, str]:
    out = {}
    for root, _dirs, files in os.walk(dir_path):
        for name in files:
            p = os.path.join(root, name)
            out[os.path.relpath(p, dir_path).replace(os.sep, "/")] = p
    return out


def write_tree_sidecar(dir_path: str, kind: str, version: int = 1,
                       extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Integrity sidecar of a directory artifact: SHA-256 and length of
    every file under it, written beside it as ``<dir>.integrity.json``."""
    files = {rel: {"sha256": sha256_file(p), "bytes": os.path.getsize(p)}
             for rel, p in sorted(_tree_files(dir_path).items())}
    manifest = {"schema": SCHEMA, "kind": kind, "version": int(version), "tree": True,
                "files": files, "bytes": sum(e["bytes"] for e in files.values())}
    return _write_manifest(dir_path, manifest, extra)


def verify_tree(dir_path: str, kind: Optional[str] = None, *,
                require_sidecar: bool = True) -> Optional[Dict[str, Any]]:
    """Verify every file of a directory artifact against its tree sidecar:
    missing, truncated, altered and unexpected extra files all raise
    :class:`CorruptArtifact`."""
    if not os.path.isdir(dir_path):
        raise FileNotFoundError(dir_path)
    manifest = _sidecar_or_none(dir_path, require_sidecar)
    if manifest is None:
        return None
    _check_identity(dir_path, manifest, kind)
    recorded = manifest.get("files")
    if not isinstance(recorded, dict):
        raise CorruptArtifact(dir_path, "sidecar carries no file map")
    on_disk = _tree_files(dir_path)
    missing = sorted(set(recorded) - set(on_disk))
    if missing:
        raise CorruptArtifact(dir_path, f"{len(missing)} recorded file(s) missing "
                                        f"(first: {missing[0]})")
    extra_files = sorted(set(on_disk) - set(recorded))
    if extra_files:
        raise CorruptArtifact(dir_path, f"{len(extra_files)} file(s) not in the sidecar "
                                        f"(first: {extra_files[0]}) — partial overwrite?")
    for rel, entry in recorded.items():
        p = on_disk[rel]
        size = os.path.getsize(p)
        if size != entry.get("bytes"):
            raise CorruptArtifact(dir_path, f"{rel}: truncated ({size} bytes vs recorded "
                                            f"{entry.get('bytes')})")
        if sha256_file(p) != entry.get("sha256"):
            raise CorruptArtifact(dir_path, f"{rel}: sha256 mismatch")
    return manifest


def quarantine(path: str, kind: str, reason: str) -> Optional[str]:
    """Move a corrupt artifact (file or directory) and its sidecar aside as
    ``<name>.corrupt-<ts>`` and log the reason. Returns the new path, or
    None when the move failed (the corruption is still logged)."""
    ts = int(time.time())
    dest = f"{path}.corrupt-{ts}"
    n = 0
    while os.path.exists(dest):
        n += 1
        dest = f"{path}.corrupt-{ts}.{n}"
    try:
        os.replace(path, dest)
    except OSError as exc:
        logger.error("corrupt artifact %s (%s): %s — quarantine move FAILED: %s",
                     path, kind, reason, exc)
        return None
    sc = sidecar_path(path)
    if os.path.exists(sc):
        try:
            os.replace(sc, sidecar_path(dest))
        except OSError:  # the payload is aside already; the orphan stays
            pass
    logger.error("corrupt artifact %s (%s): %s — quarantined to %s", path, kind, reason, dest)
    return dest


def sweep_tmp(directory: str, prefix: str = "", contains: str = "") -> List[str]:
    """Remove orphaned ``*.tmp`` files of killed writers directly under
    ``directory``, restricted to names starting with ``prefix`` and
    containing ``contains``. Returns the removed paths; never raises on a
    single file."""
    removed: List[str] = []
    try:
        names = os.listdir(directory)
    except OSError:
        return removed
    for name in names:
        if not name.endswith(TMP_SUFFIX) or not name.startswith(prefix) or contains not in name:
            continue
        p = os.path.join(directory, name)
        if not os.path.isfile(p):
            continue
        try:
            os.unlink(p)
        except OSError:
            continue
        removed.append(p)
    if removed:
        logger.warning("swept %d orphaned tmp file(s) under %s", len(removed), directory)
    return removed
