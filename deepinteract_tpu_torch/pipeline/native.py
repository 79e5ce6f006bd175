"""ctypes bridge to the native geometry kernels (``native/geomfeats.cpp``).

Port of ``deepinteract_tpu/pipeline/native.py`` with the port's own copy
of the C++ source. These are host kernels (SASA and depth, residue
min-distance matrices, the protrusion index), not device kernels: the
featurizer runs on the CPU in both packages.

The shared library is compiled on first use with the system C++ compiler
(``$CXX``, else ``g++``; ``-O3 -shared -fPIC -std=c++17``) into
``deepinteract_tpu_torch/_build/geomfeats-<digest>.so``, where the digest
covers the compiler, the flags and the source. So a checkout whose files
carry any mtimes (a ``git archive``) builds once and an edited source
rebuilds, as the CUDA kernels of ``ops/cuda_attention.py`` are built.
Every kernel has a vectorized numpy fallback in
:mod:`deepinteract_tpu_torch.pipeline.residue_features`; ``available()``
lets callers pick, and the parity tests drive both paths on the same
inputs.

Fault tolerance: the compiler subprocess is retried with backoff on
transient failures (OOM-killed cc1plus, shared-filesystem hiccups,
timeouts; ``robustness/retry.py``); a missing compiler or a genuine
compile error is permanent and fails once. A failure latches
``available() -> False`` for the process lifetime with the reason logged
once and counted in ``di_native_compile_total{outcome="failure"}``;
:func:`reset` clears the latch after the environment is fixed.
``DI_DISABLE_NATIVE`` forces the numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from deepinteract_tpu_torch.obs import metrics as obs_metrics
from deepinteract_tpu_torch.robustness import faults
from deepinteract_tpu_torch.robustness.retry import retry

logger = logging.getLogger(__name__)

# Compile outcomes per process (retries of transient failures are counted
# by di_retry_attempts_total{site="native.compile"}). A "failure" latches
# the numpy fallback for the process lifetime.
_COMPILE_OUTCOMES = obs_metrics.counter(
    "di_native_compile_total", "Native geometry-kernel compile outcomes",
    labelnames=("outcome",))

SOURCE = Path(__file__).resolve().parent / "native" / "geomfeats.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_disabled_reason: Optional[str] = None

_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")


def compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    """Where the library for this compiler, these flags and this source
    lives."""
    h = hashlib.sha1(" ".join((compiler(),) + CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"geomfeats-{h.hexdigest()[:12]}.so"


def _compile_retryable(exc: BaseException) -> bool:
    """FileNotFoundError (no compiler) and CalledProcessError (the source
    does not compile) are deterministic; everything else (OOM kills,
    timeouts, shared-filesystem races) is worth another attempt."""
    return not isinstance(exc, (FileNotFoundError, subprocess.CalledProcessError))


@retry(
    exceptions=(subprocess.SubprocessError, OSError),
    retryable=_compile_retryable,
    max_attempts=3,
    base_delay=0.5,
    max_delay=10.0,
    label="native.compile",
)
def _run_compiler(cmd) -> None:
    faults.maybe_raise(
        "native.compile", lambda: OSError("injected transient compile failure")
    )
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)


def _compile(lib_path: Path) -> bool:
    """Compile to a process-unique temp name, then atomically rename into
    place: concurrent builders (test workers, parallel dataset builds on a
    shared filesystem) never dlopen a half-written .so."""
    global _disabled_reason
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp_path = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [compiler(), *CXX_FLAGS, str(SOURCE), "-o", tmp_path]
    try:
        _run_compiler(cmd)
        os.replace(tmp_path, lib_path)
        _COMPILE_OUTCOMES.inc(outcome="success")
        return True
    except (subprocess.SubprocessError, OSError) as exc:
        _COMPILE_OUTCOMES.inc(outcome="failure")
        detail = exc
        if isinstance(exc, subprocess.CalledProcessError) and exc.stderr:
            detail = exc.stderr.decode(errors="replace").strip()[-500:]
        _disabled_reason = f"compile failed ({cmd[0]}): {detail}"
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _disabled_reason
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        lib_path = library_path()
        if not lib_path.exists() and not _compile(lib_path):
            _latch_failure()
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError as exc:
            # A truncated file from a crashed builder: one rebuild and
            # retry before latching the failure for the process lifetime.
            if not _compile(lib_path):
                _disabled_reason = _disabled_reason or f"dlopen failed: {exc}"
                _latch_failure()
                return None
            try:
                lib = ctypes.CDLL(str(lib_path))
            except OSError as exc2:
                _disabled_reason = f"dlopen failed after rebuild: {exc2}"
                _latch_failure()
                return None
        lib.sasa_and_depth.argtypes = [
            _f32p, _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float, _f32p, _f32p,
        ]
        lib.min_dist_matrix.argtypes = [_f32p, ctypes.c_int, _i32p, ctypes.c_int, _f32p]
        lib.cross_min_dist_matrix.argtypes = [
            _f32p, _i32p, ctypes.c_int, _f32p, _i32p, ctypes.c_int, _f32p,
        ]
        lib.protrusion_cx.argtypes = [
            _f32p, ctypes.c_int, ctypes.c_float, ctypes.c_float, _f32p,
        ]
        for fn in (lib.sasa_and_depth, lib.min_dist_matrix,
                   lib.cross_min_dist_matrix, lib.protrusion_cx):
            fn.restype = None
        _lib = lib
        return _lib


def _latch_failure() -> None:
    """Disable the native path for the rest of the process, logging why
    exactly once. Call under ``_lock``."""
    global _load_failed
    if not _load_failed:
        logger.warning(
            "native geometry kernels disabled for this process: %s — "
            "falling back to the NumPy reference path; call "
            "pipeline.native.reset() to re-attempt after fixing the "
            "environment", _disabled_reason or "unknown failure",
        )
    _load_failed = True


def reset() -> None:
    """Clear the compile/load failure latch (and any cached handle): the
    next ``available()`` or kernel call re-attempts the build."""
    global _lib, _load_failed, _disabled_reason
    with _lock:
        _lib = None
        _load_failed = False
        _disabled_reason = None


def disabled_reason() -> Optional[str]:
    """Why the native path is disabled (None when it is not)."""
    if os.environ.get("DI_DISABLE_NATIVE"):
        return "DI_DISABLE_NATIVE is set"
    return _disabled_reason if _load_failed else None


def available() -> bool:
    """True if the native library compiled and loaded (or can)."""
    if os.environ.get("DI_DISABLE_NATIVE"):
        return False
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {disabled_reason()}")
    return lib


def sasa_and_depth(coords: np.ndarray, radii: np.ndarray, n_sphere: int = 92,
                   probe: float = 1.4):
    lib = _require()
    coords = _coords(coords)
    radii = np.ascontiguousarray(radii, dtype=np.float32)
    n = coords.shape[0]
    if radii.shape != (n,):
        raise ValueError(f"radii {radii.shape} for {n} atoms")
    sasa = np.empty(n, dtype=np.float32)
    depth = np.empty(n, dtype=np.float32)
    lib.sasa_and_depth(coords, radii, n, n_sphere, probe, sasa, depth)
    return sasa, depth


def _coords(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"coordinates of shape {x.shape}, expected [n, 3]")
    return x


def _check_starts(res_start: np.ndarray, n_atoms: int) -> None:
    if res_start.ndim != 1 or res_start.size < 1 or res_start[0] != 0 \
            or res_start[-1] != n_atoms or np.any(np.diff(res_start) < 0):
        raise ValueError(f"residue offsets do not cover the {n_atoms} atoms")


def min_dist_matrix(coords: np.ndarray, res_start: np.ndarray) -> np.ndarray:
    lib = _require()
    coords = _coords(coords)
    res_start = np.ascontiguousarray(res_start, dtype=np.int32)
    _check_starts(res_start, coords.shape[0])
    n_res = res_start.shape[0] - 1
    out = np.empty((n_res, n_res), dtype=np.float32)
    lib.min_dist_matrix(coords, coords.shape[0], res_start, n_res, out)
    return out


def cross_min_dist_matrix(coords1: np.ndarray, res_start1: np.ndarray,
                          coords2: np.ndarray, res_start2: np.ndarray) -> np.ndarray:
    lib = _require()
    coords1 = _coords(coords1)
    coords2 = _coords(coords2)
    res_start1 = np.ascontiguousarray(res_start1, dtype=np.int32)
    res_start2 = np.ascontiguousarray(res_start2, dtype=np.int32)
    _check_starts(res_start1, coords1.shape[0])
    _check_starts(res_start2, coords2.shape[0])
    n1, n2 = res_start1.shape[0] - 1, res_start2.shape[0] - 1
    out = np.empty((n1, n2), dtype=np.float32)
    lib.cross_min_dist_matrix(coords1, res_start1, n1, coords2, res_start2, n2, out)
    return out


def protrusion_cx(coords: np.ndarray, radius: float = 10.0,
                  atom_volume: float = 20.1) -> np.ndarray:
    lib = _require()
    coords = _coords(coords)
    out = np.empty(coords.shape[0], dtype=np.float32)
    lib.protrusion_cx(coords, coords.shape[0], radius, atom_volume, out)
    return out
