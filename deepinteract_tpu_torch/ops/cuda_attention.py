"""Kernel K1: the fused scatter-mode edge-attention forward as CUDA C++.

Replaces the TPU kernel ``_kernel`` of
``deepinteract_tpu/ops/pallas_attention.py`` (launched by
``_pallas_forward``). The source is ``csrc/edge_attention_fwd.cu``; its
header note gives the bound (bytes) and the design. It is compiled at
first use by ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface in ``deepinteract_tpu_torch/_build/`` and loaded with ctypes.

:func:`edge_attention_forward` is the wrapper. For CPU tensors it runs the
plain version, :func:`deepinteract_tpu_torch.ops.attention.
edge_attention_forward`; for CUDA tensors it launches the kernel or
raises. ``edge_attention_forward.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from deepinteract_tpu_torch.ops.attention import (
    edge_attention_forward as plain_edge_attention_forward,
)

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "edge_attention_fwd.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_LANES = 1024

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the edge-attention kernel")


def build() -> dict:
    """Compile the kernel library if it is not built yet.

    The library's name carries a hash of the source and flags, so an
    edited source is rebuilt. Returns ``{"path", "seconds", "log"}``:
    ``seconds`` is 0.0 and ``log`` empty when a built library was found;
    ``log`` holds nvcc's output (with ``-Xptxas -v``: registers, shared
    memory, spills)."""
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"edge_attention_fwd-{digest}.so"
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {SOURCE.name}:\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never load a torn file
    return {"path": str(out), "seconds": seconds, "log": log}


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        fn = lib.di_edge_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.di_cuda_error_string.argtypes = [ctypes.c_int]
        lib.di_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def _check_inputs(q, k, v, proj_e, nbr_idx, edge_mask) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, N, H, D], got {tuple(q.shape)}")
    b, n, h, d = q.shape
    kk = nbr_idx.shape[-1]
    expected = {
        "k": (k, (b, n, h, d), q.dtype), "v": (v, (b, n, h, d), q.dtype),
        "proj_e": (proj_e, (b, n, kk, h, d), q.dtype),
        "nbr_idx": (nbr_idx, (b, n, kk), torch.int32),
        "edge_mask": (edge_mask, (b, n, kk), torch.float32),
    }
    for name, (t, shape, dtype) in expected.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), *((n_, t) for n_, (t, _, _) in expected.items())):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d > 32 or d & (d - 1):
        raise ValueError(f"head dim {d} must be a power of two <= 32 (a "
                         "head's lanes must sit in one warp)")
    if h * d > MAX_LANES:
        raise ValueError(f"H*D = {h * d} exceeds {MAX_LANES} lanes")


def edge_attention_forward(q, k, v, proj_e, nbr_idx, edge_mask, out=None):
    """Fused scatter-mode edge-attention forward, in the layout of
    ``_pallas_forward``: q/k/v [B, N, H, D] and proj_e [B, N, K, H, D]
    (float32 or bfloat16), nbr_idx [B, N, K] int32, edge_mask [B, N, K]
    float32. Returns (h [B, N, H, D] float32, e_out [B, N, K, H, D] in the
    input dtype, z [B, N, H*D] float32).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise (inference only: the backward kernel is not ported). ``out``
    optionally gives the three output buffers on the card (a check can
    pre-fill them with NaN, so that an element the kernel leaves unwritten
    shows)."""
    if not _on_cuda(q):
        return plain_edge_attention_forward(q, k, v, proj_e, nbr_idx, edge_mask)
    if any(t.requires_grad for t in (q, k, v, proj_e)):
        raise NotImplementedError(
            "edge_attention_forward is inference-only on CUDA: the backward "
            "kernel K2 (deepinteract_tpu/ops/pallas_attention.py::_bwd_kernel) "
            "is not ported yet")
    _check_inputs(q, k, v, proj_e, nbr_idx, edge_mask)
    b, n, h, d = q.shape
    kk = nbr_idx.shape[-1]
    shapes = (((b, n, h, d), torch.float32), ((b, n, kk, h, d), q.dtype),
              ((b, n, h * d), torch.float32))
    if out is None:
        out = tuple(torch.empty(s, dtype=dt, device=q.device) for s, dt in shapes)
    for t, (s, dt) in zip(out, shapes):
        if tuple(t.shape) != s or t.dtype != dt or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"output buffer must be contiguous {dt} {s} on {q.device}")
    h_out, e_out, z_out = out
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.di_edge_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), proj_e.data_ptr(),
            nbr_idx.data_ptr(), edge_mask.data_ptr(), h_out.data_ptr(),
            e_out.data_ptr(), z_out.data_ptr(), b, n, kk, h, d,
            int(q.dtype == torch.bfloat16), stream)
    if status != 0:
        raise RuntimeError("edge-attention kernel launch failed: "
                           f"{lib.di_cuda_error_string(status).decode()}")
    edge_attention_forward.launches += 1
    return h_out, e_out, z_out


edge_attention_forward.launches = 0
