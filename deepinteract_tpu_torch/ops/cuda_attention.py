"""Kernels K1 and K2: the fused scatter-mode edge attention, forward and
backward, as CUDA C++.

K1 replaces the TPU kernel ``_kernel`` and K2 replaces ``_bwd_kernel`` of
``deepinteract_tpu/ops/pallas_attention.py`` (launched by
``_pallas_forward`` / ``_pallas_backward``). The sources are
``csrc/edge_attention_fwd.cu`` and ``csrc/edge_attention_bwd.cu`` (with
``csrc/edge_attention_common.cuh``); their header notes give the bound
(bytes) and the design. Each is compiled at first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface in
``deepinteract_tpu_torch/_build/`` and loaded with ctypes.

Both kernels find a node's in-edges through an in-edge CSR
(:func:`in_edge_csr`), index bookkeeping in plain torch that
:func:`attention_graph` builds once per encode and every GT layer and K2
share. :func:`edge_attention_forward` (K1) and
:func:`edge_attention_backward` (K2) are the wrappers. For CPU tensors
each runs its plain version in :mod:`deepinteract_tpu_torch.ops.attention`;
for CUDA tensors it launches the kernel or raises. ``.launches`` on each
counts kernel launches, ``in_edge_csr.builds`` counts CSR builds.
:class:`EdgeAttention` joins them under ``torch.autograd``, as
``edge_attention_pallas``'s ``custom_vjp`` does in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from deepinteract_tpu_torch.ops import attention as plain

_PKG = Path(__file__).resolve().parents[1]
SOURCES = {path.stem: path for path in sorted((_PKG / "csrc").glob("*.cu"))}
HEADERS = sorted((_PKG / "csrc").glob("*.cuh"))
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_WIDTH = 4096  # H*D: the kernels' widest head (block heads, csrc/edge_attention_common.cuh)

_ptr, _int = ctypes.c_void_p, ctypes.c_int
# C entry point of each library: (symbol, argument types).
_ENTRY = {
    "edge_attention_fwd": ("di_edge_attention_fwd", [_ptr] * 10 + [_int] * 6 + [_ptr]),
    "edge_attention_bwd": ("di_edge_attention_bwd", [_ptr] * 17 + [_int] * 6 + [_ptr]),
}
_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the edge-attention kernels")


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in (*SOURCES.values(), *HEADERS):
        h.update(path.name.encode() + path.read_bytes())
    return h.hexdigest()[:12]


def build() -> dict:
    """Compile every kernel library under ``csrc/`` that is not built yet,
    one ``nvcc`` per source, all started together.

    Library names carry a hash of all sources, headers and flags, so any
    edited file rebuilds them all. Returns ``{name: {"path", "seconds",
    "log"}}``: ``seconds`` is 0.0 and ``log`` empty for a library that was
    found built; ``log`` holds nvcc's output (with ``-Xptxas -v``:
    registers, shared memory, spills). Raises if any build fails."""
    digest = _digest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, {}
    t0 = time.perf_counter()
    for name, source in SOURCES.items():
        path = BUILD_DIR / f"{name}-{digest}.so"
        out[name] = {"path": str(path), "seconds": 0.0, "log": ""}
        if not path.exists():
            tmp = path.with_suffix(f".{os.getpid()}.tmp.so")
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            running[name] = (proc, tmp, path)
    failed = []
    for name, (proc, tmp, path) in running.items():
        log, _ = proc.communicate()
        out[name].update(seconds=time.perf_counter() - t0, log=log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {SOURCES[name].name}:\n{log}")
        else:
            os.replace(tmp, path)  # atomic: concurrent builders never load a torn file
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def _library(name: str):
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build()[name]["path"])
        symbol, argtypes = _ENTRY[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.di_cuda_error_string.argtypes = [ctypes.c_int]
        lib.di_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _launch(name: str, device: torch.device, *args) -> None:
    """Call kernel library ``name``'s C entry point on ``device``'s current
    stream; raise if the launch was refused."""
    lib = _library(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(lib, _ENTRY[name][0])(*args, stream)
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.di_cuda_error_string(status).decode()}")


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(q, k, v, proj_e, nbr_idx, edge_mask) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, N, H, D], got {tuple(q.shape)}")
    b, n, h, d = q.shape
    kk = nbr_idx.shape[-1]
    for name, t, shape, dtype in (
            ("q", q, (b, n, h, d), q.dtype), ("k", k, (b, n, h, d), q.dtype),
            ("v", v, (b, n, h, d), q.dtype), ("proj_e", proj_e, (b, n, kk, h, d), q.dtype),
            ("nbr_idx", nbr_idx, (b, n, kk), torch.int32),
            ("edge_mask", edge_mask, (b, n, kk), torch.float32)):
        _check(name, t, shape, dtype, q.device)
    if h * d > MAX_WIDTH:
        raise ValueError(f"H*D = {h * d} exceeds the kernels' bound of {MAX_WIDTH} elements "
                         "per node row")


def _outputs(out, specs, device):
    """Allocate the outputs ``specs`` ((shape, dtype), ...), or check the
    caller's buffers against them."""
    if out is None:
        return tuple(torch.empty(s, dtype=dt, device=device) for s, dt in specs)
    for t, (s, dt) in zip(out, specs):
        _check("output buffer", t, s, dt, device)
    return tuple(out)


def in_edge_csr(nbr_idx: torch.Tensor):
    """The in-edge CSR of kNN graphs nbr_idx [B, N, K] (edge (i, k) of graph
    b goes to nbr_idx[b, i, k]): (in_ptr [B, N+1], in_eid [B, N*K]), both
    int32 on nbr_idx's device. ``in_eid[b, in_ptr[b, n]:in_ptr[b, n+1]]``
    holds the flat ids i*K + k of graph b's edges into node n, in ascending
    edge id: a stable sort of nbr per graph, then the count of entries
    below each node. Deterministic. Every entry of nbr_idx must lie in
    [0, N); padded nodes point at themselves, so every edge then appears
    exactly once.

    Index bookkeeping, not the kernels' work: built once per encode
    (:func:`attention_graph`) and shared by every K1 and K2 launch of it.
    The sort runs on 16-bit keys where N allows: past 4096 edges torch
    sorts by radix passes, and half the key bits halve them.
    ``in_edge_csr.builds`` counts the builds."""
    b, n, kk = nbr_idx.shape
    key = torch.int16 if n < torch.iinfo(torch.int16).max else torch.int32
    dst, in_eid = torch.sort(nbr_idx.reshape(b, n * kk).to(key), dim=1, stable=True)
    nodes = torch.arange(n + 1, dtype=key, device=nbr_idx.device)
    in_ptr = torch.searchsorted(dst, nodes.expand(b, n + 1).contiguous(), out_int32=True)
    in_edge_csr.builds += 1
    return in_ptr, in_eid.to(torch.int32)


in_edge_csr.builds = 0


class AttentionGraph(NamedTuple):
    """A graph's edge index in the kernels' layout, prepared once per
    encode: nbr_idx [B, N, K] int32 and edge_mask [B, N, K] float32
    (contiguous), and the in-edge CSR (:func:`in_edge_csr`) where the
    kernels will run, else None."""

    nbr_idx: torch.Tensor
    edge_mask: torch.Tensor
    in_edges: tuple | None


def attention_graph(nbr_idx, edge_mask) -> AttentionGraph:
    """Cast a graph's index and mask for the kernels and, on CUDA tensors,
    build its in-edge CSR; on CPU tensors the wrappers run the plain
    versions, which need none."""
    nbr = nbr_idx.to(torch.int32).contiguous()
    return AttentionGraph(nbr, edge_mask.to(torch.float32).contiguous(),
                          in_edge_csr(nbr) if _on_cuda(nbr) else None)


def _csr(nbr_idx, in_edges, device):
    """The caller's CSR, checked, or one built here."""
    if in_edges is None:
        return in_edge_csr(nbr_idx)
    b, n, kk = nbr_idx.shape
    in_ptr, in_eid = in_edges
    _check("in_ptr", in_ptr, (b, n + 1), torch.int32, device)
    _check("in_eid", in_eid, (b, n * kk), torch.int32, device)
    return in_ptr, in_eid


def edge_attention_forward(q, k, v, proj_e, nbr_idx, edge_mask, out=None, in_edges=None):
    """K1: fused scatter-mode edge-attention forward, in the layout of
    ``_pallas_forward``: q/k/v [B, N, H, D] and proj_e [B, N, K, H, D]
    (float32 or bfloat16), nbr_idx [B, N, K] int32, edge_mask [B, N, K]
    float32. Returns (h [B, N, H, D] float32, e_out [B, N, K, H, D] in the
    input dtype, z [B, N, H*D] float32).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. The outputs carry no autograd history: with grad enabled and an
    input that requires grad, a CUDA call raises, and
    :class:`EdgeAttention` is the differentiable entry. ``in_edges`` is
    nbr_idx's in-edge CSR (:func:`in_edge_csr`); None builds it here.
    ``out`` optionally gives the three output buffers on the card (a check
    can pre-fill them with NaN, so that an element the kernel leaves
    unwritten shows)."""
    if not _on_cuda(q):
        return plain.edge_attention_forward(q, k, v, proj_e, nbr_idx, edge_mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, proj_e)):
        raise RuntimeError("edge_attention_forward gives no gradients: use "
                           "EdgeAttention.apply for inputs that require grad")
    _check_inputs(q, k, v, proj_e, nbr_idx, edge_mask)
    in_ptr, in_eid = _csr(nbr_idx, in_edges, q.device)
    b, n, h, d = q.shape
    kk = nbr_idx.shape[-1]
    h_out, e_out, z_out = _outputs(out, (((b, n, h, d), torch.float32),
                                         ((b, n, kk, h, d), q.dtype),
                                         ((b, n, h * d), torch.float32)), q.device)
    _launch("edge_attention_fwd", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), proj_e.data_ptr(), in_ptr.data_ptr(),
            in_eid.data_ptr(), edge_mask.data_ptr(), h_out.data_ptr(), e_out.data_ptr(),
            z_out.data_ptr(), b, n, kk, h, d, int(q.dtype == torch.bfloat16))
    edge_attention_forward.launches += 1
    return h_out, e_out, z_out


edge_attention_forward.launches = 0


def edge_attention_backward(q, k, v, proj_e, nbr_idx, edge_mask, h, z, dh, de=None,
                            out=None, in_edges=None):
    """K2: gradient of K1's (h, e_out) with respect to (q, k, v, proj_e),
    in the layout of ``_pallas_backward``: the forward's inputs, its
    residuals h [B, N, H, D] and z [B, N, H*D] (float32), the cotangents
    dh [B, N, H, D] (float32) and de [B, N, K, H, D] (input dtype; None
    means zero, and the kernel then reads none). Returns (dq, dk, dv, dpe)
    in the input dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (two
    passes, one count) or raise. ``in_edges`` is nbr_idx's in-edge CSR, as
    for K1; None builds it here. ``out`` optionally gives the four output
    buffers on the card."""
    if not _on_cuda(q):
        return plain.edge_attention_backward(q, k, v, proj_e, nbr_idx, edge_mask, h, z,
                                             dh, de)
    _check_inputs(q, k, v, proj_e, nbr_idx, edge_mask)
    in_ptr, in_eid = _csr(nbr_idx, in_edges, q.device)
    b, n, hh, d = q.shape
    kk = nbr_idx.shape[-1]
    node, edge = (b, n, hh, d), (b, n, kk, hh, d)
    for name, t, shape, dtype in (("h", h, node, torch.float32),
                                  ("z", z, (b, n, hh * d), torch.float32),
                                  ("dh", dh, node, torch.float32)):
        _check(name, t, shape, dtype, q.device)
    if de is not None:
        _check("de", de, edge, q.dtype, q.device)
    dq, dk, dv, dpe = _outputs(out, ((node, q.dtype),) * 3 + ((edge, q.dtype),), q.device)
    # Pass A's per-(edge, head) dsum, read back by pass B.
    dsum = torch.empty((b, n * kk, hh), dtype=torch.float32, device=q.device)
    _launch("edge_attention_bwd", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), proj_e.data_ptr(),
            nbr_idx.data_ptr(), edge_mask.data_ptr(), in_ptr.data_ptr(), in_eid.data_ptr(),
            h.data_ptr(), z.data_ptr(), dh.data_ptr(),
            None if de is None else de.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dpe.data_ptr(), dsum.data_ptr(),
            b, n, kk, hh, d, int(q.dtype == torch.bfloat16))
    edge_attention_backward.launches += 1
    return dq, dk, dv, dpe


edge_attention_backward.launches = 0


class EdgeAttention(torch.autograd.Function):
    """Differentiable fused edge attention: K1 forward, K2 backward (their
    plain versions for CPU tensors). ``apply(q, k, v, proj_e, nbr_idx,
    edge_mask, in_ptr=None, in_eid=None)`` returns (h [B, N, H, D] float32,
    e_out in the input dtype), as ``edge_attention_pallas``. in_ptr and
    in_eid are nbr_idx's in-edge CSR (:func:`in_edge_csr`); when absent on
    CUDA tensors the forward builds it, and either way K1 and K2 use the
    same one. The residuals are the ones ``_fwd`` saves: the inputs, h and
    z. An output whose cotangent never arrives (the final GT layer drops
    e_out) reaches the backward as None, not as a tensor of zeros."""

    @staticmethod
    def forward(ctx, q, k, v, proj_e, nbr_idx, edge_mask, in_ptr=None, in_eid=None):
        if in_ptr is None and _on_cuda(q):
            in_ptr, in_eid = in_edge_csr(nbr_idx)
        in_edges = None if in_ptr is None else (in_ptr, in_eid)
        h, e_out, z = edge_attention_forward(q, k, v, proj_e, nbr_idx, edge_mask,
                                             in_edges=in_edges)
        ctx.save_for_backward(q, k, v, proj_e, nbr_idx, edge_mask, h, z, in_ptr, in_eid)
        ctx.set_materialize_grads(False)
        return h, e_out

    @staticmethod
    @once_differentiable
    def backward(ctx, dh, de):
        q, k, v, proj_e, nbr_idx, edge_mask, h, z, in_ptr, in_eid = ctx.saved_tensors
        dh = torch.zeros_like(h) if dh is None else dh.float().contiguous()
        if de is not None:
            de = de.to(q.dtype).contiguous()
        in_edges = None if in_ptr is None else (in_ptr, in_eid)
        dq, dk, dv, dpe = edge_attention_backward(q, k, v, proj_e, nbr_idx, edge_mask,
                                                  h, z, dh, de, in_edges=in_edges)
        return dq, dk, dv, dpe, None, None, None, None
