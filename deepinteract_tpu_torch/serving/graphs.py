"""One CUDA graph per serving key: the engine's executable cache on the card.

The JAX engine keeps one AOT-compiled executable per ``(bucket_n1,
bucket_n2, per-graph shape signature, batch)`` key and never retraces a
warm key (``deepinteract_tpu/serving/engine.py:664-714``, ``_compiled``).
Its counterpart here is a :class:`GraphEntry`: the whole served forward,
``softmax(model(g1, g2))[..., 1]`` (both siamese encodes with K1 in every
GT layer, the in-edge CSR builds, the decode and the softmax), captured
once per key with ``torch.cuda.graph`` and replayed for every dispatch.
The split phase of bulk screening (``deepinteract_tpu/serving/engine.py:
555-638``) adds two more kinds of key in the same inventory: a chain
bucket's encode (:func:`encode_forward`: K1 in every GT layer and the
CSR build, float32 features out) and a bucket pair's decode
(:func:`decode_forward`: stem, decoder and softmax over features).

A replay issues every kernel of the forward with one host call, against
eager PyTorch's one Python dispatch per op. What a capture bakes in:

* **inputs**: static device buffers for the key's inputs (the stacked
  ``ProteinGraph`` pair, one chain batch, or features and masks) at its
  padded shapes and slot count; :meth:`GraphEntry.replay` ``copy_``-s
  each batch into them. The in-edge CSR is rebuilt from the
  static ``nbr_idx`` inside the graph on every replay (a stable
  ``torch.sort`` and ``searchsorted``, neither of which syncs).
* **global state**: eval mode and the precision policy
  (``set_backend_precision``: TF32 off under float32) are set before the
  capture; a graph captured with TF32 on would keep it.
* **kernel launches**: K1's ctypes launches go to the current stream,
  which inside ``torch.cuda.graph`` is the capture stream. The Python
  launch counters (``edge_attention_forward.launches``,
  ``edge_attention_backward.launches``, ``in_edge_csr.builds``) run at
  capture, not at replay: an entry records the counts of its capture, and
  ``replays`` counts its replays.

Warm-up runs on a side stream precede each capture, as PyTorch requires
(cuBLAS and cuDNN set up their workspaces there, and K1's library is
loaded). Captures use ``capture_error_mode="thread_local"``: the engine
captures on whichever thread first needs a key (the caller of ``warmup``
or the scheduler's worker) while other threads of the process may use the
card, and only this thread's calls must be capture-safe.

All entries allocate from one memory pool (``torch.cuda.graph_pool_handle``).
That is safe because the engine serializes replays under its lock and
copies each output to the host before releasing it: a later replay of any
key may overwrite an earlier key's output buffer. A capture that fails
raises; the key is never run eagerly instead.

:class:`EagerEntry` is the same interface for the CPU, where nothing is
captured: its replay runs the forward eagerly (through the plain
attention, as every CPU path of the port).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from deepinteract_tpu_torch.data.graph import ProteinGraph
from deepinteract_tpu_torch.device import graph_capture
from deepinteract_tpu_torch.models.policy import set_backend_precision
from deepinteract_tpu_torch.ops import cuda_attention

WARMUP_RUNS = 2  # eager runs on a side stream before each capture


def serve_forward(model, graph1: ProteinGraph, graph2: ProteinGraph) -> torch.Tensor:
    """The served function: [B, L1, L2] float32 positive-class probabilities."""
    return torch.softmax(model(graph1, graph2), dim=-1)[..., 1]


def encode_forward(model, graph: ProteinGraph) -> torch.Tensor:
    """The split phase's encode: [B, N, C] **float32** chain features,
    whatever the compute policy (the JAX engine's ``_encode`` casts the
    same way; ``decode`` casts them back, and bf16 -> f32 -> bf16 is
    exact)."""
    return model.encode(graph)[0].float()


def decode_forward(model, feats1: torch.Tensor, feats2: torch.Tensor,
                   mask1: torch.Tensor, mask2: torch.Tensor) -> torch.Tensor:
    """The split phase's decode: [B, L1, L2] float32 positive-class
    probabilities from encoded features and node masks. ``serve_forward``
    is exactly ``decode_forward`` of two ``encode_forward``-s (f32)."""
    return torch.softmax(model.decode(feats1, feats2, mask1, mask2), dim=-1)[..., 1]


def _to_static(x, device):
    if isinstance(x, ProteinGraph):
        return ProteinGraph(**{f.name: getattr(x, f.name).to(device, copy=True)
                               for f in dataclasses.fields(x)})
    return x.to(device, copy=True)


def _copy_into(static, new) -> None:
    pairs = ([(f.name, getattr(static, f.name), getattr(new, f.name))
              for f in dataclasses.fields(ProteinGraph)] if isinstance(static, ProteinGraph)
             else [("input", static, new)])
    for name, dst, src in pairs:
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(f"{name}: batch has {src.dtype} {tuple(src.shape)}, the "
                             f"graph was captured for {dst.dtype} {tuple(dst.shape)}")
        dst.copy_(src)


class EagerEntry:
    """A key on the CPU: no capture (``seconds`` is 0); each replay runs
    ``fn(model, *inputs)`` eagerly."""

    def __init__(self, model, fn=serve_forward):
        self.model = model
        self.fn = fn
        self.seconds = 0.0
        self.k1_launches = 0
        self.k2_launches = 0
        self.csr_builds = 0
        self.replays = 0

    def replay(self, *inputs) -> torch.Tensor:
        with torch.inference_mode():
            out = self.fn(self.model, *inputs)
        self.replays += 1
        return out


class GraphEntry:
    """One key on the card: static inputs, a captured graph, its output.

    ``inputs`` are the arguments of ``fn(model, *inputs)`` at the key's
    shapes (stacked ``ProteinGraph`` batches or tensors, on any device;
    :meth:`replay` takes the same kinds):
    they size the static buffers and feed the warm-up runs. ``fn`` is
    :func:`serve_forward` (a request key), :func:`encode_forward` or
    :func:`decode_forward` (the split phase). ``seconds`` is the capture
    wall (warm-up runs and capture); ``k1_launches``, ``k2_launches`` and
    ``csr_builds`` are the counters' moves during the capture alone."""

    def __init__(self, model, inputs: tuple, pool, fn=serve_forward):
        device = next(model.parameters()).device
        if device.type != "cuda":
            raise ValueError(f"GraphEntry needs a model on a CUDA device, got {device}")
        t0 = time.perf_counter()
        model.eval()
        set_backend_precision(model.cfg.gnn.compute_dtype)
        self.model = model
        self.fn = fn
        self.static = tuple(_to_static(x, device) for x in inputs)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side), torch.inference_mode():
            for _ in range(WARMUP_RUNS):
                fn(model, *self.static)
        torch.cuda.current_stream(device).wait_stream(side)
        k1 = cuda_attention.edge_attention_forward.launches
        k2 = cuda_attention.edge_attention_backward.launches
        builds = cuda_attention.in_edge_csr.builds
        self.graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), graph_capture(self.graph, pool):
            self.output = fn(model, *self.static)
        self.k1_launches = cuda_attention.edge_attention_forward.launches - k1
        self.k2_launches = cuda_attention.edge_attention_backward.launches - k2
        self.csr_builds = cuda_attention.in_edge_csr.builds - builds
        self.seconds = time.perf_counter() - t0
        self.replays = 0

    def replay(self, *inputs) -> torch.Tensor:
        """Copy the inputs into the static buffers and replay. Returns the
        static output: valid until the next replay of any entry that
        shares the pool."""
        with torch.inference_mode():
            for static, new in zip(self.static, inputs, strict=True):
                _copy_into(static, new)
        self.graph.replay()
        self.replays += 1
        return self.output


def make_entry(model, inputs: tuple, pool, fn=serve_forward):
    """A :class:`GraphEntry` of ``fn`` for a model on the card, an
    :class:`EagerEntry` for one on the CPU."""
    if next(model.parameters()).device.type == "cuda":
        return GraphEntry(model, inputs, pool, fn)
    return EagerEntry(model, fn)
