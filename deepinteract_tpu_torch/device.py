"""Device selection for the port's entry points, and CUDA graph capture."""

from __future__ import annotations

import contextlib
import gc
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for something else. A CUDA request on a machine without a usable GPU
    raises; the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the port on the CPU")
    return dev


@contextlib.contextmanager
def graph_capture(graph: "torch.cuda.CUDAGraph", pool=None):
    """``torch.cuda.graph(graph, pool, capture_error_mode="thread_local")``
    with Python's cyclic garbage collector off until the capture has
    ended. ``torch.cuda.graph`` does not collect before it begins (only
    under ``torch.compiler.config.force_cudagraph_gc``), so a collection
    set off inside the capture by the body's allocations can free cyclic
    garbage that owns other CUDA graphs (a closed engine's inventory).
    Destroying a graph in the capturing thread is an operation CUDA
    forbids during a capture, and it invalidates the capture
    (``cudaErrorStreamCaptureInvalidated``). With the collector off, such
    garbage is freed after the capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            yield
    finally:
        if enabled:
            gc.enable()
