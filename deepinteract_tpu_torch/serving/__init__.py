"""Persistent serving layer: resident engine with one CUDA graph per shape
bucket, micro-batching, admission control, result cache and HTTP API.

Port of the single-engine part of ``deepinteract_tpu/serving/``: the
production counterpart of the one-shot ``cli/predict.py`` path. See
``engine.py`` for the amortization model, ``graphs.py`` for the graph
cache and ``server.py`` for the wire protocol.

Exports resolve lazily (PEP 562): importing the package does not pull
``engine`` (and with it the model) until an engine-side name is touched.
"""

# name -> submodule it lazily resolves from.
_EXPORTS = {
    "AdmissionController": "admission",
    "BatchExecutionError": "admission",
    "Deadline": "admission",
    "DeadlineExceeded": "admission",
    "LoadShedder": "admission",
    "Overloaded": "admission",
    "ShedderConfig": "admission",
    "ShuttingDown": "admission",
    "ResultCache": "cache",
    "content_hash": "cache",
    "EngineConfig": "engine",
    "InferenceEngine": "engine",
    "MicroBatchScheduler": "scheduler",
    "SchedulerClosed": "scheduler",
    "ServingServer": "server",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    try:
        modname = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    module = importlib.import_module(f"{__name__}.{modname}")
    value = getattr(module, name)
    globals()[name] = value  # cache: next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
