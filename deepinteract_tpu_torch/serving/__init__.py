"""Persistent serving layer: resident engine with one CUDA graph per shape
bucket, micro-batching, admission control, result cache, HTTP API, and the
multi-worker fleet (supervisor, router, autoscaler, stub worker).

Port of ``deepinteract_tpu/serving/``: the production counterpart of the
one-shot ``cli/predict.py`` path. See ``engine.py`` for the amortization
model, ``graphs.py`` for the graph cache, ``server.py`` for the wire
protocol and ``fleet.py`` / ``router.py`` / ``autoscaler.py`` for the
fleet.

Exports resolve lazily (PEP 562): importing the package does not pull
``engine`` (and with it torch and the model) until an engine-side name is
touched. The fleet control plane and ``worker_stub`` import no torch, so
``python -m deepinteract_tpu_torch.serving.worker_stub`` starts in a
fraction of a second, a cost every supervisor restart pays again.
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
    "Autoscaler": "autoscaler",
    "AutoscalerConfig": "autoscaler",
    "EngineConfig": "engine",
    "InferenceEngine": "engine",
    "FleetConfig": "fleet",
    "WorkerSupervisor": "fleet",
    "stub_worker_cmd": "fleet",
    "watch_parent": "fleet",
    "FleetRouter": "router",
    "RolloverBusy": "router",
    "RolloverFailed": "router",
    "RouterConfig": "router",
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
