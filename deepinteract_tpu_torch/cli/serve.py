"""Serve CLI — the resident HTTP inference engine (``deepinteract_tpu_torch.serving``).

Port of ``deepinteract_tpu/cli/serve.py``. Three modes share one flag
surface:

**Single engine** (default). A persistent process loads the weights once,
captures one CUDA graph per padded shape bucket (ahead of time with
``--warmup_buckets``), micro-batches concurrent requests per bucket, and
answers a JSON API::

    python -m deepinteract_tpu_torch.cli.serve [--ckpt_name DIR | --weights W.npz] \\
        --port 8008 --warmup_buckets 128x128x1,128x128x8

    curl -X POST --data-binary @complex.npz http://127.0.0.1:8008/predict
    curl -X POST -d '{"npz_paths": ["a.npz", "b.npz"]}' http://127.0.0.1:8008/screen
    curl http://127.0.0.1:8008/stats
    curl http://127.0.0.1:8008/metrics   # Prometheus text exposition

Runs on the GPU unless ``--device cpu`` is given (then every dispatch runs
eagerly on the CPU). SIGTERM drains in-flight requests and exits 0.

**Fleet** (``--workers N``). A supervisor/router pair
(``serving/fleet.py`` + ``serving/router.py``) in front of N
single-engine worker processes, each this CLI again with ``--workers 0``
on a free port and the same base flags (so ``--device``,
``--weights``/``--ckpt_name`` and ``--index_path`` reach every worker;
each worker captures its own graphs). Crashed workers restart with
exponential backoff (flappers trip a circuit breaker), dead-worker
requests fail over to a sibling, and ``POST /admin/rollover`` / SIGHUP
performs a zero-downtime warm rollover. The final stdout line on exit is
the machine-readable ``fleet/v1`` contract. ``--fleet_stub_workers``
swaps the engine workers for ``serving/worker_stub.py`` null engines.
``--autoscale`` adds the elastic capacity controller
(``serving/autoscaler.py``).

**Clients.** ``--rollover`` sends ``POST /admin/rollover`` to the router
at ``--host``/``--port`` (with ``--rollover_ckpt`` and
``--rollover_signature``; an HTTP body ``{"weights": W.npz}`` repoints the
replacements' ``--weights``) and exits 0 iff the rollover completed;
``--versions`` fetches ``GET /admin/versions``. Each prints the router's
record (``fleet/v1`` or ``versions/v1``) as its last stdout line.
"""

from __future__ import annotations

import json
import os
import signal
import sys
from typing import Dict, List, Optional, Tuple

from deepinteract_tpu_torch.cli.args import (add_bucket_args, add_calibration_args,
                                             add_restore_args, add_serving_args, build_parser,
                                             model_config_from_args)

# Where multi-device serving (mesh placement) is planned.
MESH_PLAN = "multi-GPU serving is ROADMAP queue 1 item 10"


def parse_warmup_spec(spec: str) -> Tuple[Tuple[int, int, int], ...]:
    """``"128x128x1,128x128x8"`` -> ((128, 128, 1), (128, 128, 8)).

    Each entry is bucket_n1 x bucket_n2 x batch; batch defaults to 1 when
    omitted (``"128x128"``)."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        dims = [int(v) for v in part.lower().split("x")]
        if len(dims) == 2:
            dims.append(1)
        if len(dims) != 3 or min(dims) < 1:
            raise ValueError(
                f"malformed warmup bucket {part!r} (want B1xB2 or B1xB2xBATCH)")
        out.append(tuple(dims))
    return tuple(out)


def warm_bucket_prefixes(spec: str, max_batch: int = 8,
                         pad_to_max_bucket: bool = False,
                         diagonal_buckets: bool = False,
                         mesh_shape: Optional[Tuple[int, int]] = None,
                         pair_shard_threshold: int = 512) -> Tuple[str, ...]:
    """Warmup specs -> the graph-inventory label prefixes a rollover
    replacement must report warm.

    Mirrors the engine's own normalization (``normalize_warmup``: the
    loader's bucket policy for the shapes, power-of-two slots capped at
    ``max_batch`` for the batch), so ``(128, 128, 8)`` requires
    ``"128x128/b8/"`` — the batch is part of readiness, or a replacement
    warm at b1 only would pass and its first b8 flush would pay a cold
    capture. Only the signature tail (``k20g2``) is left open.
    Over-top-bucket specs tile-lift inside the engine and may not match:
    a loud rollover abort, never a silent cold switch. ``mesh_shape``
    prefixes every label with ``mesh{D}x{P}/`` as the JAX engine does (a
    stub fleet rehearses it; an engine worker of this port serves 1x1)."""
    from deepinteract_tpu_torch.data.loader import make_bucket_fn
    from deepinteract_tpu_torch.serving.fleet import (batch_slots, mesh_label_prefix,
                                                      mesh_placement, parse_mesh_shape)

    shape = parse_mesh_shape(mesh_shape)
    prefix = mesh_label_prefix(shape)
    bucket_fn = make_bucket_fn(pad_to_max_bucket, diagonal_buckets)
    out = []
    for b1, b2, bs in parse_warmup_spec(spec):
        nb1, nb2 = bucket_fn(b1, b2)
        placement = mesh_placement(shape, nb1, nb2, pair_shard_threshold)
        lift = shape[0] if placement == "data" else 1
        out.append(f"{prefix}{nb1}x{nb2}/b{batch_slots(bs, max_batch, lift_to=lift)}/")
    return tuple(out)


def _without(argv: List[str], flag: str) -> List[str]:
    """``argv`` less every ``flag VALUE`` / ``flag=VALUE`` occurrence."""
    out, skip = [], False
    for arg in argv:
        if skip:
            skip = False
        elif arg == flag:
            skip = True
        elif not arg.startswith(flag + "="):
            out.append(arg)
    return out


def engine_worker_cmd_fn(argv: List[str]):
    """Worker command factory for REAL engine workers: this CLI again with
    the base argv, the fleet flags neutralized by single-engine overrides
    appended after it (argparse's last occurrence wins), the worker's port,
    heartbeat file and the supervisor's pid. Rollover ``overrides`` come
    last of all: ``{"ckpt_name": D}`` or ``{"weights": W}`` repoints the
    replacement's weights (the other source is dropped from the base, as
    the two are exclusive)."""
    base = list(argv)

    def cmd_fn(worker_id: str, port: int, heartbeat_path: str,
               overrides: Dict) -> List[str]:
        argv = base
        if overrides.get("ckpt_name"):
            argv = _without(argv, "--weights")
        if overrides.get("weights"):
            argv = _without(argv, "--ckpt_name")
        cmd = [sys.executable, "-m", "deepinteract_tpu_torch.cli.serve", *argv,
               "--workers", "0", "--host", "127.0.0.1", "--port", str(port),
               "--heartbeat_file", heartbeat_path, "--parent_pid", str(os.getpid())]
        for key in ("ckpt_name", "weights", "compute_dtype", "warmup_buckets",
                    "mesh_shape"):
            if overrides.get(key):
                cmd += [f"--{key}", str(overrides[key])]
        return cmd

    return cmd_fn


def _build_kernels(device: str) -> None:
    """Build the kernel libraries once in the control plane before any
    worker starts, so N workers that start together load the same files
    instead of running nvcc side by side."""
    from deepinteract_tpu_torch.device import resolve_device

    if resolve_device(device).type == "cuda":
        from deepinteract_tpu_torch.ops import cuda_attention

        cuda_attention.build()


def _fleet_main(args, argv: List[str], guard=None) -> int:
    """Supervisor + router. No engine in THIS process: the workers own
    theirs, so the parent stays a light control plane."""
    import tempfile

    from deepinteract_tpu_torch.serving.fleet import (FleetConfig, WorkerSupervisor,
                                                      mesh_label, parse_mesh_shape,
                                                      stub_worker_cmd)
    from deepinteract_tpu_torch.serving.router import FleetRouter, RouterConfig

    mesh_shape = parse_mesh_shape(args.mesh_shape)
    if not args.fleet_stub_workers:
        if mesh_shape != (1, 1):
            print(f"serve: --mesh_shape {args.mesh_shape}: an engine worker serves one "
                  f"device ({MESH_PLAN})", file=sys.stderr)
            return 2
        try:
            _build_kernels(args.device)
        except RuntimeError as err:
            print(f"serve: {err}", file=sys.stderr)
            return 2
    state_dir = args.fleet_dir or tempfile.mkdtemp(prefix="di_fleet_")
    cmd_fn = stub_worker_cmd if args.fleet_stub_workers else engine_worker_cmd_fn(argv)
    required_warm = warm_bucket_prefixes(
        args.warmup_buckets, max_batch=args.max_batch,
        pad_to_max_bucket=args.pad_to_max_bucket,
        diagonal_buckets=args.diagonal_buckets, mesh_shape=mesh_shape,
        pair_shard_threshold=args.pair_shard_threshold)
    base_overrides = {}
    if args.fleet_stub_workers and required_warm:
        # Stubs must REPORT the operator's warmup buckets warm, or the
        # router's rollover readiness check would wait out the warm timeout
        # and abort every rehearsal rollover on a non-default spec.
        base_overrides["warm_buckets"] = ",".join(required_warm)
    if args.fleet_stub_workers and mesh_shape != (1, 1):
        # Stubs advertise the fleet's topology, so topology-aware routing
        # and the rollover's mesh-shape proof can be rehearsed.
        base_overrides["mesh_shape"] = mesh_label(mesh_shape)
    supervisor = WorkerSupervisor(
        cmd_fn, overrides=base_overrides,
        cfg=FleetConfig(
            num_workers=args.workers,
            probe_interval_s=args.probe_interval_s,
            heartbeat_max_age_s=args.heartbeat_max_age_s,
            restart_backoff_s=args.restart_backoff_s,
            circuit_max_restarts=args.circuit_max_restarts,
            circuit_window_s=args.circuit_window_s,
            state_dir=state_dir))
    router = FleetRouter(
        supervisor, host=args.host, port=args.port,
        cfg=RouterConfig(
            proxy_timeout_s=args.request_timeout_s,
            default_deadline_ms=args.default_deadline_ms,
            required_warm_buckets=required_warm,
            required_mesh_shape=mesh_label(mesh_shape) if mesh_shape != (1, 1) else None,
            pair_bucket_threshold=args.pair_shard_threshold if mesh_shape[1] > 1 else 0,
            warm_timeout_s=args.fleet_warm_timeout_s))
    router.start()
    autoscaler = None
    if args.autoscale:
        from deepinteract_tpu_torch.serving.autoscaler import Autoscaler, AutoscalerConfig

        autoscaler = Autoscaler(
            supervisor, router,
            cfg=AutoscalerConfig(
                min_workers=args.autoscale_min_workers,
                max_workers=args.autoscale_max_workers,
                interval_s=args.autoscale_interval_s,
                queue_high=args.autoscale_queue_high,
                queue_low=args.autoscale_queue_low,
                breach_polls=args.autoscale_breach_polls,
                cooldown_s=args.autoscale_cooldown_s,
                warm_timeout_s=args.fleet_warm_timeout_s),
            overrides=dict(base_overrides))
        autoscaler.start()
    host, port = router.address
    print(f"fleet router on http://{host}:{port} ({args.workers} worker(s)"
          f"{', stub' if args.fleet_stub_workers else ''}"
          f"{', autoscaling' if autoscaler is not None else ''}; state in {state_dir})",
          flush=True)
    try:
        return router.run(guard=guard)
    finally:
        if autoscaler is not None:
            autoscaler.stop()
        print(json.dumps(router.final_contract()), flush=True)


def _rollover_main(args) -> int:
    """One-shot rollover client against a running fleet router."""
    from deepinteract_tpu_torch.serving.fleet import request_json

    body: Dict = {}
    if args.rollover_ckpt:
        body["ckpt_name"] = args.rollover_ckpt
    if args.rollover_signature:
        body["weights_signature"] = args.rollover_signature
    # The call spans the replacements' warm-up AND the old fleet's parallel
    # drain (the router's drain_timeout_s, 60 s), so budget both plus slack.
    status, record = request_json(
        args.host, args.port, "POST", "/admin/rollover", body=json.dumps(body).encode(),
        timeout_s=args.fleet_warm_timeout_s + 60.0 + args.request_timeout_s + 30.0)
    print(f"rollover answered {status}", flush=True)
    print(json.dumps(record), flush=True)
    # The exit code follows the ROLLOVER's outcome, not the fleet-wide "ok"
    # (which an unrelated flapping worker could make false).
    roll = record.get("rollover", {}) if isinstance(record, dict) else {}
    return 0 if status == 200 and roll.get("ok") else 1


def _versions_main(args) -> int:
    """One-shot versions client: the router's canary weights, workers per
    version and shadow agreement; the last stdout line is ``versions/v1``."""
    from deepinteract_tpu_torch.serving.fleet import request_json

    status, record = request_json(args.host, args.port, "GET", "/admin/versions",
                                  timeout_s=args.request_timeout_s)
    print(f"versions answered {status}", flush=True)
    print(json.dumps(record), flush=True)
    return 0 if status == 200 and isinstance(record, dict) else 1


def main(argv=None, guard=None) -> int:
    parser = build_parser(__doc__)
    add_serving_args(parser)
    add_bucket_args(parser)
    add_restore_args(parser)
    add_calibration_args(parser)
    parser.add_argument("--weights", type=str, default=None,
                        help="flat-path .npz of JAX variables (weights.save_npz)")
    args = parser.parse_args(argv)
    if args.weights and args.ckpt_name:
        parser.error("give --weights or --ckpt_name, not both")
    try:
        warmup = parse_warmup_spec(args.warmup_buckets)
    except ValueError as err:
        parser.error(str(err))

    if args.rollover:
        return _rollover_main(args)
    if args.versions:
        return _versions_main(args)
    if args.workers > 0:
        return _fleet_main(args, list(sys.argv[1:] if argv is None else argv), guard=guard)

    from deepinteract_tpu_torch.device import resolve_device
    from deepinteract_tpu_torch.obs import spans as obs_spans
    from deepinteract_tpu_torch.robustness.preemption import PreemptionGuard
    from deepinteract_tpu_torch.serving import (EngineConfig, InferenceEngine,
                                                ServingServer, ShedderConfig)
    from deepinteract_tpu_torch.serving.fleet import parse_mesh_shape, watch_parent

    if parse_mesh_shape(args.mesh_shape) != (1, 1):
        print(f"serve: --mesh_shape {args.mesh_shape}: this engine serves one device "
              f"({MESH_PLAN})", file=sys.stderr)
        return 2
    model_cfg = model_config_from_args(args)
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        print(f"serve: {err}", file=sys.stderr)
        return 2

    if args.events_out:
        # Request-scoped tracing sink: every traced request's trace_id and
        # decomposition (obs/reqtrace.py), joinable against ?trace=1.
        obs_spans.configure(args.events_out)

    # SIGTERM is honoured from here on: a worker drained while it loads its
    # weights or captures its warm-up graphs finishes that step, answers
    # nothing and exits 0 (a rollover abort drains replacements that may
    # still be warming). A hard-killed supervisor's death goes the same way.
    own_guard = guard is None
    if own_guard:
        guard = PreemptionGuard(log=lambda msg: print(f"serve: {msg}", file=sys.stderr))
        guard.__enter__()
    watch_parent(args.parent_pid, lambda: os.kill(os.getpid(), signal.SIGTERM))
    heartbeat: Optional[object] = None
    if args.heartbeat_file:
        # Started BEFORE engine construction: loading the weights and
        # capturing the warm-up graphs is the most hang-prone window, and
        # the beat thread is independent of the busy main thread.
        from deepinteract_tpu_torch.obs.heartbeat import Heartbeat

        heartbeat = Heartbeat(args.heartbeat_file, interval_s=args.heartbeat_interval_s)
        heartbeat.progress(role="engine-worker-starting")
        heartbeat.start()
    try:
        engine = InferenceEngine(
            model_cfg,
            ckpt_dir=args.ckpt_name,
            cfg=EngineConfig(
                max_batch=args.max_batch,
                max_delay_ms=args.max_delay_ms,
                warmup_buckets=warmup,
                result_cache_size=args.result_cache_size,
                diagonal_buckets=args.diagonal_buckets,
                pad_to_max_bucket=args.pad_to_max_bucket,
                input_indep=args.input_indep,
                max_queue_depth=args.max_queue_depth,
                max_inflight=args.max_inflight,
            ),
            seed=args.seed,
            metric_to_track=args.metric_to_track,
            device=device,
            weights=args.weights,
        )
        server = ServingServer(
            engine, host=args.host, port=args.port,
            request_timeout_s=args.request_timeout_s,
            screen_max_pairs=args.screen_max_pairs,
            default_deadline_ms=args.default_deadline_ms,
            index_path=args.index_path,
            calibration_path=args.calibration,
            shedder_cfg=ShedderConfig(
                enabled=not args.no_load_shedding,
                enter_utilization=args.shed_enter_util,
                exit_utilization=args.shed_exit_util,
                min_degraded_s=args.shed_min_degraded_s,
            ),
        )
        host, port = server.address
        print(f"serving on http://{host}:{port} "
              f"(buckets warm: {engine.stats()['num_compiled_executables']})", flush=True)
        if heartbeat is not None:
            # The beat carries the served weights' identity, so a
            # stale-vs-wrong-weights worker is diagnosable from the file.
            heartbeat.progress(role="engine-worker", port=port,
                               weights_signature=engine.weights_signature())
        return server.run(guard=guard)
    finally:
        if own_guard:
            guard.__exit__(None, None, None)
        if heartbeat is not None:
            heartbeat.stop()
        if args.events_out:
            obs_spans.close()


if __name__ == "__main__":
    sys.exit(main())
