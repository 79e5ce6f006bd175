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

**Mesh worker** (``--mesh_shape DxP``, D*P > 1). The worker is a group of
D*P processes, one per device (``serving/group.py``): this process is
rank 0 (HTTP, scheduler, engine) and starts ranks 1..D*P-1 as copies of
its command line, meeting at a FileStore in ``--rendezvous_dir`` (NCCL
on the GPU, gloo with ``--device cpu``). Batch slots split over the data
axis; buckets at or above ``--pair_shard_threshold`` decode one complex
row-sharded over the pair axis. ``--shard_pair_map`` with no mesh is a
group of one whose over-threshold buckets take that pair placement. A
shape the host cannot provide, a DeepLab model on a pair axis, and a
warm-up key whose rows the pair axis cannot split exit 2 before serving.
A rank that dies ends the worker with a non-zero exit (a fleet restarts
the whole group); a drain stops every rank, and each exits 0::

    python -m deepinteract_tpu_torch.cli.serve --mesh_shape 2x2 --port 8008 \\
        --warmup_buckets 128x128x2,512x512x1

**Fleet** (``--workers N``). A supervisor/router pair
(``serving/fleet.py`` + ``serving/router.py``) in front of N
engine worker processes, each this CLI again with ``--workers 0``
on a free port and the same base flags (so ``--device``,
``--weights``/``--ckpt_name``, ``--mesh_shape`` and ``--index_path`` reach
every worker; each worker captures its own graphs, and a mesh worker's
group meets under the fleet's state directory). Crashed workers restart with
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
                                             add_coordinator_args, add_pair_flags,
                                             add_restore_args, add_serving_args, build_parser,
                                             model_config_from_args)

MODULE = "deepinteract_tpu_torch.cli.serve"


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
                         pair_shard_threshold: int = 512,
                         shard_pair_map: bool = False) -> Tuple[str, ...]:
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
    prefixes every label with ``mesh{D}x{P}/`` as the JAX engine does;
    ``shard_pair_map`` gives a pair axis of one the pair placement."""
    from deepinteract_tpu_torch.data.loader import make_bucket_fn
    from deepinteract_tpu_torch.serving.fleet import (batch_slots, mesh_label_prefix,
                                                      mesh_placement, parse_mesh_shape)

    shape = parse_mesh_shape(mesh_shape)
    prefix = mesh_label_prefix(shape)
    bucket_fn = make_bucket_fn(pad_to_max_bucket, diagonal_buckets)
    out = []
    for b1, b2, bs in parse_warmup_spec(spec):
        nb1, nb2 = bucket_fn(b1, b2)
        placement = mesh_placement(shape, nb1, nb2, pair_shard_threshold, shard_pair_map)
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


def engine_worker_cmd_fn(argv: List[str], state_dir: Optional[str] = None):
    """Worker command factory for REAL engine workers: this CLI again with
    the base argv, the fleet flags neutralized by single-engine overrides
    appended after it (argparse's last occurrence wins), the worker's port,
    heartbeat file and the supervisor's pid, and with ``state_dir`` its
    own ``--rendezvous_dir`` under it (a mesh worker's group). Rollover
    ``overrides`` come last of all: ``{"ckpt_name": D}`` or ``{"weights":
    W}`` repoints the replacement's weights (the other source is dropped
    from the base, as the two are exclusive)."""
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
        if state_dir:
            cmd += ["--rendezvous_dir", os.path.join(state_dir, "groups", worker_id)]
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
        refusal = _mesh_refusal(args, mesh_shape)
        if refusal:
            print(f"serve: {refusal}", file=sys.stderr)
            return 2
        try:
            _build_kernels(args.device)
        except RuntimeError as err:
            print(f"serve: {err}", file=sys.stderr)
            return 2
    state_dir = args.fleet_dir or tempfile.mkdtemp(prefix="di_fleet_")
    cmd_fn = (stub_worker_cmd if args.fleet_stub_workers
              else engine_worker_cmd_fn(argv, state_dir=state_dir))
    required_warm = warm_bucket_prefixes(
        args.warmup_buckets, max_batch=args.max_batch,
        pad_to_max_bucket=args.pad_to_max_bucket,
        diagonal_buckets=args.diagonal_buckets, mesh_shape=mesh_shape,
        pair_shard_threshold=args.pair_shard_threshold, shard_pair_map=args.shard_pair_map)
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


def _model_config(args):
    """The served model's config: the engine makes its own pair-placement
    twin, so the flags' ``shard_pair_map`` stays out of it."""
    import argparse

    return model_config_from_args(argparse.Namespace(
        **{**vars(args), "shard_pair_map": False, "num_pair_shards": 1}))


def _engine_config(args, warmup=()):
    from deepinteract_tpu_torch.serving import EngineConfig
    from deepinteract_tpu_torch.serving.fleet import parse_mesh_shape

    return EngineConfig(
        max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms,
        warmup_buckets=warmup,
        result_cache_size=args.result_cache_size,
        diagonal_buckets=args.diagonal_buckets,
        pad_to_max_bucket=args.pad_to_max_bucket,
        input_indep=args.input_indep,
        max_queue_depth=args.max_queue_depth,
        max_inflight=args.max_inflight,
        mesh_shape=parse_mesh_shape(args.mesh_shape),
        pair_shard_threshold=args.pair_shard_threshold,
        shard_pair_map=args.shard_pair_map,
    )


def _mesh_refusal(args, shape: Tuple[int, int]) -> Optional[str]:
    """Why this command line's worker cannot be served (None: it can),
    decided before any process, group or engine starts: ``--num_pair_shards``
    (a served pair axis is ``--mesh_shape``), a device the host lacks, a
    shape the host's devices cannot provide, a DeepLab model on a pair
    axis, a warm-up key whose rows the pair axis cannot split."""
    from deepinteract_tpu_torch.device import resolve_device
    from deepinteract_tpu_torch.parallel.launch import check_devices
    from deepinteract_tpu_torch.serving.engine import check_mesh
    from deepinteract_tpu_torch.serving.fleet import mesh_label

    if args.num_pair_shards != 1:
        return (f"--num_pair_shards {args.num_pair_shards}: a served pair axis is --mesh_shape "
                f"Dx{args.num_pair_shards} (one process per device)")
    try:
        device = resolve_device(args.device)
        check_mesh(_model_config(args), _engine_config(args, parse_warmup_spec(
            args.warmup_buckets)))
        if args.coordinator_address is None:
            check_devices(shape[0] * shape[1], device, f"--mesh_shape {mesh_label(shape)}")
    except (ValueError, RuntimeError) as err:
        return str(err)
    return None


def _serve(args, warmup, device, group, guard) -> int:
    """Rank 0 (or the only process): the engine, the HTTP server, the
    heartbeat; drained by ``guard``."""
    from deepinteract_tpu_torch.serving import InferenceEngine, ServingServer, ShedderConfig

    heartbeat: Optional[object] = None
    if args.heartbeat_file:
        # Started BEFORE engine construction: loading the weights and
        # capturing the warm-up graphs is the most hang-prone window, and
        # the beat thread is independent of the busy main thread.
        from deepinteract_tpu_torch.obs.heartbeat import Heartbeat

        heartbeat = Heartbeat(args.heartbeat_file, interval_s=args.heartbeat_interval_s)
        heartbeat.progress(role="engine-worker-starting")
        heartbeat.start()
    engine = None
    try:
        engine = InferenceEngine(
            _model_config(args),
            ckpt_dir=args.ckpt_name,
            cfg=_engine_config(args, warmup),
            seed=args.seed,
            metric_to_track=args.metric_to_track,
            device=device,
            weights=args.weights,
            group=group,
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
        mesh = ("" if group is None else
                f"mesh {engine.mesh_shape_label()} over {group.world} rank(s), ")
        print(f"serving on http://{host}:{port} "
              f"({mesh}buckets warm: {engine.stats()['num_compiled_executables']})", flush=True)
        if heartbeat is not None:
            # The beat carries the served weights' identity, so a
            # stale-vs-wrong-weights worker is diagnosable from the file.
            heartbeat.progress(role="engine-worker", port=port,
                               weights_signature=engine.weights_signature())
        return server.run(guard=guard)
    finally:
        if group is not None:
            if engine is not None:
                engine.stop_group()
                engine.release_graphs()
            else:
                group.stop()
            print("serve: the group is stopped; leaving it", file=sys.stderr, flush=True)
        if heartbeat is not None:
            heartbeat.stop()


def _follow(args, group) -> int:
    """Ranks 1..: the same engine as rank 0's, no HTTP; run what rank 0
    announces until it stops the group. Signals are rank 0's to handle."""
    from deepinteract_tpu_torch.serving import InferenceEngine
    from deepinteract_tpu_torch.serving.group import follow

    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    engine = InferenceEngine(_model_config(args), ckpt_dir=args.ckpt_name,
                             cfg=_engine_config(args), seed=args.seed,
                             metric_to_track=args.metric_to_track, weights=args.weights,
                             group=group)
    try:
        runs = follow(engine)
    finally:
        engine.close()
        engine.release_graphs()
    print(f"serve: rank {group.rank} stopped after {runs} dispatch(es); leaving the group",
          file=sys.stderr, flush=True)
    return 0


def _bound_to_rank0(rank0_pid: int) -> bool:
    """A started rank: have the OS SIGKILL it when rank 0, which started
    it, dies (Linux ``PR_SET_PDEATHSIG``), so a lost rank 0 never leaves
    its ranks behind. False if rank 0 was gone before that took hold."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    return os.getppid() == rank0_pid


def _worker_main(args, argv: List[str], warmup, guard) -> int:
    """One engine worker: a single process, or (``--mesh_shape DxP``,
    ``--shard_pair_map``) rank 0 of its group, which starts the others, or
    one of those others (the coordinator flags)."""
    from deepinteract_tpu_torch.device import resolve_device
    from deepinteract_tpu_torch.obs import spans as obs_spans
    from deepinteract_tpu_torch.parallel.launch import rank_group
    from deepinteract_tpu_torch.parallel.mesh import serving_mesh
    from deepinteract_tpu_torch.robustness.preemption import PreemptionGuard
    from deepinteract_tpu_torch.serving.fleet import mesh_label, parse_mesh_shape, watch_parent
    from deepinteract_tpu_torch.serving.group import LOST_RANK_EXIT, ServingGroup

    try:
        shape = parse_mesh_shape(args.mesh_shape)
    except ValueError as err:
        print(f"serve: --mesh_shape {args.mesh_shape}: {err}", file=sys.stderr)
        return 2
    refusal = _mesh_refusal(args, shape)
    if refusal:
        print(f"serve: {refusal}", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    grouped = shape != (1, 1) or args.shard_pair_map
    coordinated = args.coordinator_address is not None
    if coordinated and not grouped:
        print("serve: the coordinator flags join a mesh worker's group: give its "
              "--mesh_shape (or --shard_pair_map)", file=sys.stderr)
        return 2
    coordinator = ((args.coordinator_address, args.num_processes, args.process_id)
                   if coordinated else None)

    def ranks():
        # The started ranks' --parent_pid is rank 0's (_bound_to_rank0).
        started = [*argv, "--parent_pid", str(os.getpid())]
        return rank_group(started, MODULE, shape[0] * shape[1],
                          lambda: serving_mesh(shape, args.shard_pair_map), device,
                          run_dir=args.rendezvous_dir, coordinator=coordinator,
                          label=f"--mesh_shape {mesh_label(shape)}", exit_tag="serve-exit")

    if coordinated and args.process_id:
        if not _bound_to_rank0(args.parent_pid):
            print(f"serve: rank {args.process_id}: rank 0 (pid {args.parent_pid}) is gone",
                  file=sys.stderr)
            return LOST_RANK_EXIT
        with ranks() as group:
            return _follow(args, ServingGroup(group.mesh))

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
    try:
        if not grouped:
            return _serve(args, warmup, device, None, guard)
        if not coordinated:
            _build_kernels(args.device)  # once, before the ranks load them
        with ranks() as group:
            rc = _serve(args, warmup, device,
                        ServingGroup(group.mesh, group.children, group.store_path), guard)
        print("serve: every rank left the group", file=sys.stderr, flush=True)
        return rc
    finally:
        if own_guard:
            guard.__exit__(None, None, None)
        if args.events_out:
            obs_spans.close()


def main(argv=None, guard=None) -> int:
    parser = build_parser(__doc__)
    add_serving_args(parser)
    add_bucket_args(parser)
    add_restore_args(parser)
    add_calibration_args(parser)
    parser.add_argument("--weights", type=str, default=None,
                        help="flat-path .npz of JAX variables (weights.save_npz)")
    group = parser.add_argument_group("mesh worker")
    add_pair_flags(group)
    group.add_argument("--rendezvous_dir", type=str, default=".",
                       help="where a mesh worker's ranks meet (a FileStore, removed at exit; "
                            "a fleet gives each worker its own under its state directory)")
    add_coordinator_args(group)
    args = parser.parse_args(argv)
    if args.weights and args.ckpt_name:
        parser.error("give --weights or --ckpt_name, not both")
    try:
        warmup = parse_warmup_spec(args.warmup_buckets)
    except ValueError as err:
        parser.error(str(err))
    argv = list(sys.argv[1:] if argv is None else argv)

    if args.rollover:
        return _rollover_main(args)
    if args.versions:
        return _versions_main(args)
    if args.workers > 0:
        return _fleet_main(args, argv, guard=guard)
    return _worker_main(args, argv, warmup, guard)


if __name__ == "__main__":
    sys.exit(main())
