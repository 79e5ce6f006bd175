"""Serve CLI — the resident HTTP inference engine (``deepinteract_tpu_torch.serving``).

Port of the single-engine mode of ``deepinteract_tpu/cli/serve.py``. A
persistent process loads the weights once, captures one CUDA graph per
padded shape bucket (ahead of time with ``--warmup_buckets``),
micro-batches concurrent requests per bucket, and answers a JSON API::

    python -m deepinteract_tpu_torch.cli.serve [--ckpt_name DIR | --weights W.npz] \\
        --port 8008 --warmup_buckets 128x128x1,128x128x8

    curl -X POST --data-binary @complex.npz http://127.0.0.1:8008/predict
    curl http://127.0.0.1:8008/stats
    curl http://127.0.0.1:8008/metrics   # Prometheus text exposition

Runs on the GPU unless ``--device cpu`` is given (then every dispatch runs
eagerly on the CPU). SIGTERM drains in-flight requests and exits 0.
"""

from __future__ import annotations

import sys
from typing import Optional, Tuple

from deepinteract_tpu_torch.cli.args import (add_bucket_args, add_restore_args,
                                             add_serving_args, build_parser,
                                             model_config_from_args)


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


def main(argv=None, guard=None) -> int:
    parser = build_parser(__doc__)
    add_serving_args(parser)
    add_bucket_args(parser)
    add_restore_args(parser)
    parser.add_argument("--weights", type=str, default=None,
                        help="flat-path .npz of JAX variables (weights.save_npz)")
    args = parser.parse_args(argv)
    if args.weights and args.ckpt_name:
        parser.error("give --weights or --ckpt_name, not both")
    try:
        warmup = parse_warmup_spec(args.warmup_buckets)
    except ValueError as err:
        parser.error(str(err))

    from deepinteract_tpu_torch.device import resolve_device
    from deepinteract_tpu_torch.obs import spans as obs_spans
    from deepinteract_tpu_torch.serving import (EngineConfig, InferenceEngine,
                                                ServingServer, ShedderConfig)

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
            default_deadline_ms=args.default_deadline_ms,
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
        if heartbeat is not None:
            heartbeat.stop()
        if args.events_out:
            obs_spans.close()


if __name__ == "__main__":
    sys.exit(main())
