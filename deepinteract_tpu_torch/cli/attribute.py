"""Attribute CLI: per-kernel device-time accounting over a profiler trace.

Port of ``deepinteract_tpu/cli/attribute.py``. A ``torch.profiler``
trace (``cli.train --profile_dir``, :func:`deepinteract_tpu_torch.obs.
device.capture`, or any exported Chrome trace) goes in; the
``op_attribution/v1`` report comes out: the top-N kernels by device time,
per-family shares with classes and roofline bound guesses, per-phase
device time (each kernel goes to the span that launched it) with
analytic-FLOP MFU, and the kernel-census x time reconciliation::

    # capture during training...
    python -m deepinteract_tpu_torch.cli.train ... --profile_dir runs/prof
    # ...then attribute it
    python -m deepinteract_tpu_torch.cli.attribute --profile_dir runs/prof \\
        --events runs/ckpt/obs/events.jsonl --census decoder

``--events`` cross-checks the trace's phase windows against the span log
(the same phases, timed by the host). ``--census decoder`` runs the
interaction decoder once under the profiler on ``--device`` (default
``cuda``) and reconciles its kernel census against the measured
per-family time (``--census_json`` feeds a precomputed census instead).

The FINAL stdout line is a machine-readable JSON contract
(tools/check_cli_contract.py, kind ``attribution``): total device ms,
the top-3 kernels with shares, and per-phase device ms.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--profile_dir", required=True,
                   help="torch.profiler trace directory (or a single "
                        "trace.json[.gz] file) to attribute")
    p.add_argument("--events", default=None,
                   help="span event log (events.jsonl) to reconcile "
                        "phase wall times against")
    p.add_argument("--out", default=None,
                   help="report path (default: "
                        "<profile_dir>/op_attribution.json)")
    p.add_argument("--top_n", type=int, default=20,
                   help="kernels kept in the top-ops table")
    p.add_argument("--phases", default=None,
                   help="comma-separated span names to use as phase "
                        "windows (default: auto-detect the annotations)")
    p.add_argument("--analytic_flops", action="append", default=[],
                   metavar="PHASE=FLOPS",
                   help="analytic FLOPs per instance of a phase (repeat "
                        "per phase); enables per-phase MFU with "
                        "--peak_flops")
    p.add_argument("--peak_flops", type=float, default=0.0,
                   help="device peak FLOP/s for MFU (0 disables)")
    p.add_argument("--census", choices=("none", "decoder"), default="none",
                   help="'decoder' runs the interaction decoder once on "
                        "--device and reconciles its kernel census "
                        "against measured time")
    p.add_argument("--census_pad", type=int, default=128,
                   help="pad length for --census decoder")
    p.add_argument("--census_json", default=None,
                   help="precomputed census JSON ({family: count} or "
                        "{'census': {...}, 'meta': {...}}) to reconcile "
                        "without running the decoder")
    p.add_argument("--census_instances", type=int, default=1,
                   help="how many executions of the censused computation "
                        "the trace covers")
    p.add_argument("--device", default="cuda",
                   help="device of --census decoder (cuda unless 'cpu')")
    return p


def _parse_flops(specs) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for spec in specs:
        name, _, val = spec.partition("=")
        if not val:
            raise SystemExit(
                f"--analytic_flops wants PHASE=FLOPS, got {spec!r}")
        out[name] = float(val)
    return out


def _load_census(args) -> tuple:
    """(census dict, meta dict) from --census_json / --census decoder."""
    if args.census_json:
        with open(args.census_json) as fh:
            blob = json.load(fh)
        if "census" in blob:
            return dict(blob["census"]), dict(blob.get("meta", {}))
        return dict(blob), {"source": args.census_json}
    if args.census == "decoder":
        from deepinteract_tpu_torch.obs.kernelquery import decoder_census

        census, meta = decoder_census(pad=args.census_pad, device=args.device)
        return dict(census), meta
    return None, None


def _span_phase_durs(events_path: str) -> Dict[str, list]:
    """name -> [dur_s, ...] in file (completion) order, for the
    events.jsonl cross-check."""
    from deepinteract_tpu_torch.obs.spans import read_events

    durs: Dict[str, list] = {}
    for event in read_events(events_path):
        durs.setdefault(event["name"], []).append(float(event["dur_s"]))
    return durs


def _best_consecutive_match(span_ms: list, trace_ms: list) -> list:
    """The consecutive run of span durations best matching the trace's
    windows (min total abs diff). The span log covers the WHOLE run; the
    capture covers a few consecutive dispatches of it. The two clocks
    share no epoch, so alignment is by duration shape, not timestamps."""
    k = len(trace_ms)
    if len(span_ms) <= k:
        return span_ms
    best, best_cost = span_ms[:k], float("inf")
    for lo in range(len(span_ms) - k + 1):
        window = span_ms[lo:lo + k]
        cost = sum(abs(a - b) for a, b in zip(window, trace_ms))
        if cost < best_cost:
            best, best_cost = window, cost
    return best


def attach_span_crosscheck(report: Dict, events_path: str,
                           trace=None) -> None:
    """Side-by-side phase wall times: trace annotation windows vs the
    span JSONL, the two clocks measuring the same phases. The ratio is
    the report's sanity check (the bound: within 10%). ``trace`` (a
    DeviceTrace) supplies per-window durations so a capture of N
    dispatches is compared against the N matching span instances, not
    the whole run."""
    durs = _span_phase_durs(events_path)
    window_ms: Dict[str, list] = {}
    if trace is not None:
        for w in trace.phases:
            window_ms.setdefault(w.name, []).append(w.dur_us / 1e3)
    for phase in report["phases"]:
        span_ms = [d * 1e3 for d in durs.get(phase["name"], [])]
        if not span_ms:
            continue
        matched = _best_consecutive_match(
            span_ms, window_ms.get(phase["name"], span_ms))
        phase["span_wall_ms"] = round(sum(matched), 4)
        phase["span_instances"] = len(matched)
        phase["span_instances_total"] = len(span_ms)
        if phase["span_wall_ms"] > 0:
            phase["trace_vs_span_wall_ratio"] = round(
                phase["wall_ms"] / phase["span_wall_ms"], 4)
    report["span_events"] = events_path


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    from deepinteract_tpu_torch.obs import attribution as obs_attr
    from deepinteract_tpu_torch.obs import device as obs_device
    from deepinteract_tpu_torch.robustness import artifacts

    phase_names = ([s for s in args.phases.split(",") if s]
                   if args.phases else None)
    trace = obs_device.load_profile(args.profile_dir,
                                    phase_names=phase_names)
    print(f"attribute: {len(trace.ops)} op events, "
          f"{len(trace.phases)} phase windows "
          f"({', '.join(trace.phase_names()) or 'none'}) from "
          f"{len(trace.files)} trace file(s)", flush=True)

    census, census_meta = _load_census(args)
    report = obs_attr.build_report(
        trace,
        top_n=args.top_n,
        analytic_flops=_parse_flops(args.analytic_flops),
        peak_flops=args.peak_flops,
        census=census,
        census_instances=args.census_instances,
        census_meta=census_meta,
    )
    if args.events:
        attach_span_crosscheck(report, args.events, trace=trace)

    out_path = args.out or (
        args.profile_dir if os.path.isdir(args.profile_dir)
        else os.path.dirname(args.profile_dir) or ".")
    if os.path.isdir(out_path) or not out_path.endswith(".json"):
        out_path = os.path.join(out_path, "op_attribution.json")
    artifacts.atomic_write(out_path, json.dumps(report, indent=2))

    for op in report["top_ops"][:5]:
        print(f"  {op['opcode'][:40]:40s} {op['total_ms']:10.3f} ms "
              f"{op['share']:7.2%}  [{op['op_class']}/{op['bound_guess']}]",
              flush=True)
    for phase in report["phases"]:
        line = (f"  phase {phase['name'][:28]:28s} "
                f"device {phase['device_ms']:10.3f} ms / "
                f"wall {phase['wall_ms']:10.3f} ms")
        if "mfu" in phase:
            line += f"  mfu={phase['mfu']}"
        print(line, flush=True)

    contract = {
        "metric": "attribution_total_device_ms",
        "value": report["total_device_ms"],
        "unit": "ms",
        "profile_dir": args.profile_dir,
        "report_out": out_path,
        "op_launches": report["op_launches"],
        "top_ops": [
            {"name": o["name"], "total_ms": o["total_ms"],
             "share": o["share"]}
            for o in report["top_ops"][:3]],
        "phases": {p["name"]: p["device_ms"] for p in report["phases"]},
        "census_reconciled": "census_reconciliation" in report,
    }
    if "remask" in report:
        contract["remask_ms"] = report["remask"]["total_ms"]
        contract["remask_share"] = report["remask"]["share"]
    # FINAL stdout line = the machine-readable contract.
    print(json.dumps(contract), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
