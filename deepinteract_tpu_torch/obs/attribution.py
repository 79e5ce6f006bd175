"""Device-time attribution: who gets every millisecond (and FLOP).

Port of ``deepinteract_tpu/obs/attribution.py``. Consumes a parsed
:class:`~deepinteract_tpu_torch.obs.device.DeviceTrace` and produces the
``op_attribution/v1`` report, the JAX package's schema:

* **per-kernel / per-family time**: total device microseconds, launch
  counts and time share for every kernel name and every kernel family
  (:func:`~deepinteract_tpu_torch.obs.device.opcode_of`), with a class and
  a roofline *bound guess* per family;
* **per-phase decomposition**: each op event goes to the innermost span
  window (``device_step``, ``h2d``, ...) holding its anchor, on the
  anchor's thread: a kernel's launch on the card, a CPU op's midpoint on
  the CPU (:func:`assign_phases`); analytic-FLOP MFU per phase when the
  caller supplies FLOP counts and a peak;
* **census reconciliation**: a kernel census
  (:func:`deepinteract_tpu_torch.obs.kernelquery.decoder_census`) joined
  against the measured per-family time.

Report schema (``schema`` key = ``op_attribution/v1``)::

    {"schema": "op_attribution/v1", "device": ..., "total_device_ms": ...,
     "top_ops": [{"name", "opcode", "op_class", "bound_guess", "count",
                  "total_ms", "share"}],
     "by_opcode": [...same minus name...],
     "phases": [{"name", "instances", "wall_ms", "device_ms",
                 "device_share_of_wall", "analytic_flops", "mfu"}],
     "census_reconciliation": [{"opcode", "census_count",
                                "measured_count", "total_ms", "share",
                                "ms_per_launch"}],
     "unattributed_ms": ..., "notes": [...]}

Pure stdlib + arithmetic; nothing here touches torch or the device.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from deepinteract_tpu_torch.obs.device import DeviceTrace, opcode_of

SCHEMA = "op_attribution/v1"

# Kernel family -> (op_class, roofline bound guess), by regex search on
# the lower-cased family in priority order: the first hit wins.
# "compute" = FLOP-limited at realistic shapes (tensor cores / FMA);
# "memory" = HBM-bandwidth-limited (elementwise, data movement, masking);
# "host" = PCIe; "communication" = NVLink / the network.
_CLASS_RULES: Sequence = tuple((re.compile(rx), op_class, bound) for rx, op_class, bound in (
    (r"nccl", "communication", "communication"),
    # The port's hand-written kernels: K1 and K2 stand apart.
    (r"edge_attention_fwd", "edge-attention-fwd", "memory"),
    (r"edge_attention_bwd", "edge-attention-bwd", "memory"),
    (r"^memcpy (htod|dtoh)", "host-transfer", "host"),
    (r"^memcpy|^memset", "data-movement", "memory"),
    # A dtype cast must match before the bare "conv" needle, as in JAX.
    (r"convert|to_copy", "elementwise", "memory"),
    (r"fprop|dgrad|wgrad|implicit_convolve|convolution|conv|cudnn|winograd",
     "matmul", "compute"),
    (r"gemm|gemv|xmma|cutlass|cublas|^mm$|addmm|bmm|matmul", "matmul", "compute"),
    (r"reduce|norm|softmax|welford|^bn_|^(sum|mean|var|std|amax|amin|max|min)$",
     "reduction", "memory"),
    (r"index|scatter|gather|sort|radix|searchsorted|cat|copy|transpose|permute|pad|"
     r"nchwtonhwc|nhwctonchw|im2col|col2im", "data-movement", "memory"),
    (r"elementwise|where|mask|fill|mul|add|div|sub|elu|relu|sigmoid|exp|tanh|clamp",
     "elementwise", "memory"),
))
_DEFAULT_CLASS = ("elementwise", "memory")

# The masking families of the port's decoder (``x * mask``, ``where``,
# ``masked_fill``), in place of the JAX package's HLO select / broadcast /
# and / multiply. Matched on a family's functor (``..._kernel<mul>`` ->
# ``mul``); surfaced as a dedicated note when they carry measured time.
REMASK_OPCODES = ("where", "masked_fill", "mul")


def classify_opcode(opcode: str):
    """(op_class, bound_guess) for one kernel family."""
    low = opcode.lower()
    for rx, op_class, bound in _CLASS_RULES:
        if rx.search(low):
            return op_class, bound
    return _DEFAULT_CLASS


def _functor(opcode: str) -> str:
    """``vectorized_elementwise_kernel<mul>`` -> ``mul``; a family
    without a functor is its own."""
    if opcode.endswith(">") and "<" in opcode:
        return opcode[opcode.index("<") + 1:-1]
    return opcode


def is_remask(opcode: str) -> bool:
    return _functor(opcode) in REMASK_OPCODES


@dataclasses.dataclass
class _Agg:
    count: int = 0
    total_us: float = 0.0


def _rounded_ms(us: float) -> float:
    return round(us / 1e3, 4)


def _share(us: float, total_us: float) -> float:
    return round(us / total_us, 4) if total_us > 0 else 0.0


def aggregate_ops(trace: DeviceTrace, top_n: int = 20) -> Dict:
    """Per-kernel and per-family rollups over every op event in the trace."""
    by_name: Dict[str, _Agg] = defaultdict(_Agg)
    by_opcode: Dict[str, _Agg] = defaultdict(_Agg)
    for op in trace.ops:
        code = opcode_of(op.name)
        a = by_name[op.name]
        a.count += 1
        a.total_us += op.dur_us
        b = by_opcode[code]
        b.count += 1
        b.total_us += op.dur_us
    total_us = trace.total_device_us

    def row(name: str, agg: _Agg, with_name: bool) -> Dict:
        code = opcode_of(name) if with_name else name
        op_class, bound = classify_opcode(code)
        out = {
            "opcode": code,
            "op_class": op_class,
            "bound_guess": bound,
            "count": agg.count,
            "total_ms": _rounded_ms(agg.total_us),
            "share": _share(agg.total_us, total_us),
        }
        if with_name:
            out = {"name": name, **out}
        return out

    top_ops = [row(n, a, True) for n, a in sorted(
        by_name.items(), key=lambda kv: -kv[1].total_us)[:top_n]]
    opcode_rows = [row(c, a, False) for c, a in sorted(
        by_opcode.items(), key=lambda kv: -kv[1].total_us)]
    return {
        "total_device_ms": _rounded_ms(total_us),
        "op_launches": sum(a.count for a in by_opcode.values()),
        "top_ops": top_ops,
        "by_opcode": opcode_rows,
    }


def assign_phases(trace: DeviceTrace) -> List[Optional[str]]:
    """The phase of each op event of ``trace.ops`` (None: unattributed):
    the innermost (shortest) window that holds the op's anchor time and
    lives on its anchor thread. An op without an anchor time is placed
    by its midpoint, and a window or op without a thread matches any
    thread (the JAX package's overlap rule)."""
    windows = sorted(trace.phases, key=lambda w: w.start_us)
    starts = [w.start_us for w in windows]
    max_dur = max((w.dur_us for w in windows), default=0.0)
    out: List[Optional[str]] = []
    for op in trace.ops:
        # Only windows starting at or before the anchor can contain it,
        # and none starting more than max_dur earlier: a bounded backward
        # scan from the bisect point.
        t = op.anchor_us if op.anchor_us is not None else op.mid_us
        tid = op.anchor_tid
        best = None
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and t - starts[i] <= max_dur:
            w = windows[i]
            if (w.contains(t) and (w.tid is None or tid is None or w.tid == tid)
                    and (best is None or w.dur_us < best.dur_us)):
                best = w
            i -= 1
        out.append(best.name if best is not None else None)
    return out


@dataclasses.dataclass
class PhaseTotals:
    """Unrounded sums of one phase: its windows, their wall, the device
    time attributed to it."""

    instances: int = 0
    wall_us: float = 0.0
    device_us: float = 0.0


def phase_totals(trace: DeviceTrace) -> Tuple[Dict[str, PhaseTotals], float]:
    """(phase name -> :class:`PhaseTotals` in window order, the device
    time of the unattributed ops): the unrounded numbers
    :func:`attribute_phases` reports."""
    totals: Dict[str, PhaseTotals] = {}
    for w in sorted(trace.phases, key=lambda w: w.start_us):
        t = totals.setdefault(w.name, PhaseTotals())
        t.instances += 1
        t.wall_us += w.dur_us
    unattributed_us = 0.0
    for op, name in zip(trace.ops, assign_phases(trace)):
        if name is None:
            unattributed_us += op.dur_us
        else:
            totals[name].device_us += op.dur_us
    return totals, unattributed_us


def attribute_phases(
    trace: DeviceTrace,
    analytic_flops: Optional[Mapping[str, float]] = None,
    peak_flops: float = 0.0,
) -> Dict:
    """Per-phase device time (:func:`assign_phases`).

    ``analytic_flops`` maps phase name -> FLOPs per phase INSTANCE; with
    ``peak_flops`` it yields a per-phase measured-device-time MFU.
    Returns {"phases": [...], "unattributed_ms": ...}. Windows of the same
    name aggregate."""
    analytic_flops = dict(analytic_flops or {})
    totals, unattributed_us = phase_totals(trace)
    phases = []
    for name, t in totals.items():
        entry = {
            "name": name,
            "instances": t.instances,
            "wall_ms": _rounded_ms(t.wall_us),
            "device_ms": _rounded_ms(t.device_us),
            "device_share_of_wall": _share(t.device_us, t.wall_us),
        }
        if name in analytic_flops:
            flops_total = float(analytic_flops[name]) * t.instances
            entry["analytic_flops"] = flops_total
            if peak_flops > 0 and t.device_us > 0:
                entry["mfu"] = round(
                    flops_total / (t.device_us / 1e6) / peak_flops, 5)
        phases.append(entry)
    phases.sort(key=lambda p: -p["device_ms"])
    return {"phases": phases, "unattributed_ms": _rounded_ms(unattributed_us)}


def reconcile_census(census: Mapping[str, int], opcode_rows: Sequence[Dict],
                     instances: int = 1) -> List[Dict]:
    """Join a kernel census against measured per-family time.

    ``census`` maps family -> launches of one censused computation;
    ``instances`` is how many executions of it the trace covers, so
    ``measured_count`` can be read against ``census_count * instances``.
    Census families with no measured time still appear, and measured
    families the census lacks appear with a zero count."""
    measured = {r["opcode"]: r for r in opcode_rows}
    rows = []
    for opcode in sorted(set(census) | set(measured)):
        m = measured.get(opcode)
        total_ms = m["total_ms"] if m else 0.0
        count = m["count"] if m else 0
        rows.append({
            "opcode": opcode,
            "census_count": int(census.get(opcode, 0)),
            "census_instances": int(instances),
            "measured_count": count,
            "total_ms": total_ms,
            "share": m["share"] if m else 0.0,
            "ms_per_launch": round(total_ms / count, 5) if count else 0.0,
        })
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def build_report(
    trace: DeviceTrace,
    top_n: int = 20,
    analytic_flops: Optional[Mapping[str, float]] = None,
    peak_flops: float = 0.0,
    census: Optional[Mapping[str, int]] = None,
    census_instances: int = 1,
    census_meta: Optional[Dict] = None,
    device: str = "",
) -> Dict:
    """The full ``op_attribution/v1`` report (see module docstring)."""
    agg = aggregate_ops(trace, top_n=top_n)
    phase_part = attribute_phases(trace, analytic_flops, peak_flops)
    notes: List[str] = []
    report = {
        "schema": SCHEMA,
        "device": device or trace.device or next(iter(trace.processes.values()), ""),
        "trace_files": list(trace.files),
        **agg,
        **phase_part,
        "peak_flops": peak_flops or None,
    }
    if census is not None:
        rows = reconcile_census(census, agg["by_opcode"],
                                instances=census_instances)
        report["census_reconciliation"] = rows
        if census_meta:
            report["census_meta"] = dict(census_meta)
        remask_ms = sum(r["total_ms"] for r in rows if is_remask(r["opcode"]))
        remask_launches = sum(r["census_count"] for r in rows if is_remask(r["opcode"]))
        # Families whose functor only carries a masking name (a fused
        # masked op) are an upper bound on the re-mask cost beyond the
        # bare families.
        fused_ms = sum(r["total_ms"] for r in rows
                       if not is_remask(r["opcode"])
                       and any(n in _functor(r["opcode"]) for n in REMASK_OPCODES))
        total_ms = report["total_device_ms"]
        notes.append(
            f"re-mask families {list(REMASK_OPCODES)}: {remask_launches} "
            f"census launches, {remask_ms:.3f} ms measured bare "
            f"({_share(remask_ms, total_ms)} of device time) + "
            f"{fused_ms:.3f} ms in families that carry a masking name "
            "(upper bound)")
        report["remask"] = {
            "opcodes": list(REMASK_OPCODES),
            "census_launches": remask_launches,
            "total_ms": round(remask_ms, 4),
            "share": _share(remask_ms, total_ms),
            "select_fusion_ms": round(fused_ms, 4),
            "select_fusion_share": _share(fused_ms, total_ms),
        }
    if not trace.phases:
        notes.append("no phase windows found: were the span annotations on "
                     "during the capture?")
    report["notes"] = notes
    return report
