"""Device-trace parsing: per-kernel time out of a ``torch.profiler`` trace.

Port of ``deepinteract_tpu/obs/device.py`` over the Chrome trace that
``torch.profiler`` exports (``cli.train --profile_dir`` writes
``<dir>/trace.json``; ``torch.profiler.tensorboard_trace_handler`` writes
``*.pt.trace.json[.gz]``; :func:`capture` here writes ``trace.json``).
The event soup is reduced to what attribution needs:

* **op events.** On the card: every event whose ``cat`` is ``kernel``,
  ``gpu_memcpy`` or ``gpu_memset`` (the kernels of a CUDA graph replay are
  listed one by one). Each is anchored at the host call that launched it:
  the ``cuda_runtime`` / ``cuda_driver`` event with the same
  ``args.correlation`` (``cudaLaunchKernel``, ``cuLaunchKernel``,
  ``cudaGraphLaunch`` for every kernel of a replay, ``cudaMemcpyAsync``),
  its timestamp and its thread. A kernel runs after its launch returns,
  so a kernel belongs to the phase that launched it, not to whatever host
  range its execution overlaps. A launch from a thread that opens no
  window (the autograd engine's device thread runs the backward) counts
  for the thread whose windows hold most of that thread's launches. A
  device event whose launch is not in the trace has no anchor
  (:data:`NO_LAUNCH_TID`) and counts as unattributed.
  On the CPU (``--device cpu``, the tests): the ``cpu_op`` events, each
  with its self time (its duration less its direct children's on the
  same thread), so every microsecond counts once, for the innermost op
  that holds it (the JAX parser drops its ``call`` / ``while`` wrappers
  for the same reason); an op with no time of its own is dropped. Each
  is anchored at its own midpoint and thread.
* **phase windows.** The ``user_annotation`` ranges that
  :mod:`deepinteract_tpu_torch.obs.spans` opens on host threads
  (``record_function``), filtered by the JAX parser's name rules, each
  with its thread. The ``gpu_user_annotation`` copies of those ranges on
  the device's timeline are not windows: they would count eager time
  twice.

Everything is stdlib JSON processing; torch is imported only inside
:func:`capture`. Timestamps are the trace's microseconds.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import glob
import gzip
import json
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# Host-side names that look like annotations but are runtime internals
# (the JAX parser's list); anything with "::", "(", "#" or a space is
# already rejected by _PHASE_NAME_RE.
_PHASE_EXCLUDE = frozenset({
    "process_name", "thread_name", "checkpoint", "flush",
    "ParseArguments", "ExecuteOnCpu", "RunExecutable",
})
_PHASE_NAME_RE = re.compile(r"^[A-Za-z_][\w.\-/]*$")

DEVICE_CATEGORIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
LAUNCH_CATEGORIES = frozenset({"cuda_runtime", "cuda_driver"})
WINDOW_CATEGORY = "user_annotation"
HOST_OP_CATEGORY = "cpu_op"
# The anchor thread of a device event whose launch is not in the trace:
# no window lives on it, so the event stays unattributed.
NO_LAUNCH_TID = -1

TRACE_PATTERNS = ("trace.json", "trace.json.gz", "*.trace.json", "*.trace.json.gz")


@dataclasses.dataclass(frozen=True)
class OpEvent:
    """One timed execution of one kernel (or, on the CPU, the self time
    of one aten op). ``anchor_us`` / ``anchor_tid`` are the host timestamp
    and thread that phase attribution goes by: a device event's launch, a
    CPU op's own midpoint and thread (None: the event's midpoint, on any
    thread)."""

    name: str
    start_us: float
    dur_us: float
    pid: int
    tid: int
    anchor_us: Optional[float] = None
    anchor_tid: Optional[int] = None
    launch: str = ""  # the launching runtime call (``cudaGraphLaunch``: a replay)

    @property
    def mid_us(self) -> float:
        return self.start_us + self.dur_us / 2.0


@dataclasses.dataclass(frozen=True)
class PhaseWindow:
    """One instance of a named phase (a span annotation) on the trace;
    ``tid`` is its host thread (None: any thread)."""

    name: str
    start_us: float
    dur_us: float
    tid: Optional[int] = None

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us

    def contains(self, t_us: float) -> bool:
        return self.start_us <= t_us < self.end_us


@dataclasses.dataclass
class DeviceTrace:
    """Parsed view of one trace file. ``device`` is the card's name from
    the trace's ``deviceProperties`` ("cpu" without one); ``extent_us``
    the time from the first event's start to the last one's end (the
    profile window's wall)."""

    ops: List[OpEvent]
    phases: List[PhaseWindow]
    processes: Dict[Any, str]
    files: List[str] = dataclasses.field(default_factory=list)
    device: str = ""
    extent_us: float = 0.0

    @property
    def total_device_us(self) -> float:
        return sum(op.dur_us for op in self.ops)

    def phase_names(self) -> List[str]:
        seen: Dict[str, None] = {}
        for w in self.phases:
            seen.setdefault(w.name, None)
        return list(seen)


def find_trace_files(profile_dir: str) -> List[str]:
    """Every trace file under ``profile_dir`` (a file path is taken as
    is): the loop's ``trace.json`` and ``*.pt.trace.json[.gz]``, gzip or
    not, newest first."""
    if os.path.isfile(profile_dir):
        return [profile_dir]
    hits = set()
    for pat in TRACE_PATTERNS:
        hits.update(glob.glob(os.path.join(profile_dir, "**", pat), recursive=True))
    return sorted(hits, key=lambda p: (os.path.getmtime(p), p), reverse=True)


def load_trace_json(path: str) -> Dict[str, Any]:
    """One trace file -> its decoded JSON dict (gzip-transparent)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:  # type: ignore[operator]
        return json.loads(fh.read())


def _as_int(value: Any) -> int:
    """A trace's pid / tid as an int (some exporters write labels such as
    ``"Spans"``; those become -1)."""
    if isinstance(value, (int, float)):
        return int(value)
    try:
        return int(str(value))
    except ValueError:
        return -1


def _self_times(events: List[Dict[str, Any]]) -> List[Tuple[Dict[str, Any], float]]:
    """(event, self time) of each event with time of its own: its
    duration less its direct children's on the same thread."""
    by_tid: Dict[int, List[Dict[str, Any]]] = {}
    for e in events:
        by_tid.setdefault(_as_int(e.get("tid", 0)), []).append(e)
    out: List[Tuple[Dict[str, Any], float]] = []
    for evs in by_tid.values():
        evs.sort(key=lambda e: (float(e.get("ts", 0.0)), -float(e.get("dur", 0.0))))
        self_us = [float(e.get("dur", 0.0)) for e in evs]
        stack: List[Tuple[int, float]] = []  # (index, end_us) of the open events
        for i, e in enumerate(evs):
            start = float(e.get("ts", 0.0))
            while stack and stack[-1][1] <= start:
                stack.pop()
            if stack:
                self_us[stack[-1][0]] -= float(e.get("dur", 0.0))
            stack.append((i, start + float(e.get("dur", 0.0))))
        out.extend((e, t) for e, t in zip(evs, self_us) if t > 0.0)
    return out


def _adopt_helper_threads(ops: List[OpEvent], phases: List[PhaseWindow]) -> List[OpEvent]:
    """Device events launched from a thread that opens no window are
    re-anchored on the thread whose windows hold most of that thread's
    launches. The autograd engine runs a step's backward on a device
    thread of its own, which opens no span: its kernels belong to the step
    that asked for the backward, whatever the other threads (the
    placement thread's ``h2d``) do at the time."""
    spans: Dict[int, List[Tuple[float, float]]] = {}
    for w in phases:
        if w.tid is not None:
            spans.setdefault(w.tid, []).append((w.start_us, w.end_us))
    helpers = {op.anchor_tid for op in ops if op.anchor_tid not in spans
               and op.anchor_tid not in (None, NO_LAUNCH_TID)}
    if not helpers or not spans:
        return ops
    unions: Dict[int, Tuple[List[float], List[float]]] = {}
    for tid, intervals in spans.items():
        starts: List[float] = []
        ends: List[float] = []
        for lo, hi in sorted(intervals):
            if starts and lo <= ends[-1]:
                ends[-1] = max(ends[-1], hi)
            else:
                starts.append(lo)
                ends.append(hi)
        unions[tid] = (starts, ends)
    votes: Dict[int, Dict[int, int]] = {h: {} for h in helpers}
    for op in ops:
        if op.anchor_tid in votes and op.anchor_us is not None:
            for tid, (starts, ends) in unions.items():
                i = bisect.bisect_right(starts, op.anchor_us) - 1
                if i >= 0 and op.anchor_us < ends[i]:
                    votes[op.anchor_tid][tid] = votes[op.anchor_tid].get(tid, 0) + 1
    parent = {h: min(v, key=lambda tid: (-v[tid], tid)) for h, v in votes.items() if v}
    return [dataclasses.replace(op, anchor_tid=parent[op.anchor_tid])
            if op.anchor_tid in parent else op for op in ops]


def _is_window(name: str, dur: float, wanted) -> bool:
    if wanted is not None:
        return name in wanted
    return not (name in _PHASE_EXCLUDE or not _PHASE_NAME_RE.match(name) or dur <= 0.0)


def parse_trace(trace_json: Dict[str, Any],
                phase_names: Optional[Sequence[str]] = None) -> DeviceTrace:
    """Reduce one ``torch.profiler`` trace to op events + phase windows.

    ``phase_names``: restrict phase windows to these annotation names.
    Default (None) auto-detects: every identifier-shaped
    ``user_annotation`` range that is not a known runtime internal. A
    trace with device events (or device properties) is a card trace: its
    ops are the device events; otherwise they are the CPU ops' self
    times."""
    events = trace_json.get("traceEvents", [])
    pname: Dict[Any, str] = {}
    xs: List[Dict[str, Any]] = []
    for e in events:
        ph = e.get("ph")
        if ph == "X":
            xs.append(e)
        elif ph == "M" and e.get("name") == "process_name":
            pname[e.get("pid", 0)] = str((e.get("args") or {}).get("name", ""))
    props = trace_json.get("deviceProperties") or []
    on_device = bool(props) or any(e.get("cat") in DEVICE_CATEGORIES for e in xs)
    launches: Dict[Any, Tuple[float, int, str]] = {}
    if on_device:
        for e in xs:
            if e.get("cat") in LAUNCH_CATEGORIES:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = (float(e.get("ts", 0.0)), _as_int(e.get("tid", 0)),
                                      str(e.get("name", "")))

    wanted = set(phase_names) if phase_names is not None else None
    ops: List[OpEvent] = []
    phases: List[PhaseWindow] = []
    host_ops: List[Dict[str, Any]] = []
    first, last = float("inf"), float("-inf")
    no_launch = (None, NO_LAUNCH_TID, "")
    for e in xs:  # the hot loop of a trace with ~10^5 events: one pass, few lookups
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if ts < first:
            first = ts
        if ts + dur > last:
            last = ts + dur
        cat = e.get("cat")
        if cat == WINDOW_CATEGORY:
            name = str(e.get("name", ""))
            if _is_window(name, dur, wanted):
                phases.append(PhaseWindow(name, ts, dur, _as_int(e.get("tid", 0))))
        elif on_device:
            if cat in DEVICE_CATEGORIES:
                anchor_us, anchor_tid, launch = launches.get(
                    (e.get("args") or {}).get("correlation"), no_launch)
                ops.append(OpEvent(name=str(e.get("name", "")), start_us=ts, dur_us=dur,
                                   pid=_as_int(e.get("pid", 0)), tid=_as_int(e.get("tid", 0)),
                                   anchor_us=anchor_us, anchor_tid=anchor_tid, launch=launch))
        elif cat == HOST_OP_CATEGORY:
            host_ops.append(e)
    for e, self_us in _self_times(host_ops):
        ts, tid = float(e.get("ts", 0.0)), _as_int(e.get("tid", 0))
        ops.append(OpEvent(name=str(e.get("name", "")), start_us=ts, dur_us=self_us,
                           pid=_as_int(e.get("pid", 0)), tid=tid,
                           anchor_us=ts + float(e.get("dur", 0.0)) / 2.0, anchor_tid=tid))
    if on_device:
        ops = _adopt_helper_threads(ops, phases)
    phases.sort(key=lambda w: w.start_us)
    ops.sort(key=lambda o: o.start_us)
    device = str(props[0].get("name", "")) if props and isinstance(props[0], dict) else ""
    return DeviceTrace(ops=ops, phases=phases, processes=pname,
                       device=device or ("cuda" if on_device else "cpu"),
                       extent_us=max(0.0, last - first) if xs else 0.0)


def load_profile(profile_dir: str,
                 phase_names: Optional[Sequence[str]] = None) -> DeviceTrace:
    """Find + load + parse a profile directory (or a single trace file):
    the newest trace file only (one profile window, one clock)."""
    files = find_trace_files(profile_dir)
    if not files:
        raise FileNotFoundError(
            f"no trace.json / *.trace.json(.gz) under {profile_dir!r}: was a "
            "torch.profiler trace exported there?")
    out = parse_trace(load_trace_json(files[0]), phase_names)
    out.files = files[:1]
    return out


_MEMCPY_RE = re.compile(r"^(Memcpy|Memset)\b\s*(HtoD|DtoH|DtoD|HtoH|PtoP|DtoA|AtoD)?")
# PyTorch's templated kernels: their family is the functor they run.
_FUNCTOR_WRAPPERS = frozenset({
    "vectorized_elementwise_kernel", "unrolled_elementwise_kernel", "elementwise_kernel",
    "vectorized_templated_elementwise_kernel", "index_elementwise_kernel",
    "elementwise_kernel_with_index", "reduce_kernel",
})
# CUTLASS's launch wrappers: their family is their first template argument.
_ARG_WRAPPERS_RE = re.compile(r"^(Kernel\d*|device_kernel)$")
_FUNCTOR_RES = (
    re.compile(r"CUDAFunctor(?:OnSelf|OnOther)?_([A-Za-z]\w*)"),
    re.compile(r"\b([A-Za-z]\w*?)_kernel(?:_impl|_cuda|_functor)?\b"),
    re.compile(r"\b([A-Za-z]\w*?)_functor\b"),
    re.compile(r"\b([A-Z][A-Za-z0-9]*?)(?:Functor|Ops)\b"),
)
_GENERIC_FUNCTORS = frozenset({"", "bunary", "aunary", "unary", "binary", "opmath", "cuda",
                               "func_wrapper", "reduce", "elementwise", "vectorized"})


def _snake(name: str) -> str:
    return re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "_", name).lower()


def _split_head(text: str) -> Tuple[str, str]:
    """``text`` -> (the part before its first top-level ``<`` or ``(``,
    the text inside that first ``<...>``, or "")."""
    for i, ch in enumerate(text):
        if ch == "(":
            return text[:i], ""
        if ch == "<":
            depth = 0
            for j in range(i, len(text)):
                if text[j] == "<":
                    depth += 1
                elif text[j] == ">":
                    depth -= 1
                    if depth == 0:
                        return text[:i], text[i + 1:j]
            return text[:i], text[i + 1:]
    return text, ""


def _functor_of(template_args: str) -> str:
    """The first named functor inside a kernel's template arguments."""
    found = []
    for rx in _FUNCTOR_RES:
        for m in rx.finditer(template_args):
            found.append((m.start(), _snake(m.group(1))))
    for _, name in sorted(found):
        if name not in _GENERIC_FUNCTORS:
            return name
    return ""


@functools.lru_cache(maxsize=8192)
def opcode_of(name: str) -> str:
    """A kernel's family, so that template instantiations group into one
    row: ``void`` and namespaces and ``<...>`` / ``(...)`` arguments are
    stripped (``void at::native::im2col_kernel<float>(...)`` ->
    ``im2col_kernel``, ``aten::addmm`` -> ``addmm``); memcpy keeps its
    kind (``Memcpy HtoD (Pageable -> Device)`` -> ``Memcpy HtoD``);
    PyTorch's elementwise and reduce templates keep the functor they run
    (``vectorized_elementwise_kernel<mul>``, ``reduce_kernel<sum>``) and
    CUTLASS's launch wrappers their kernel (``Kernel2<cutlass_80_...>``)."""
    m = _MEMCPY_RE.match(name)
    if m:
        return " ".join(p for p in m.groups() if p)
    base = name.strip().replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[len("void "):]
    head, targs = _split_head(base)
    ident = head.rsplit("::", 1)[-1].strip()
    if ident in _FUNCTOR_WRAPPERS and targs:
        functor = _functor_of(targs)
        return f"{ident}<{functor}>" if functor else ident
    if _ARG_WRAPPERS_RE.match(ident) and targs:
        inner = opcode_of(targs.split(",", 1)[0])
        return f"{ident}<{inner}>"
    return ident or base


@contextlib.contextmanager
def capture(profile_dir: str, device: str = "cuda", annotate_spans: bool = True):
    """``with capture(dir, device): ...``: a ``torch.profiler`` window
    (CPU, plus CUDA when ``device`` is a CUDA device) with the span
    annotations on, so the trace comes out phase-labelled; its Chrome
    trace is exported to ``<dir>/trace.json`` on exit, which waits for the
    card. The previous annotation flag is restored."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepinteract_tpu_torch.device import resolve_device
    from deepinteract_tpu_torch.obs import spans as obs_spans

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prev = obs_spans.annotations_enabled()
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    if annotate_spans:
        obs_spans.set_profiler_annotations(True)
    try:
        yield profile_dir
    finally:
        obs_spans.set_profiler_annotations(prev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def iter_op_events(trace: DeviceTrace) -> Iterable[OpEvent]:
    return iter(trace.ops)
