"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

Port of ``deepinteract_tpu/obs/metrics.py`` (stdlib only, so the port
keeps its own copy); ``obs/expfmt.py`` renders it as Prometheus text. One registry instance
serves the whole process: the training supervisor and the retry helper
record into it. Prometheus conventions apply: counters only go up and end
in ``_total``, histograms carry cumulative fixed buckets, label sets are
low-cardinality and fixed per family.

Everything is host-side Python guarded by a per-family lock: a recording
call is a dict update, never a device op.

Registration is idempotent — ``counter("di_x_total", ...)`` returns the
existing family on repeat calls, so call sites can register at module
import without coordinating. Re-registering with a different type, label
set, or bucket layout raises: silent aliasing of two meanings onto one
name is how dashboards lie.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

# Default histogram buckets for request/phase latencies, in seconds.
# Wide dynamic range on purpose: the same layout serves a 2 ms warm
# serving hit and a 90 s cold compile.
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


class MetricError(ValueError):
    """Invalid metric use: type/label/bucket mismatch or bad arguments."""


class _Family:
    """Base of one named metric family (all label combinations)."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise MetricError(
                f"{self.name}: labels {sorted(labels)} do not match the "
                f"registered label names {sorted(self.labelnames)}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def _labels_dict(self, key: Tuple[str, ...]) -> Dict[str, str]:
        return dict(zip(self.labelnames, key))

    def clear(self) -> None:
        """Drop every series (registry.reset(); family object survives so
        module-level references held by call sites stay valid)."""
        with self._lock:
            self._series.clear()
            self._init_default_series()

    def remove(self, **labels) -> None:
        """Drop ONE labeled series (a label value whose lifetime ended).
        No-op when the series does not exist."""
        key = self._key(labels)
        with self._lock:
            self._series.pop(key, None)

    def _init_default_series(self) -> None:
        """Unlabeled families expose a zero-valued series from creation
        (the prometheus_client convention): a scrape shows the metric
        exists before the first event, instead of the series popping into
        existence later. Labeled families cannot pre-create (the label
        values are unknown). Called under ``_lock`` (or before sharing)."""

    def samples(self) -> List[Tuple[str, Dict[str, str], float]]:
        """(name_suffix, labels, value) triples for exposition."""
        raise NotImplementedError


class Counter(_Family):
    """Monotonically increasing count (events, requests, retries)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._init_default_series()

    def _init_default_series(self) -> None:
        if not self.labelnames:
            self._series[()] = 0.0

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise MetricError(f"{self.name}: counters cannot decrease "
                              f"(inc by {amount})")
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(self._series.get(key, 0.0)) + amount

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._series.get(key, 0.0))

    def samples(self):
        with self._lock:
            return [("", self._labels_dict(k), float(v))
                    for k, v in sorted(self._series.items())]


class Gauge(_Family):
    """Point-in-time value (queue depth, cache size, last metric)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._init_default_series()

    def _init_default_series(self) -> None:
        if not self.labelnames:
            self._series[()] = 0.0

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(self._series.get(key, 0.0)) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._series.get(key, 0.0))

    def samples(self):
        with self._lock:
            return [("", self._labels_dict(k), float(v))
                    for k, v in sorted(self._series.items())]


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative) counts
        self.sum = 0.0
        self.count = 0
        self.max = -math.inf


class Histogram(_Family):
    """Fixed-bucket distribution (latencies, batch sizes).

    Buckets are upper bounds in ascending order; a final +Inf bucket is
    implicit. The observed max is tracked exactly (percentile estimates
    in the overflow bucket interpolate toward it instead of infinity).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        super().__init__(name, help, labelnames)
        bounds = tuple(float(b) for b in buckets)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise MetricError(
                f"{name}: buckets must be distinct ascending upper bounds, "
                f"got {buckets!r}")
        if any(not math.isfinite(b) for b in bounds):
            raise MetricError(f"{name}: +Inf bucket is implicit; pass only "
                              "finite bounds")
        self.buckets = bounds
        self._init_default_series()

    def _init_default_series(self) -> None:
        if not self.labelnames:
            self._series[()] = _HistSeries(len(self.buckets) + 1)

    def _series_for(self, key) -> _HistSeries:
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistSeries(len(self.buckets) + 1)
        return s

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        key = self._key(labels)
        idx = len(self.buckets)  # overflow (+Inf) bucket
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                idx = i
                break
        with self._lock:
            s = self._series_for(key)
            s.counts[idx] += 1
            s.sum += value
            s.count += 1
            if value > s.max:
                s.max = value

    # -- readouts ----------------------------------------------------------

    def count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(self._key(labels))
            return int(s.count) if s else 0

    def total(self, **labels) -> float:
        with self._lock:
            s = self._series.get(self._key(labels))
            return float(s.sum) if s else 0.0

    def max_value(self, **labels) -> float:
        with self._lock:
            s = self._series.get(self._key(labels))
            return float(s.max) if s and s.count else 0.0

    def percentile(self, q: float, **labels) -> float:
        """Estimated q-th percentile (0..100) by linear interpolation
        within the containing bucket — the standard fixed-bucket
        estimator (Prometheus ``histogram_quantile``). Exact to bucket
        resolution; the overflow bucket interpolates up to the observed
        max rather than infinity."""
        if not 0 <= q <= 100:
            raise MetricError(f"{self.name}: percentile q={q} out of [0,100]")
        with self._lock:
            s = self._series.get(self._key(labels))
            if s is None or s.count == 0:
                return 0.0
            rank = (q / 100.0) * s.count
            cum = 0.0
            lower = 0.0
            for i, c in enumerate(s.counts):
                upper = (self.buckets[i] if i < len(self.buckets)
                         else max(s.max, lower))
                if c and cum + c >= rank:
                    frac = min(1.0, max(0.0, (rank - cum) / c))
                    return min(lower + (upper - lower) * frac, s.max)
                cum += c
                if i < len(self.buckets):
                    lower = self.buckets[i]
            return float(s.max)

    def samples(self):
        out = []
        with self._lock:
            for key, s in sorted(self._series.items()):
                labels = self._labels_dict(key)
                cum = 0
                for i, bound in enumerate(self.buckets):
                    cum += s.counts[i]
                    out.append(("_bucket", dict(labels, le=_fmt_bound(bound)),
                                float(cum)))
                cum += s.counts[-1]
                out.append(("_bucket", dict(labels, le="+Inf"), float(cum)))
                out.append(("_sum", dict(labels), float(s.sum)))
                out.append(("_count", dict(labels), float(s.count)))
        return out


def _fmt_bound(b: float) -> str:
    return str(int(b)) if float(b).is_integer() else repr(float(b))


class MetricsRegistry:
    """Name -> family map; one shared instance per process."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kwargs) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(name, help, labelnames, **kwargs)
                self._families[name] = fam
                return fam
        if not isinstance(fam, cls):
            raise MetricError(
                f"{name} is already registered as a {fam.kind}, not a "
                f"{cls.kind}")
        if tuple(labelnames) != fam.labelnames:
            raise MetricError(
                f"{name}: label names {tuple(labelnames)} conflict with the "
                f"registered {fam.labelnames}")
        if (isinstance(fam, Histogram) and "buckets" in kwargs
                and tuple(float(b) for b in kwargs["buckets"]) != fam.buckets):
            raise MetricError(f"{name}: bucket layout conflicts with the "
                              "registered one")
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        kwargs = {"buckets": tuple(buckets)} if buckets is not None else {}
        return self._get_or_create(Histogram, name, help, labelnames, **kwargs)

    def collect(self) -> List[_Family]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    def reset(self) -> None:
        """Zero every series while keeping family objects alive — call
        sites hold module-level references, so tests reset values, not
        identities."""
        for fam in self.collect():
            fam.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every layer records into."""
    return _REGISTRY


def counter(name: str, help: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    return _REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
    return _REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None) -> Histogram:
    return _REGISTRY.histogram(name, help, labelnames, buckets=buckets)
