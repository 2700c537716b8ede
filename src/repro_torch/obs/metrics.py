"""MetricsRegistry: bounded-memory counters, gauges, log-spaced histograms.

The serve-time metrics substrate (paper §5.5's budget, made observable):
every instrument is preallocated — a histogram is a fixed numpy int64 bin
vector over log-spaced edges, a counter/gauge one float — so the hot path
never appends to a list and memory is bounded no matter how long the
process serves. `record`/`inc` are O(1): one `bisect` over ~80 edges
plus a few scalar updates under a per-instrument lock (uncontended CPython
locks are ~100 ns; `route_batch` records ~10 values per *batch*, so the
instrumentation budget is microseconds against a millisecond batch —
`benchmarks/obs_bench.py` enforces the <5 % overhead bound in CI).

Instruments are get-or-create by (name, labels) — calling
``registry.histogram("route_phase_ms", phase="embed")`` twice returns the
same object, so planes can resolve instruments at construction time and
share them across threads. ``render_prometheus()`` emits the standard text
exposition (cumulative ``_bucket{le=...}`` + ``_sum``/``_count``);
``snapshot()`` returns the JSON-friendly view the health surface and
examples use.

A process-wide default registry (`get_registry()`) backs instruments in
code that cannot plumb one through (the gateway defaults to it); tests pass
their own `MetricsRegistry()` for isolation.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import clock

__all__ = [
    "Counter",
    "Gauge",
    "LogHistogram",
    "MetricsRegistry",
    "default_edges",
    "get_registry",
]


def default_edges(
    lo: float = 1e-3, hi: float = 1e4, per_decade: int = 10
) -> np.ndarray:
    """Log-spaced bucket upper edges: `per_decade` buckets per decade of
    [lo, hi]. The default (1 µs .. 10 s in ms units, 10/decade) resolves
    percentiles to ~26 % relative error worst-case — plenty against a
    10 ms budget — with 71 preallocated bins."""
    n = int(round(per_decade * math.log10(hi / lo)))
    return np.geomspace(lo, hi, n + 1)


class Counter:
    """Monotone event counter. `inc` is thread-safe (per-instrument lock)."""

    kind = "counter"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins scalar (versions, freshness flags, queue depths)."""

    kind = "gauge"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def value(self) -> float:
        with self._lock:
            return self._value


class LogHistogram:
    """Fixed log-spaced-bucket histogram with O(1) bounded-memory record.

    Bucket i counts values <= edges[i] (first bucket catches everything
    below `lo`, one overflow bucket everything above `hi`). Exact count,
    sum, min, and max are tracked alongside, so `mean()` is exact and
    `percentile()` clamps its bucket-interpolated estimate to the observed
    range — a one-sample histogram reports that sample, not a bucket edge.
    """

    kind = "histogram"

    def __init__(
        self,
        name: str,
        labels: Tuple[Tuple[str, str], ...] = (),
        edges: Optional[np.ndarray] = None,
    ):
        self.name = name
        self.labels = labels
        self.edges = np.asarray(edges if edges is not None else default_edges(),
                                dtype=np.float64)
        assert self.edges.ndim == 1 and len(self.edges) >= 2
        assert bool(np.all(np.diff(self.edges) > 0)), "edges must be ascending"
        # scalar bucket lookup uses bisect over this plain list: ~20x less
        # per-call overhead than numpy's scalar searchsorted (~2 µs), which
        # obs_bench's profile showed dominating the per-record cost at ~7
        # records per batch
        self._edges_list: List[float] = self.edges.tolist()
        self._counts = np.zeros(len(self.edges) + 1, dtype=np.int64)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        # per-bucket most-recent exemplar slots, allocated lazily on the
        # first record(..., exemplar=) so histograms that never attach
        # exemplars pay nothing (no flag needed at get-or-create time)
        self._exemplars: Optional[List[Optional[Tuple[object, float, float]]]] = None
        self._lock = threading.Lock()

    def record(self, value: float, exemplar: Optional[object] = None) -> None:
        """Record one value; `exemplar` optionally tags its bucket with an
        opaque id (a sampled trace id) — most-recent-wins per bucket."""
        v = float(value)
        # bucket index outside the lock: bisect is pure computation (and
        # matches searchsorted side="left" exactly)
        i = bisect.bisect_left(self._edges_list, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if exemplar is not None:
                if self._exemplars is None:
                    self._exemplars = [None] * len(self._counts)
                self._exemplars[i] = (exemplar, v, clock.wall())

    def record_many(self, values) -> None:
        """Bulk record: one vectorized bucket pass + one lock acquisition.

        The per-batch cost is one `searchsorted` + `bincount` over the whole
        array, so per-query instruments (score gaps: batch-size values per
        route_batch) stay inside the telemetry overhead budget.
        """
        v = np.asarray(values)
        if v.ndim != 1:
            v = v.ravel()
        if v.size == 0:
            return
        idx = np.searchsorted(self.edges, v, side="left")
        binned = np.bincount(idx, minlength=len(self._counts)).astype(
            np.int64, copy=False
        )
        total, s = int(v.size), float(v.sum())
        lo, hi = float(v.min()), float(v.max())
        with self._lock:
            self._counts += binned
            self._count += total
            self._sum += s
            if lo < self._min:
                self._min = lo
            if hi > self._max:
                self._max = hi

    # ---------------------------------------------------------------- reading
    def count(self) -> int:
        with self._lock:
            return self._count

    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def bucket_counts(self) -> np.ndarray:
        with self._lock:
            return self._counts.copy()

    def percentile(self, q: float) -> float:
        """Bucket-interpolated percentile estimate (exact to one bucket).

        Finds the bucket holding the q-th sample and interpolates linearly
        inside it; the estimate is clamped to the exact observed [min, max]
        so it can never leave the data range.
        """
        with self._lock:
            counts = self._counts.copy()
            total, lo, hi = self._count, self._min, self._max
        if total == 0:
            return 0.0
        rank = q / 100.0 * total
        cum = np.cumsum(counts)
        i = int(np.searchsorted(cum, rank, side="left"))
        i = min(i, len(counts) - 1)
        left = self.edges[i - 1] if 0 < i <= len(self.edges) else lo
        right = self.edges[i] if i < len(self.edges) else hi
        prev = cum[i - 1] if i > 0 else 0
        in_bucket = counts[i]
        frac = (rank - prev) / in_bucket if in_bucket else 0.0
        est = left + (right - left) * min(max(frac, 0.0), 1.0)
        return float(min(max(est, lo), hi))

    def exemplars(self) -> Dict[int, Tuple[object, float, float]]:
        """{bucket_index: (exemplar_id, value, wall_ts)} for tagged buckets."""
        with self._lock:
            if self._exemplars is None:
                return {}
            return {i: e for i, e in enumerate(self._exemplars) if e is not None}

    def percentile_exemplar(self, q: float) -> Optional[Tuple[object, float, float]]:
        """The exemplar nearest the q-th percentile's bucket, or None.

        Prefers the percentile bucket itself, then higher buckets (the tail
        the percentile summarizes), then lower ones — so "your p99 bucket →
        this trace" degrades gracefully when sampling missed that bucket.
        """
        with self._lock:
            if self._exemplars is None or self._count == 0:
                return None
            counts = self._counts.copy()
            total = self._count
            slots = list(self._exemplars)
        rank = q / 100.0 * total
        cum = np.cumsum(counts)
        i = min(int(np.searchsorted(cum, rank, side="left")), len(counts) - 1)
        for j in list(range(i, len(slots))) + list(range(i - 1, -1, -1)):
            if slots[j] is not None:
                return slots[j]
        return None

    def summary(self) -> Dict[str, float]:
        with self._lock:
            total, lo, hi = self._count, self._min, self._max
            has_exemplars = self._exemplars is not None
        out = {
            "count": total,
            "mean": self.mean(),
            "p50": self.percentile(50.0),
            "p90": self.percentile(90.0),
            "p99": self.percentile(99.0),
            "min": lo if total else 0.0,
            "max": hi if total else 0.0,
        }
        if has_exemplars:
            ex = self.percentile_exemplar(99.0)
            if ex is not None:
                out["p99_exemplar"] = ex[0]
        return out


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash first (so the
    escapes it introduces are not re-escaped), then quote and newline."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label_value(v)}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class MetricsRegistry:
    """Process-wide instrument store: get-or-create by (name, labels)."""

    def __init__(self):
        self._instruments: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}
        self._kinds: Dict[str, str] = {}  # name -> kind (one kind per name)
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: Dict[str, str], **kw):
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                if self._kinds.setdefault(name, cls.kind) != cls.kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{self._kinds[name]}, not {cls.kind}"
                    )
                inst = self._instruments[key] = cls(name, key[1], **kw)
            elif not isinstance(inst, cls):
                raise ValueError(f"metric {name!r}{labels} is a {inst.kind}")
            return inst

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(
        self, name: str, edges: Optional[np.ndarray] = None, **labels: str
    ) -> LogHistogram:
        return self._get(LogHistogram, name, labels, edges=edges)

    def instruments(self) -> List[object]:
        with self._lock:
            return list(self._instruments.values())

    # ---------------------------------------------------------------- export
    def snapshot(self) -> Dict[str, dict]:
        """JSON-friendly view: {kind: {"name{labels}": value-or-summary}}."""
        out: Dict[str, dict] = {"counters": {}, "gauges": {}, "histograms": {}}
        for inst in self.instruments():
            key = inst.name + _label_str(inst.labels)
            if inst.kind == "counter":
                out["counters"][key] = inst.value()
            elif inst.kind == "gauge":
                out["gauges"][key] = inst.value()
            else:
                out["histograms"][key] = inst.summary()
        return out

    def render_prometheus(self) -> str:
        """Standard Prometheus text exposition (one scrape = one call)."""
        by_name: Dict[str, List[object]] = {}
        for inst in self.instruments():
            by_name.setdefault(inst.name, []).append(inst)
        lines: List[str] = []
        for name in sorted(by_name):
            insts = by_name[name]
            lines.append(f"# TYPE {name} {insts[0].kind}")
            for inst in insts:
                if inst.kind in ("counter", "gauge"):
                    lines.append(f"{name}{_label_str(inst.labels)} {inst.value()}")
                    continue
                counts = inst.bucket_counts()
                cum = np.cumsum(counts)
                for i, edge in enumerate(inst.edges):
                    le = f'le="{edge:g}"'
                    lines.append(
                        f"{name}_bucket{_label_str(inst.labels, le)} {cum[i]}"
                    )
                inf = 'le="+Inf"'
                lines.append(
                    f"{name}_bucket{_label_str(inst.labels, inf)} {cum[-1]}"
                )
                with inst._lock:
                    s, c = inst._sum, inst._count
                lines.append(f"{name}_sum{_label_str(inst.labels)} {s}")
                lines.append(f"{name}_count{_label_str(inst.labels)} {c}")
        return "\n".join(lines) + "\n"


_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (the gateway's fallback)."""
    return _DEFAULT
