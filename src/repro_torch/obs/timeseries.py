"""TimeSeriesRing: bounded in-process history for windowed metric queries.

The registry's counters and histograms are *cumulative* — perfect for a
Prometheus scrape, useless for "what was the p99 over the last minute"
without an external TSDB. This module closes that gap in-process: `tick()`
snapshots every counter value and histogram bucket vector into a bounded
ring, and windowed queries (`rate`, `delta`, `window_hist`) are computed
from the difference between the newest point and the oldest point inside
the window. Memory is bounded by ``capacity`` points regardless of uptime,
in the same spirit as `EventBus` and `OutcomeStore`.

Two-sample semantics: every windowed query needs *two* points (a start and
an end) to form a difference, so with fewer than two ticks in the window
the query returns ``None`` rather than a fabricated zero — callers (the
SLO engine) treat None as "insufficient data", which never alerts.

`start(interval_s)` runs the cadence on a daemon thread that stamps
`last_loop_error` on failure (the thread-discipline contract every daemon
loop in this repo follows); an optional ``on_tick`` hook lets the SLO
engine evaluate on the same cadence without a second thread. When a ``bus``
is attached, per-kind event counts and the bus drop counter are mirrored
into each point as synthetic counters (``events_total{kind="..."}``,
``bus_dropped_total``) so event *rates* — rollbacks per hour, drops per
hour — are windowable like any other counter.

Counterpart of `repro/obs/timeseries.py`, copied with only its imports changed (it
imports no JAX).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import clock
from repro_torch.obs.metrics import MetricsRegistry, _label_str

__all__ = ["HistPoint", "HistWindow", "TimeSeriesRing", "TsPoint"]


@dataclasses.dataclass(frozen=True)
class HistPoint:
    """Cumulative histogram state at one tick."""

    count: int
    sum: float
    buckets: np.ndarray  # cumulative per-bucket counts (len(edges) + 1)
    edges: np.ndarray


@dataclasses.dataclass(frozen=True)
class TsPoint:
    """One snapshot of the registry (+ synthetic bus counters)."""

    mono: float  # monotonic seconds (window arithmetic)
    wall: float  # epoch seconds (display)
    counters: Dict[str, float]
    gauges: Dict[str, float]
    hists: Dict[str, HistPoint]


@dataclasses.dataclass(frozen=True)
class HistWindow:
    """Histogram activity between two ticks: bucket deltas + exact count/sum.

    `quantile` interpolates inside the log-spaced buckets exactly like
    `LogHistogram.percentile`, but clamped to the nonzero bucket span (the
    window has no exact min/max — those are cumulative).
    """

    count: int
    sum: float
    buckets: np.ndarray
    edges: np.ndarray
    span_s: float  # elapsed monotonic seconds between the two ticks

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> Optional[float]:
        if self.count <= 0:
            return None
        rank = q / 100.0 * self.count
        cum = np.cumsum(self.buckets)
        i = min(int(np.searchsorted(cum, rank, side="left")),
                len(self.buckets) - 1)
        left = self.edges[i - 1] if 0 < i <= len(self.edges) else self.edges[0]
        right = self.edges[i] if i < len(self.edges) else self.edges[-1]
        prev = cum[i - 1] if i > 0 else 0
        in_bucket = self.buckets[i]
        frac = (rank - prev) / in_bucket if in_bucket else 0.0
        return float(left + (right - left) * min(max(frac, 0.0), 1.0))

    def fraction_gt(self, threshold: float) -> Optional[float]:
        """Fraction of window samples above `threshold` (the latency SLI).

        Exact when `threshold` lies on a bucket edge (the 10 ms budget does,
        on the default edges); otherwise the straddling bucket counts as
        *above* — the conservative direction for an alert.
        """
        if self.count <= 0:
            return None
        n_le = int(np.searchsorted(self.edges, threshold, side="right"))
        good = int(self.buckets[:n_le].sum())
        return float(self.count - good) / float(self.count)


class TimeSeriesRing:
    """Bounded ring of registry snapshots + windowed queries over them."""

    def __init__(
        self,
        registry: MetricsRegistry,
        bus=None,
        capacity: int = 512,
    ):
        assert capacity >= 2
        self.registry = registry
        self.bus = bus
        self.capacity = int(capacity)
        self._ring: Deque[TsPoint] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.last_loop_error: Optional[str] = None
        self.interval_s: Optional[float] = None

    # ---------------------------------------------------------------- ticking
    def tick(self, now: Optional[float] = None) -> TsPoint:
        """Snapshot every instrument (and bus counts) into one ring point.

        `now` is injectable (monotonic seconds) so tests and benches can
        drive deterministic windows without sleeping.
        """
        mono = clock.monotonic() if now is None else float(now)
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, HistPoint] = {}
        for inst in self.registry.instruments():
            key = inst.name + _label_str(inst.labels)
            if inst.kind == "counter":
                counters[key] = inst.value()
            elif inst.kind == "gauge":
                gauges[key] = inst.value()
            else:
                with inst._lock:
                    count, total = inst._count, inst._sum
                    buckets = inst._counts.copy()
                hists[key] = HistPoint(count, total, buckets, inst.edges)
        if self.bus is not None:
            for kind, n in self.bus.counts().items():
                counters[f'events_total{{kind="{kind}"}}'] = float(n)
            counters["bus_dropped_total"] = float(self.bus.dropped)
        point = TsPoint(mono, clock.wall(), counters, gauges, hists)
        with self._lock:
            self._ring.append(point)
        return point

    # ---------------------------------------------------------------- daemon
    def start(
        self,
        interval_s: float = 1.0,
        on_tick: Optional[Callable[["TimeSeriesRing"], None]] = None,
    ) -> "TimeSeriesRing":
        """Tick on a daemon thread every `interval_s`; `on_tick(self)` runs
        after each snapshot (the SLO engine's evaluation cadence)."""
        assert self._thread is None, "ring already started"
        self.interval_s = float(interval_s)
        self._stop.clear()

        def _loop():
            while not self._stop.is_set():
                try:
                    self.tick()
                    if on_tick is not None:
                        on_tick(self)
                    self.last_loop_error = None
                except Exception as exc:  # noqa: BLE001 — daemon must survive
                    self.last_loop_error = f"{type(exc).__name__}: {exc}"
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(
            target=_loop, name="timeseries-ring", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        """Idempotent: signals the ticker and joins with a bounded wait."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=timeout_s)
        self._thread = None

    def thread(self) -> Optional[threading.Thread]:
        """The cadence daemon (None unless started)."""
        return self._thread

    # ---------------------------------------------------------------- reading
    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def points(self) -> List[TsPoint]:
        with self._lock:
            return list(self._ring)

    def last_point(self) -> Optional[TsPoint]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def window(
        self, seconds: float, now: Optional[float] = None
    ) -> Optional[Tuple[TsPoint, TsPoint]]:
        """(start, end) pair spanning the trailing window, or None.

        `end` is the newest point; `start` is the oldest point still inside
        the window. None when fewer than two points fall in the window —
        a single sample cannot form a rate or a quantile delta.
        """
        with self._lock:
            pts = list(self._ring)
        if not pts:
            return None
        end = pts[-1]
        cutoff = (end.mono if now is None else float(now)) - float(seconds)
        inside = [p for p in pts if p.mono >= cutoff]
        if len(inside) < 2:
            return None
        return inside[0], end

    def delta(
        self, counter_key: str, seconds: float, now: Optional[float] = None
    ) -> Optional[float]:
        """Counter increase across the window (None = insufficient data)."""
        pair = self.window(seconds, now=now)
        if pair is None:
            return None
        start, end = pair
        if counter_key not in end.counters:
            return None
        return end.counters[counter_key] - start.counters.get(counter_key, 0.0)

    def rate(
        self, counter_key: str, seconds: float, now: Optional[float] = None
    ) -> Optional[float]:
        """Counter increase per second over the *actual* covered span."""
        pair = self.window(seconds, now=now)
        if pair is None:
            return None
        start, end = pair
        span = end.mono - start.mono
        if span <= 0 or counter_key not in end.counters:
            return None
        d = end.counters[counter_key] - start.counters.get(counter_key, 0.0)
        return d / span

    def window_hist(
        self, hist_key: str, seconds: float, now: Optional[float] = None
    ) -> Optional[HistWindow]:
        """Histogram activity inside the window, as bucket-count deltas."""
        pair = self.window(seconds, now=now)
        if pair is None:
            return None
        start, end = pair
        h1 = end.hists.get(hist_key)
        if h1 is None:
            return None
        h0 = start.hists.get(hist_key)
        if h0 is None or len(h0.buckets) != len(h1.buckets):
            buckets = h1.buckets.copy()
            count, total = h1.count, h1.sum
        else:
            buckets = h1.buckets - h0.buckets
            count, total = h1.count - h0.count, h1.sum - h0.sum
        return HistWindow(
            count=int(count),
            sum=float(total),
            buckets=buckets,
            edges=h1.edges,
            span_s=end.mono - start.mono,
        )
