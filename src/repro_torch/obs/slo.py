"""SLOEngine: declarative SLOs evaluated with multi-window burn rates.

The paper commits to an SLO — "all mechanisms run within single-digit
millisecond CPU budgets" (§5.5) — and the metrics make the raw signals visible;
this module *watches* them. Each `SLO` declares an objective over signals
the `TimeSeriesRing` can window, and the engine evaluates it SRE-style:
the **burn rate** is how fast the error budget is being spent relative to
the rate that would exactly exhaust it over the SLO period (burn 1.0 =
on-budget; burn 14.4 over an hour = the 30-day budget gone in ~2 days),
and an alert requires the burn to exceed the window's ``factor`` over BOTH
the long window (evidence) and the short window (still happening) — the
classic construction that is simultaneously fast on cliffs and quiet on
blips.

Three SLI kinds cover the repo's signals:

* ``latency`` — fraction of histogram samples above ``threshold_ms``
  (exact when the threshold sits on a bucket edge; 10 ms does);
* ``ratio`` — bad/total from counter deltas (exact-fallback serving);
* ``rate`` — events per hour vs an allowed ``max_per_hour`` (guard
  rollbacks, ring drops) — for signals whose budget is "rarely", not
  "a fraction of traffic".

State transitions are events, not logs: entering breach publishes
``slo_burn`` and leaving it publishes ``slo_recovered`` on the EventBus
(at most one per transition — the bus's transitions-only discipline).
`HealthMonitor` folds `burning()` into the process status and `ObsServer`
serves `snapshot()` at ``/slo``. A windowed query that returns None
(insufficient ring data, no traffic) never alerts — an engine with two
ticks of history stays quiet rather than guessing.

For latency SLOs the snapshot carries the live histogram's p99 *exemplar*
(the most recent sampled trace id in the p99 bucket, see
`LogHistogram.record`), closing the loop from "the SLO is burning" to
"here is a RouteTrace from the offending bucket".

Counterpart of `repro/obs/slo.py`, copied with only its imports changed,
and `default_slos()`'s ``jit_retrace_rate`` keys, which name the port's
hot path (`repro_torch.router.gateway.hot_path_jits`).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

from repro_torch.obs import clock
from repro_torch.obs.metrics import MetricsRegistry, _label_str
from repro_torch.obs.timeseries import TimeSeriesRing

__all__ = ["SLO", "BurnWindow", "SLOEngine", "default_slos"]


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """One long/short window pair with its alerting burn factor."""

    long_s: float
    short_s: float
    factor: float  # alert when burn > factor over BOTH windows


# Google SRE's two fastest pairs for a 30-day period: page on a budget
# burning in ~2 days (14.4x over 1h, confirmed over 5m) or in ~5 days
# (6x over 6h, confirmed over 30m). Smoke benches substitute second-scale
# pairs — the math is window-agnostic.
DEFAULT_WINDOWS: Tuple[BurnWindow, ...] = (
    BurnWindow(long_s=3600.0, short_s=300.0, factor=14.4),
    BurnWindow(long_s=21600.0, short_s=1800.0, factor=6.0),
)


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declarative objective over ring-windowable signals."""

    name: str
    kind: str  # "latency" | "ratio" | "rate"
    description: str = ""
    windows: Tuple[BurnWindow, ...] = DEFAULT_WINDOWS
    objective: float = 0.99  # latency/ratio: target good fraction
    # latency ---------------------------------------------------------------
    hist_key: Optional[str] = None  # histogram key in ring points
    threshold_ms: Optional[float] = None  # sample is bad above this
    # ratio -----------------------------------------------------------------
    bad_keys: Tuple[str, ...] = ()  # counters counting bad outcomes
    total_keys: Tuple[str, ...] = ()  # counters summing to the denominator
    # rate ------------------------------------------------------------------
    event_keys: Tuple[str, ...] = ()  # counters counting the events
    max_per_hour: Optional[float] = None  # allowed sustained event rate

    def __post_init__(self):
        assert self.kind in ("latency", "ratio", "rate"), self.kind
        if self.kind == "latency":
            assert self.hist_key and self.threshold_ms is not None
        elif self.kind == "ratio":
            assert self.bad_keys and self.total_keys
        else:
            assert self.event_keys and self.max_per_hour


def default_slos() -> Tuple[SLO, ...]:
    """The repo's serving objectives, over the metric catalog."""
    served = tuple(
        f'index_served_total{{path="{p}"}}' for p in ("exact", "index")
    )
    return (
        SLO(
            name="route_p99_budget",
            kind="latency",
            description="99% of route batches inside the paper's 10 ms budget",
            hist_key="route_batch_ms",
            threshold_ms=10.0,
            objective=0.99,
        ),
        SLO(
            name="exact_fallback_ratio",
            kind="ratio",
            description="fallback-serving windows (exact dense scan instead "
                        "of the built index) stay under 5% of batches",
            bad_keys=(served[0],),
            total_keys=served,
            objective=0.95,
        ),
        SLO(
            name="guard_rollback_rate",
            kind="rate",
            description="table rollbacks + stage demotions stay rare",
            event_keys=(
                'events_total{kind="rollback"}',
                'events_total{kind="demotion"}',
            ),
            max_per_hour=2.0,
        ),
        SLO(
            name="drop_rate",
            kind="rate",
            description="outcome-ring and event-bus overwrites stay rare "
                        "(a sustained rate means a stalled drainer)",
            event_keys=("route_outcomes_dropped_total", "bus_dropped_total"),
            max_per_hour=60.0,
        ),
        SLO(
            name="jit_retrace_rate",
            kind="rate",
            description="post-warmup kernel builds, library loads and first "
                        "route launches on the hot path stay rare (a "
                        "sustained rate means batches reaching a route "
                        "never warmed, or a library rebuilt); counters come "
                        "from obs.profile.JitProfiler.collect",
            # keys mirror repro_torch.router.gateway.hot_path_jits(), not the
            # reference's: the port compiles nothing with XLA, and what it
            # does build and load is the nvcc kernel library (topk_sim, its
            # probe counting the library and each route's first launch).
            # The adapter and re-ranker are eager torch with no compiled
            # program, so the profiler lists them unsupported and their keys
            # stay absent from ring points (no data, never an alert) until
            # they gain a probe. The profiler labels its counters with these
            # names.
            event_keys=(
                'jit_compiles_total{fn="topk_sim"}',
                'jit_compiles_total{fn="adapter_apply"}',
                'jit_compiles_total{fn="rerank_topk_scored"}',
            ),
            max_per_hour=12.0,
        ),
        SLO(
            name="cache_staleness",
            kind="rate",
            description="route-cache entries served from a dead snapshot "
                        "stay at zero (the gateway tripwire re-checks every "
                        "hit's (table_version, stage_version) stamps against "
                        "the live pair and demotes mismatches to misses, so "
                        "any count here means the stamp discipline broke)",
            event_keys=("route_cache_stale_served_total",),
            max_per_hour=1.0,
        ),
    )


class SLOEngine:
    """Evaluates SLOs against a TimeSeriesRing, publishing transitions.

    `evaluate()` is the single judgement entry point (the ring's ``on_tick``
    cadence, the health monitor, and the ``/slo`` endpoint all route through
    it) so `slo_burn`/`slo_recovered` fire exactly once per state change no
    matter how many surfaces poll.
    """

    def __init__(
        self,
        ring: TimeSeriesRing,
        slos: Optional[Tuple[SLO, ...]] = None,
        bus=None,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.ring = ring
        self.slos: Tuple[SLO, ...] = tuple(slos) if slos is not None else default_slos()
        names = [s.name for s in self.slos]
        assert len(set(names)) == len(names), f"duplicate SLO names: {names}"
        self.bus = bus
        self.registry = registry
        self._burning: Dict[str, bool] = {s.name: False for s in self.slos}
        self._lock = threading.Lock()

    # ---------------------------------------------------------------- burn math
    def _burn(self, slo: SLO, window_s: float, now: Optional[float]) -> Optional[float]:
        """Burn rate of `slo` over one trailing window (None = no data)."""
        if slo.kind == "latency":
            wh = self.ring.window_hist(slo.hist_key, window_s, now=now)
            if wh is None:
                return None
            bad = wh.fraction_gt(slo.threshold_ms)
            if bad is None:
                return None
            return bad / max(1.0 - slo.objective, 1e-9)
        if slo.kind == "ratio":
            deltas = [self.ring.delta(k, window_s, now=now) for k in slo.total_keys]
            if all(d is None for d in deltas):
                return None
            total = sum(d for d in deltas if d is not None)
            if total <= 0:
                return None
            bad = sum(
                d for d in (self.ring.delta(k, window_s, now=now)
                            for k in slo.bad_keys)
                if d is not None
            )
            return (bad / total) / max(1.0 - slo.objective, 1e-9)
        # rate: events per hour over the actual covered span
        pair = self.ring.window(window_s, now=now)
        if pair is None:
            return None
        start, end = pair
        span = end.mono - start.mono
        if span <= 0:
            return None
        deltas = [self.ring.delta(k, window_s, now=now) for k in slo.event_keys]
        if all(d is None for d in deltas):
            return None
        events = sum(d for d in deltas if d is not None)
        per_hour = events * 3600.0 / span
        return per_hour / slo.max_per_hour

    def _latency_detail(self, slo: SLO) -> dict:
        """Live p99 + exemplar trace id for a latency SLO's histogram."""
        out: dict = {"threshold_ms": slo.threshold_ms}
        for inst in self.ring.registry.instruments():
            if inst.kind != "histogram":
                continue
            if inst.name + _label_str(inst.labels) != slo.hist_key:
                continue
            if inst.count():
                out["p99_ms"] = inst.percentile(99.0)
                ex = inst.percentile_exemplar(99.0)
                if ex is not None:
                    out["p99_exemplar"] = ex[0]
            break
        return out

    # ---------------------------------------------------------------- judging
    def evaluate(self, now: Optional[float] = None) -> dict:
        """Judge every SLO; publish transitions; return the full snapshot."""
        slos: Dict[str, dict] = {}
        transitions: List[Tuple[str, dict]] = []
        with self._lock:
            for slo in self.slos:
                windows = []
                breaching = False
                worst: Optional[float] = None
                for w in slo.windows:
                    burn_long = self._burn(slo, w.long_s, now)
                    burn_short = self._burn(slo, w.short_s, now)
                    hit = (
                        burn_long is not None
                        and burn_short is not None
                        and burn_long > w.factor
                        and burn_short > w.factor
                    )
                    breaching = breaching or hit
                    if burn_long is not None:
                        worst = burn_long if worst is None else max(worst, burn_long)
                    windows.append({
                        "long_s": w.long_s,
                        "short_s": w.short_s,
                        "factor": w.factor,
                        "burn_long": burn_long,
                        "burn_short": burn_short,
                        "breaching": hit,
                    })
                was = self._burning[slo.name]
                self._burning[slo.name] = breaching
                entry = {
                    "kind": slo.kind,
                    "description": slo.description,
                    "objective": slo.objective if slo.kind != "rate" else None,
                    "max_per_hour": slo.max_per_hour,
                    "burning": breaching,
                    "burn": worst,
                    "windows": windows,
                }
                if slo.kind == "latency":
                    entry.update(self._latency_detail(slo))
                slos[slo.name] = entry
                if breaching and not was:
                    # "sli", not "kind": the bus reserves `kind` for the
                    # event kind itself
                    details = {
                        "slo": slo.name, "sli": slo.kind, "burn": worst,
                    }
                    details.update({
                        k: entry[k] for k in ("threshold_ms", "p99_ms",
                                              "p99_exemplar")
                        if k in entry
                    })
                    transitions.append(("slo_burn", details))
                elif was and not breaching:
                    transitions.append(
                        ("slo_recovered", {"slo": slo.name, "sli": slo.kind})
                    )
                if self.registry is not None:
                    self.registry.gauge("slo_burning", slo=slo.name).set(
                        1.0 if breaching else 0.0
                    )
                    if worst is not None:
                        self.registry.gauge("slo_burn_rate", slo=slo.name).set(worst)
        # publish outside the engine lock: subscribers may read the engine
        if self.bus is not None:
            for kind, details in transitions:
                self.bus.publish(kind, plane="serve", **details)
        return {
            "status": "burning" if any(s["burning"] for s in slos.values()) else "ok",
            "burning": [n for n, s in slos.items() if s["burning"]],
            "evaluated_at": clock.wall(),
            "slos": slos,
        }

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Alias for `evaluate` — every read surface judges through it."""
        return self.evaluate(now=now)

    def burning(self) -> List[str]:
        """Names currently in breach (last evaluation's state, no re-judge)."""
        with self._lock:
            return [n for n, b in self._burning.items() if b]
