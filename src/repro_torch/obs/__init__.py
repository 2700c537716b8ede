"""Telemetry plane: metrics, route tracing, events, quality, health.

Counterpart of `repro.obs`, module for module, with the same instruments
and event kinds (catalog below):

* `repro_torch.obs.metrics` — process-wide `MetricsRegistry` of counters,
  gauges and preallocated log-spaced-bucket histograms (O(1) record,
  bounded memory); Prometheus text exposition + JSON snapshot.
* `repro_torch.obs.trace` — seeded ~1-in-N sampled `RouteTracer`: per-batch
  phase spans stamped with versions, JSONL export.
* `repro_torch.obs.events` — bounded `EventBus` the control and index
  planes publish lifecycle transitions into.
* `repro_torch.obs.quality` — `QualityMonitor`: rolling NDCG@5/Recall@5 on
  labelled traffic (via `RollingWindows`, the machinery `TableGuard`
  shares), top-1/top-2 score-gap confidence, and a label-free
  query-embedding drift detector that publishes ``quality_drift`` before
  the guard has enough labels to act.
* `repro_torch.obs.timeseries` — `TimeSeriesRing`, a bounded ring of
  periodic registry snapshots with windowed rates, deltas and quantiles.
* `repro_torch.obs.health` — `HealthMonitor` JSON snapshot
  (ok/degraded/error) + `ObsServer` HTTP exposition (``/metrics``,
  ``/health``, ``/events``, ``/slo``, ``/traces``, ``/dumps``,
  ``/profile``), wired into `launch/serve.py` behind ``--metrics-port``.
* `repro_torch.obs.slo` — declarative `SLO`s (`default_slos()`) evaluated
  by `SLOEngine` with multi-window burn rates; transitions publish
  ``slo_burn``/``slo_recovered``, `HealthMonitor` degrades while burning.
* `repro_torch.obs.flightrec` — `FlightRecorder`: on a trigger event or a
  fatal crash (`record_crash`) it freezes the telemetry state into one
  atomic, debounced, retention-capped dump directory, in the reference's
  format (`DUMP_FORMAT_VERSION`): dumps cross between the packages both
  ways. `render_replay` renders one offline.
* `repro_torch.obs.profile` — `JitProfiler` over
  `repro_torch.router.gateway.hot_path_jits()` (for the port: the
  `topk_sim` kernel library loaded plus the routes launched at least once;
  the first collect baselines warmup), `stamp_router_costs` (the kernel's
  analytic FLOPs/bytes and route at the served shapes), and the opt-in
  `SamplingProfiler` over the cadence daemons (``--profile-daemons``).
* `repro_torch.obs.report` — renders trace JSONL, follows ``/events``,
  runs the ``--watch`` panel and replays dumps
  (``python -m repro_torch.obs.report``).

`repro_torch.obs.clock` is the timing module for `router/`, `index/`,
`control/` and `learn/` (the `obs-discipline` lint rule enforces it), and
`repro_torch.obs.summary` is the one percentile implementation.

Metric catalog (gateway + index layer)
======================================

route_requests_total (counter)
    Queries routed, summed over batches.
route_batches_total (counter)
    `route_batch` calls served.
route_phase_ms{phase=embed|cache|adapter|score|rerank|assemble} (histogram)
    Per-batch wall duration of each serving phase, monotonic clock.
route_batch_ms (histogram)
    End-to-end per-batch duration (sum of phases + overhead).
route_batch_size (histogram)
    Raw batch sizes (pre pow2 padding).
route_table_version / route_stage_version (gauge)
    Versions stamped on the most recent batch.
route_outcomes_dropped_total (counter)
    Outcome-ring overwrites in `record_outcome` (undrained router).
route_cache_hits_total / route_cache_misses_total (counter)
    `SemanticRouteCache` lookup outcomes (a hit = cosine >= threshold on
    a live-stamped entry); hit ratio also exported directly.
route_cache_hit_ratio (gauge)
    Lifetime hits / (hits + misses) — the runbook's headline cache dial.
route_cache_size (gauge)
    Retained key slots (one decision occupies `n_tables` slots).
route_cache_evictions_total (counter)
    LRU slots dropped past `capacity`.
route_cache_invalidated_total (counter)
    Entries purged on version-stamp mismatch (swap/rollback/stage churn).
route_cache_stale_served_total (counter)
    Gateway-tripwire demotions: a cache hit whose stamps no longer match
    the live `(table_version, stage_version)` at serve time. MUST stay 0
    (`chip_smoke.py`'s cache leg and the JAX package's cache_bench gate on it).
index_served_total{path=index|exact} (counter)
    Batches served by the built backend vs the exact dense fallback
    (fallback-serving windows during rebuilds).
index_rebuilds_total / index_build_failures_total (counter)
    Index lifecycle outcomes, mirroring `ToolIndexManager.stats`.
index_build_ms (histogram)
    Build durations (k-means rebuilds dominate).
route_score_gap (histogram)
    Per-query top-1 minus top-2 score (routing confidence; one vectorized
    `record_many` pass, sampled 1-in-4 batches).
quality_ndcg{k=} / quality_recall{k=} (gauge)
    `QualityMonitor`'s rolling labelled-traffic means.
quality_drift_score (gauge)
    RMS z-score of the query-mean EWMA vs the live table's population
    stats (the label-free drift signal).
slo_burning{slo=} / slo_burn_rate{slo=} (gauge)
    Per-SLO breach state (0/1) and worst long-window burn rate, updated
    on every `SLOEngine.evaluate`.
jit_compiles_total{fn=} (counter)
    Post-warmup growth of a hot-path entry's `_cache_size()` (for the
    port: `topk_sim`'s library loads and first route launches; fn names
    from `hot_path_jits()`) — the live retrace signal behind the
    ``jit_retrace_rate`` SLO.
jit_cache_size{fn=} (gauge)
    Absolute `_cache_size()` per hot-path entry (warmup included).
flightrec_dumps_total / flightrec_suppressed_total (counter)
    Black-box dumps written vs suppressed by the debounce window.

Event catalog (kind / plane / required detail stamps)
=====================================================

swap / control — version
    Any `ToolsDatabase` version change (via `EventBus.watch_db`): gated
    controller swaps, guard rollbacks, out-of-band deploys.
stage_swap / learn — version
    Any router StageSet change (promotion, demotion, out-of-band).
rollback / control — condemned_version, restored_version, ndcg, baseline
    `TableGuard` condemned the live table and restored a retained one.
demotion / learn — condemned_version, restored_version, ndcg, baseline
    `StageGuard` condemned the live StageSet.
promotion / learn — stage, from_version, to_version, artifact_version
    `LearningController` activated a gated artifact.
gate_reject / control|learn — stage (learn), reason
    A trained candidate failed its held-out gate.
cooldown / control|learn — purged
    Post-rollback/demotion window purge + trigger reset.
rebuild_start, rebuild_finish / index — version, backend (+build_ms)
    Index rebuild lifecycle for one table version.
rebuild_failure / index — version, backend, error
    Build raised; the exact fallback keeps serving.
loop_error / control|learn — controller, error
    A daemon `step()` raised (`last_loop_error` set).
loop_recovered / control|learn — controller
    The next step succeeded (`last_loop_error` cleared).
outcomes_dropping / serve — dropped
    A router's outcome ring overflowed for the first time.
slo_burn / serve — slo, sli, burn (+threshold_ms, p99_ms, p99_exemplar)
    An SLO entered breach: burn > factor over both windows of some pair
    (``sli`` is the SLI kind — latency|ratio|rate).
slo_recovered / serve — slo, sli
    The SLO's next evaluation saw the breach gone.
cache_invalidated / serve — table_version, stage_version, purged, reason
    `SemanticRouteCache` purged >=1 version-stamp-mismatched entries
    (eager path via `cache.watch(bus)`; lazy lookup purges count in
    ``route_cache_invalidated_total`` without an event).
quality_drift / serve — score, threshold, table_version
    The query-population EWMA left the live table's population stats
    (rising edge only; re-arms when the score falls back under).

The flight recorder consumes (never publishes) bus events: its trigger
set is exactly {slo_burn, quality_drift, loop_error, rollback, demotion}
plus out-of-band crashes, and a dump only reads latched judgement state
(`SLOEngine.burning`), so recording can never cause the transitions it
records.
"""
from repro_torch.obs import clock
from repro_torch.obs.events import Event, EventBus
from repro_torch.obs.flightrec import (
    FlightRecorder,
    list_dumps,
    load_dump,
    render_replay,
)
from repro_torch.obs.health import HealthMonitor, ObsServer
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    LogHistogram,
    MetricsRegistry,
    default_edges,
    get_registry,
)
from repro_torch.obs.profile import JitProfiler, SamplingProfiler, stamp_router_costs
from repro_torch.obs.quality import QualityConfig, QualityMonitor, RollingWindows
from repro_torch.obs.slo import SLO, BurnWindow, SLOEngine, default_slos
from repro_torch.obs.summary import LatencyStats, percentile_stats, stats_from_histogram
from repro_torch.obs.timeseries import HistWindow, TimeSeriesRing
from repro_torch.obs.trace import RouteTrace, RouteTracer, TraceSampler

__all__ = [
    "clock",
    "Event",
    "EventBus",
    "HealthMonitor",
    "ObsServer",
    "Counter",
    "Gauge",
    "LogHistogram",
    "MetricsRegistry",
    "default_edges",
    "get_registry",
    "LatencyStats",
    "percentile_stats",
    "stats_from_histogram",
    "RouteTrace",
    "RouteTracer",
    "TraceSampler",
    "HistWindow",
    "TimeSeriesRing",
    "SLO",
    "BurnWindow",
    "SLOEngine",
    "default_slos",
    "QualityConfig",
    "QualityMonitor",
    "RollingWindows",
    "FlightRecorder",
    "list_dumps",
    "load_dump",
    "render_replay",
    "JitProfiler",
    "SamplingProfiler",
    "stamp_router_costs",
]
