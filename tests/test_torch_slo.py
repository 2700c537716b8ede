"""The port's judgement layer and report: every case of `tests/test_slo.py`
run on `repro_torch.obs` (exemplars, `record_many`, the time-series ring,
the SLO engine's burn math, breach rule and transition latch, rolling
windows, the quality monitor, the HTTP surface and the report's
``--since``, ``--follow`` and ``--watch``), the case of `tests/test_obs.py`
that renders an exported trace ring through the report, and the JAX
package against the port: one `SLOEngine` of each package, fed the same
ring points, publishes the same ``slo_burn`` / ``slo_recovered`` sequence
and the same snapshots; both reports render the same trace JSONL alike.
"""
import dataclasses
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro_torch.obs import (
    SLO,
    BurnWindow,
    EventBus,
    HealthMonitor,
    LogHistogram,
    MetricsRegistry,
    ObsServer,
    QualityConfig,
    QualityMonitor,
    RollingWindows,
    RouteTracer,
    SLOEngine,
    TimeSeriesRing,
    default_slos,
)
from repro_torch.obs.report import follow_events, render_watch_panel, watch
from repro_torch.router.tooldb import ToolRecord, ToolsDatabase

D = 16


def _make_db(n_tools=8, seed=0):
    rng = np.random.default_rng(seed)
    records = [ToolRecord(i, f"t{i}", np.arange(3), 0) for i in range(n_tools)]
    return ToolsDatabase(records, rng.standard_normal((n_tools, D)).astype(np.float32))


def _wait_for(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


# -------------------------------------------------------------- exemplars


def test_exemplar_slots_lazy_and_most_recent_wins():
    h = LogHistogram("x")
    h.record(5.0)  # no exemplar -> no slots allocated, no retention cost
    assert h.exemplars() == {}
    h.record(5.0, exemplar=7)
    h.record(5.0, exemplar=9)  # same bucket: most recent wins
    ex = h.exemplars()
    assert len(ex) == 1
    (_, (eid, val, ts)), = ex.items()
    assert eid == 9 and val == pytest.approx(5.0) and ts > 0
    # a later exemplar-free record does NOT evict the retained exemplar
    h.record(5.0)
    assert next(iter(h.exemplars().values()))[0] == 9


def test_percentile_exemplar_fallback_order():
    h = LogHistogram("x")
    for _ in range(99):
        h.record(1.0)
    h.record(50.0)  # the p99 sample, in a much higher bucket
    # exemplar only on the low bucket: p99 bucket and everything above it
    # are bare, so the search falls back downward to the low bucket
    h.record(1.0, exemplar=11)
    assert h.percentile_exemplar(99.0)[0] == 11
    # now tag the tail: the p99 bucket itself is preferred over lower ones
    h.record(50.0, exemplar=22)
    assert h.percentile_exemplar(99.0)[0] == 22
    assert h.percentile_exemplar(50.0)[0] == 11  # p50 bucket has its own


def test_summary_exemplar_key_is_conditional():
    h = LogHistogram("x")
    h.record(1.0)
    assert "p99_exemplar" not in h.summary()  # the exemplar-free shape preserved
    h.record(2.0, exemplar=3)
    assert h.summary()["p99_exemplar"] == 3
    empty = LogHistogram("y")
    assert h.percentile_exemplar(99.0) is not None
    assert empty.percentile_exemplar(99.0) is None  # no samples -> None


def test_record_many_parity_with_record_loop():
    rng = np.random.default_rng(3)
    vals = np.exp(rng.normal(size=500)).astype(np.float32)
    one, many = LogHistogram("a"), LogHistogram("b")
    for v in vals:
        one.record(float(v))
    many.record_many(vals)
    many.record_many(np.empty(0))  # no-op, not an error
    assert many.count() == one.count() == len(vals)
    assert np.array_equal(many._counts, one._counts)
    s1, s2 = one.summary(), many.summary()
    assert s2["mean"] == pytest.approx(s1["mean"], rel=1e-5)
    assert s2["min"] == pytest.approx(s1["min"], rel=1e-6)
    assert s2["max"] == pytest.approx(s1["max"], rel=1e-6)


# ---------------------------------------------------------- timeseries ring


def test_ring_two_sample_window_semantics():
    reg = MetricsRegistry()
    c = reg.counter("reqs_total")
    ring = TimeSeriesRing(reg)
    assert ring.window(60.0) is None  # empty ring
    c.inc(5)
    ring.tick(now=0.0)
    # ONE tick: no rate, no delta, no histogram window — never a zero
    assert ring.window(60.0, now=0.0) is None
    assert ring.delta("reqs_total", 60.0, now=0.0) is None
    assert ring.rate("reqs_total", 60.0, now=0.0) is None
    c.inc(10)
    ring.tick(now=10.0)
    assert ring.delta("reqs_total", 60.0, now=10.0) == pytest.approx(10.0)
    assert ring.rate("reqs_total", 60.0, now=10.0) == pytest.approx(1.0)
    # a window too short to contain both ticks is insufficient again
    assert ring.delta("reqs_total", 5.0, now=10.0) is None


def test_ring_histogram_window_and_empty_quantiles():
    reg = MetricsRegistry()
    h = reg.histogram("lat_ms")
    ring = TimeSeriesRing(reg)
    h.record(1.0)
    ring.tick(now=0.0)
    ring.tick(now=10.0)  # nothing recorded in between
    wh = ring.window_hist("lat_ms", 60.0, now=10.0)
    assert wh.count == 0
    assert wh.quantile(99.0) is None  # empty window: no quantile
    assert wh.fraction_gt(10.0) is None  # and no latency SLI
    assert wh.mean() == 0.0
    for v in (5.0, 5.0, 15.0, 25.0):
        h.record(v)
    ring.tick(now=20.0)
    wh = ring.window_hist("lat_ms", 60.0, now=20.0)
    assert wh.count == 4 and wh.sum == pytest.approx(50.0)
    # 10.0 sits on a bucket edge: the fraction is exact, 2 of 4 above
    assert wh.fraction_gt(10.0) == pytest.approx(0.5)
    assert wh.quantile(50.0) is not None


def test_ring_bus_synthetic_counters_and_daemon():
    reg = MetricsRegistry()
    bus = EventBus()
    bus.publish("swap", plane="control", version=1)
    bus.publish("swap", plane="control", version=2)
    ring = TimeSeriesRing(reg, bus=bus)
    p = ring.tick(now=0.0)
    assert p.counters['events_total{kind="swap"}'] == 2.0
    assert p.counters["bus_dropped_total"] == 0.0
    ticks = []
    ring.start(interval_s=0.01, on_tick=lambda r: ticks.append(len(r)))
    assert _wait_for(lambda: len(ring) >= 3)
    ring.stop()
    assert ring.last_loop_error is None
    assert ticks  # the judgement hook ran on the cadence


def test_ring_capacity_bounds_memory():
    reg = MetricsRegistry()
    ring = TimeSeriesRing(reg, capacity=4)
    for i in range(10):
        ring.tick(now=float(i))
    assert len(ring) == 4
    assert ring.points()[0].mono == 6.0  # oldest evicted


# ------------------------------------------------------------- burn math


def _latency_slo(**kw):
    defaults = dict(
        name="lat",
        kind="latency",
        hist_key="lat_ms",
        threshold_ms=10.0,
        objective=0.90,
        windows=(BurnWindow(long_s=120.0, short_s=40.0, factor=1.0),),
    )
    defaults.update(kw)
    return SLO(**defaults)


def test_latency_burn_matches_hand_computed_window():
    reg = MetricsRegistry()
    h = reg.histogram("lat_ms")
    ring = TimeSeriesRing(reg)
    engine = SLOEngine(ring, slos=(_latency_slo(),), registry=reg)
    ring.tick(now=0.0)
    for v in [5.0] * 8 + [15.0] * 2:  # 10 samples, 2 above threshold
        h.record(v)
    ring.tick(now=50.0)
    for _ in range(10):
        h.record(5.0)
    ring.tick(now=90.0)
    snap = engine.evaluate(now=100.0)
    w = snap["slos"]["lat"]["windows"][0]
    # long window [(-20)..100] spans ticks 0..90: 20 samples, 2 bad ->
    # bad_frac 0.1, burn = 0.1 / (1 - 0.90) = 1.0 exactly
    assert w["burn_long"] == pytest.approx(1.0)
    # short window [60..100] holds only the t=90 tick: insufficient -> None
    assert w["burn_short"] is None
    assert not w["breaching"]  # None never alerts
    assert snap["status"] == "ok"
    # the latency entry carries live p99 evidence + gauge updates
    assert snap["slos"]["lat"]["p99_ms"] is not None
    assert reg.gauge("slo_burning", slo="lat").value() == 0.0
    assert reg.gauge("slo_burn_rate", slo="lat").value() == pytest.approx(1.0)


def test_ratio_burn_matches_hand_computed_window():
    reg = MetricsRegistry()
    bad = reg.counter("served_total", path="exact")
    good = reg.counter("served_total", path="index")
    slo = SLO(
        name="fallback",
        kind="ratio",
        bad_keys=('served_total{path="exact"}',),
        total_keys=('served_total{path="exact"}', 'served_total{path="index"}'),
        objective=0.95,
        windows=(BurnWindow(long_s=100.0, short_s=100.0, factor=2.0),),
    )
    ring = TimeSeriesRing(reg)
    engine = SLOEngine(ring, slos=(slo,))
    ring.tick(now=0.0)
    bad.inc(5)
    good.inc(95)
    ring.tick(now=50.0)
    snap = engine.evaluate(now=50.0)
    w = snap["slos"]["fallback"]["windows"][0]
    # 5 bad of 100 -> 0.05; burn = 0.05 / (1 - 0.95) = 1.0 < factor 2.0
    assert w["burn_long"] == pytest.approx(1.0)
    assert not snap["slos"]["fallback"]["burning"]


def test_rate_burn_matches_hand_computed_window():
    reg = MetricsRegistry()
    ev = reg.counter("my_events_total")
    slo = SLO(
        name="rollbacks",
        kind="rate",
        event_keys=("my_events_total",),
        max_per_hour=60.0,
        windows=(BurnWindow(long_s=4000.0, short_s=4000.0, factor=1.0),),
    )
    ring = TimeSeriesRing(reg)
    engine = SLOEngine(ring, slos=(slo,))
    ring.tick(now=0.0)
    ev.inc(30)
    ring.tick(now=3600.0)
    snap = engine.evaluate(now=3600.0)
    w = snap["slos"]["rollbacks"]["windows"][0]
    # 30 events over exactly one hour vs 60 allowed -> burn 0.5
    assert w["burn_long"] == pytest.approx(0.5)
    assert not snap["slos"]["rollbacks"]["burning"]


def test_breach_requires_both_windows():
    reg = MetricsRegistry()
    h = reg.histogram("lat_ms")
    ring = TimeSeriesRing(reg)
    engine = SLOEngine(ring, slos=(_latency_slo(),))
    ring.tick(now=0.0)
    for _ in range(10):
        h.record(15.0)  # all bad
    ring.tick(now=50.0)
    # long window burns (burn 10 > 1) but the short window has one tick:
    # evidence without "still happening" is not a breach
    snap = engine.evaluate(now=50.0)
    assert not snap["slos"]["lat"]["burning"]
    ring.tick(now=70.0)
    h.record(15.0)
    ring.tick(now=95.0)  # two ticks inside [55..95]: short window forms
    snap = engine.evaluate(now=95.0)
    assert snap["slos"]["lat"]["burning"]
    assert snap["status"] == "burning" and snap["burning"] == ["lat"]


def test_transition_latch_publishes_each_edge_once():
    reg = MetricsRegistry()
    h = reg.histogram("lat_ms")
    bus = EventBus()
    ring = TimeSeriesRing(reg)
    slo = _latency_slo(windows=(BurnWindow(100.0, 100.0, 1.0),))
    engine = SLOEngine(ring, slos=(slo,), bus=bus, registry=reg)
    monitor = HealthMonitor(slo=engine)

    ring.tick(now=0.0)
    for _ in range(10):
        h.record(15.0)
    ring.tick(now=50.0)
    engine.evaluate(now=50.0)
    assert bus.counts().get("slo_burn") == 1
    d = bus.last("slo_burn").details
    assert d["slo"] == "lat" and d["sli"] == "latency"
    assert d["threshold_ms"] == 10.0 and d["burn"] == pytest.approx(10.0)
    # burning SLO degrades health (without re-judging: burning() is a read)
    snap = monitor.snapshot()
    assert snap["status"] == "degraded" and snap["slo"]["burning"] == ["lat"]
    assert reg.gauge("slo_burning", slo="lat").value() == 1.0

    # still breaching: the latch holds, no second event
    ring.tick(now=60.0)
    engine.evaluate(now=60.0)
    assert bus.counts().get("slo_burn") == 1
    assert engine.burning() == ["lat"]

    # the bad samples age out of the window: recovery fires exactly once
    ring.tick(now=500.0)
    ring.tick(now=560.0)
    engine.evaluate(now=560.0)
    assert bus.counts().get("slo_recovered") == 1
    assert bus.last("slo_recovered").details["slo"] == "lat"
    assert engine.burning() == []
    assert monitor.snapshot()["status"] == "ok"
    engine.evaluate(now=570.0)
    assert bus.counts().get("slo_recovered") == 1  # no flapping


def test_default_slos_cover_the_catalog_and_stay_quiet_without_data():
    names = [s.name for s in default_slos()]
    assert names == [
        "route_p99_budget",
        "exact_fallback_ratio",
        "guard_rollback_rate",
        "drop_rate",
        "jit_retrace_rate",
        "cache_staleness",
    ]
    reg = MetricsRegistry()
    engine = SLOEngine(TimeSeriesRing(reg), registry=reg)
    snap = engine.evaluate(now=0.0)  # empty ring: all burns None
    assert snap["status"] == "ok" and snap["burning"] == []
    for entry in snap["slos"].values():
        assert entry["burn"] is None and not entry["burning"]


def test_slo_declarations_validate_kind_fields():
    with pytest.raises(AssertionError):
        SLO(name="x", kind="latency")  # no hist_key/threshold
    with pytest.raises(AssertionError):
        SLO(name="x", kind="ratio", bad_keys=("a",))  # no total
    with pytest.raises(AssertionError):
        SLO(name="x", kind="rate", event_keys=("a",))  # no max_per_hour
    with pytest.raises(AssertionError):
        SLOEngine(
            TimeSeriesRing(MetricsRegistry()),
            slos=(_latency_slo(), _latency_slo()),  # duplicate names
        )


# --------------------------------------------------------- rolling windows


def test_rolling_windows_bounds_and_pruning():
    rw = RollingWindows(maxlen=3)
    assert rw.mean("v") is None and rw.n("v") == 0
    for x in (1.0, 2.0, 3.0, 4.0):
        rw.push("v", x)
    assert rw.n("v") == 3  # bounded: 1.0 evicted
    assert rw.values("v") == [2.0, 3.0, 4.0]
    assert rw.mean("v") == pytest.approx(3.0)
    rw.push("w", 9.0)
    assert sorted(map(str, rw.keys())) == ["v", "w"]
    rw.prune(keep=["w"])
    assert rw.keys() == ["w"] and rw.n("v") == 0


# ------------------------------------------------------------ quality plane


def test_quality_monitor_labelled_rolling_and_gauges():
    reg = MetricsRegistry()
    qm = QualityMonitor(QualityConfig(k=3, window=4), registry=reg)
    qm.observe([1, 2, 3], relevant=[1])  # hit at rank 1
    qm.observe([4, 5, 6], relevant=[1])  # miss
    s = qm.summary()
    assert s["n_labelled"] == 2 and s["k"] == 3
    assert s["recall"] == pytest.approx(0.5)
    assert 0.0 < s["ndcg"] < 1.0
    assert reg.gauge("quality_recall", k="3").value() == pytest.approx(0.5)
    assert reg.gauge("quality_ndcg", k="3").value() == pytest.approx(s["ndcg"])


def test_drift_rising_edge_rearm_and_min_batches():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((32, D)).astype(np.float32)
    bus = EventBus()
    cfg = QualityConfig(drift_ewma=0.5, drift_threshold=0.5, drift_min_batches=3)
    qm = QualityMonitor(cfg, bus=bus)
    assert qm.observe_queries(table[:4]) is None  # no reference yet
    qm.set_reference(table, version=7)
    matched = lambda: table[rng.integers(0, 32, size=8)]
    shifted = lambda: matched() + 5.0
    # batches 2..3 are shifted but under min_batches: no judgement yet
    qm.observe_queries(shifted())
    assert not qm.drifting and bus.last("quality_drift") is None
    qm.observe_queries(shifted())  # batch 3 >= min_batches: rising edge
    ev = bus.last("quality_drift")
    assert ev is not None and qm.drifting
    assert ev.details["table_version"] == 7
    assert ev.details["score"] > ev.details["threshold"]
    qm.observe_queries(shifted())  # still drifted: latched, no second event
    assert bus.counts()["quality_drift"] == 1
    for _ in range(12):  # EWMA decays back onto the reference: re-arms
        qm.observe_queries(matched())
    assert not qm.drifting
    qm.observe_queries(shifted())
    qm.observe_queries(shifted())
    assert bus.counts()["quality_drift"] == 2  # second rising edge fires


def test_watch_db_follows_swaps_and_detaches():
    db = _make_db()
    bus = EventBus()
    qm = QualityMonitor(bus=bus)
    detach_q = qm.watch_db(db)
    detach_b = bus.watch_db(db)
    assert qm.summary()["ref_table_version"] == db.table_version
    v1 = db.swap_table(
        db.embeddings + 1.0, expect_current=db.table_version
    )
    assert qm.summary()["ref_table_version"] == v1  # re-froze on swap
    assert bus.last("swap").details["version"] == v1
    detach_q()
    detach_b()
    detach_q()  # idempotent (remove_swap_listener contract)
    db.swap_table(db.embeddings + 2.0, expect_current=v1)
    assert qm.summary()["ref_table_version"] == v1  # no longer following
    assert bus.last("swap").details["version"] == v1  # no new event


# ------------------------------------------------------------- HTTP surface


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, json.loads(resp.read())


def test_slo_and_traces_endpoints():
    reg = MetricsRegistry()
    h = reg.histogram("lat_ms")
    bus = EventBus()
    ring = TimeSeriesRing(reg)
    engine = SLOEngine(ring, slos=(_latency_slo(),), bus=bus, registry=reg)
    tracer = RouteTracer(sample_every=1, seed=0)
    tid = tracer.record(
        batch_size=4, bucket=4, path="index", table_version=0,
        stage_version=0, spans=[("embed", 1.0)], total_ms=15.0,
    ).trace_id
    h.record(15.0, exemplar=tid)
    ring.tick(now=0.0)
    ring.tick(now=10.0)
    server = ObsServer(registry=reg, bus=bus, slo=engine, tracer=tracer).start()
    try:
        base = f"http://{server.host}:{server.port}"
        code, snap = _get(f"{base}/slo")  # a scrape judges live
        assert code == 200 and "lat" in snap["slos"]
        assert snap["slos"]["lat"]["p99_exemplar"] == tid
        code, trace = _get(f"{base}/traces?id={tid}")
        assert code == 200 and trace["trace_id"] == tid
        assert trace["spans"] == {"embed": 1.0}
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            _get(f"{base}/traces?id=99999")
        assert exc_info.value.code == 404
        code, recs = _get(f"{base}/traces?since=-1")
        assert code == 200 and [r["trace_id"] for r in recs] == [tid]
    finally:
        server.stop()


# ----------------------------------------------------------------- repro-obs


def test_follow_events_tails_with_since_cursor():
    bus = EventBus()
    bus.publish("swap", plane="control", version=1)
    bus.publish("rollback", plane="control", condemned_version=1,
                restored_version=2, ndcg=0.5, baseline=0.9)
    server = ObsServer(bus=bus, registry=MetricsRegistry()).start()
    try:
        base = f"http://{server.host}:{server.port}"
        out = io.StringIO()
        assert follow_events(base, interval=0.0, max_polls=1, out=out) == 2
        text = out.getvalue()
        assert "swap" in text and "rollback" in text
        # second poll from a fresh cursorless call reprints; but a single
        # call's cursor advances — publish one more and poll again
        out2 = io.StringIO()
        bus.publish("cooldown", plane="control", purged=3)
        assert follow_events(base, interval=0.0, max_polls=1, out=out2) == 3
    finally:
        server.stop()


def test_watch_panel_renders_burning_slo_with_exemplar_link():
    health = {"status": "degraded"}
    slo_snap = {
        "status": "burning",
        "burning": ["route_p99_budget"],
        "slos": {
            "route_p99_budget": {
                "kind": "latency", "burning": True, "burn": 14.9,
                "threshold_ms": 10.0, "p99_ms": 23.4, "p99_exemplar": 42,
                "description": "", "windows": [],
            },
        },
    }
    trace = {"spans": {"embed": 9.0, "score": 13.1}, "batch_size": 16,
             "path": "exact", "table_version": 3}
    panel = render_watch_panel(health, slo_snap, lambda tid: trace)
    assert "health: degraded" in panel
    assert "BURNING" in panel and "p99=23.40ms vs 10ms" in panel
    assert "trace #42" in panel and "table=v3" in panel
    # unresolvable exemplar degrades to "(not retained)"
    panel2 = render_watch_panel(health, slo_snap, lambda tid: None)
    assert "(not retained)" in panel2
    # no engine wired at all
    assert "engine not wired" in render_watch_panel({"status": "ok"}, None)


def test_watch_fetches_live_panel_frames():
    reg = MetricsRegistry()
    ring = TimeSeriesRing(reg)
    engine = SLOEngine(ring, slos=(_latency_slo(),), registry=reg)
    monitor = HealthMonitor(slo=engine)
    server = ObsServer(monitor=monitor, registry=reg, slo=engine).start()
    try:
        out = io.StringIO()
        frames = watch(f"http://{server.host}:{server.port}",
                       interval=0.0, iterations=2, out=out)
        assert frames == 2
        text = out.getvalue()
        assert text.count("health: ok") == 2 and "lat" in text
    finally:
        server.stop()


def test_report_since_filters_trace_jsonl(tmp_path, capsys):
    from repro_torch.obs.report import main as report_main

    recs = [
        {"trace_id": i, "ts": 100.0 * (i + 1), "batch_size": 4, "bucket": 4,
         "path": "index", "table_version": 0, "stage_version": 0,
         "spans": {"embed": 1.0}, "total_ms": 2.0}
        for i in range(3)
    ]
    p = tmp_path / "t.jsonl"
    p.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    assert report_main([str(p)]) == 0
    assert "3 traces" in capsys.readouterr().out
    assert report_main([str(p), "--since", "150"]) == 0
    assert "2 traces" in capsys.readouterr().out
    assert report_main([str(p), "--since", "1e9"]) == 0
    assert "no traces" in capsys.readouterr().out


# ------------------------------------------------------- trace ring report


def test_tracer_ring_export_and_report(tmp_path):
    from repro_torch.obs.report import render_trace_report
    from repro_torch.router.gateway import SemanticRouter

    tracer = RouteTracer(sample_every=1, capacity=8, seed=0)
    records = [ToolRecord(i, f"t{i}", np.arange(3), 0) for i in range(12)]
    table = np.random.default_rng(0).standard_normal((12, D)).astype(np.float32)
    embed = lambda toks: np.bincount(np.asarray(toks, np.int64) % D, minlength=D).astype(np.float32)
    router = SemanticRouter(ToolsDatabase(records, table), embed, k=3, metrics=False,
                            tracer=tracer, device="cpu")
    try:
        for i in range(12):
            router.route_batch([np.arange(i, i + 3), np.arange(i + 1, i + 4)])
    finally:
        router.close()
    assert len(tracer) == 8
    assert tracer.dropped == 4
    traces = tracer.traces()
    t = traces[-1]
    assert t.batch_size == 2 and t.bucket == 2  # pow2 bucket of Q=2
    assert t.path == "index:dense"
    phases = [name for name, _ in t.spans]
    assert phases == ["embed", "adapter", "score", "assemble"]  # no MLP
    assert t.total_ms >= sum(ms for _, ms in t.spans) * 0.5
    assert "embed" in tracer.phase_summaries()

    out = tmp_path / "trace.jsonl"
    assert tracer.export_jsonl(str(out)) == 8
    records = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(records) == 8 and records[0]["spans"].keys() == set(phases)
    report = render_trace_report(records)
    assert "8 traces" in report
    assert "index:dense=8" in report
    assert "embed" in report and "total" in report
    assert render_trace_report([]) == "no traces\n"
    # the JAX package's report renders the same records alike
    from repro.obs.report import render_trace_report as jax_render_trace_report

    assert jax_render_trace_report(records) == report


# ------------------------------------------------ the JAX package's engine


def _both_engines():
    """(port, JAX) — each a (registry, ring, engine, bus) over the same SLOs:
    one of each SLI kind, on windows short enough for a test's clock."""
    import repro.obs as jobs

    out = []
    for pkg in (__import__("repro_torch.obs", fromlist=["SLO"]), jobs):
        reg = pkg.MetricsRegistry()
        bus = pkg.EventBus()
        ring = pkg.TimeSeriesRing(reg, bus=bus)
        win = (pkg.BurnWindow(long_s=100.0, short_s=30.0, factor=1.0),)
        slos = (
            pkg.SLO(name="lat", kind="latency", hist_key="lat_ms", threshold_ms=10.0,
                    objective=0.9, windows=win),
            pkg.SLO(name="fallback", kind="ratio",
                    bad_keys=('served_total{path="exact"}',),
                    total_keys=('served_total{path="exact"}', 'served_total{path="index"}'),
                    objective=0.95, windows=win),
            pkg.SLO(name="rollbacks", kind="rate",
                    event_keys=('events_total{kind="rollback"}',),
                    max_per_hour=60.0, windows=win),
        )
        out.append((reg, ring, pkg.SLOEngine(ring, slos=slos, bus=bus, registry=reg), bus))
    return out


def test_slo_engine_publishes_the_jax_sequence():
    port, jax_side = _both_engines()
    rng = np.random.default_rng(0)
    snaps = {0: [], 1: []}
    for step in range(40):
        now = 5.0 * step
        # traffic: latency, exact-fallback and rollbacks burst in some
        # stretches and stop in others, so every SLO enters breach and
        # leaves it
        lat = rng.uniform(1.0, 30.0 if 8 <= step < 16 else 8.0, size=6)
        bad = int(rng.integers(2, 6)) if 20 <= step < 26 else 0
        rollbacks = int(rng.integers(1, 3)) if 28 <= step < 32 else 0
        for side, (reg, ring, engine, bus) in enumerate((port, jax_side)):
            h = reg.histogram("lat_ms")
            for v in lat:
                h.record(float(v))
            reg.counter("served_total", path="exact").inc(bad)
            reg.counter("served_total", path="index").inc(10)
            for _ in range(rollbacks):
                bus.publish("rollback", plane="control", condemned_version=step)
            ring.tick(now=now)
            snap = engine.evaluate(now=now)
            snap.pop("evaluated_at")  # the wall clock
            snaps[side].append(snap)
    assert snaps[0] == snaps[1]
    seqs = [[(e.kind, e.plane, e.details) for e in bus.events()
             if e.kind in ("slo_burn", "slo_recovered")]
            for _, _, _, bus in (port, jax_side)]
    assert seqs[0] == seqs[1]
    kinds = {(kind, d["slo"]) for kind, _, d in seqs[0]}
    assert kinds == {(k, s) for k in ("slo_burn", "slo_recovered")
                     for s in ("lat", "fallback", "rollbacks")}
    assert port[2].burning() == jax_side[2].burning() == []


def test_default_slos_match_jax_but_for_the_hot_path_keys():
    from repro.obs import default_slos as jax_default_slos
    from repro_torch.router.gateway import hot_path_jits

    ours, theirs = default_slos(), jax_default_slos()
    assert [s.name for s in ours] == [s.name for s in theirs]
    for a, b in zip(ours, theirs):
        if a.name == "jit_retrace_rate":
            assert a.event_keys == tuple(
                f'jit_compiles_total{{fn="{name}"}}' for name in hot_path_jits())
            assert (a.kind, a.max_per_hour) == (b.kind, b.max_per_hour)
            assert [dataclasses.astuple(w) for w in a.windows] == [
                dataclasses.astuple(w) for w in b.windows]
        else:
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
