"""The port's telemetry plane against the JAX package's, and the events,
trace, health and latency cases of `tests/test_obs.py` as port cases.

Parity: two routers (JAX dense; port dense and fused on the CPU) with
seeded tracers sample the same batches into traces with the same ids,
sizes, buckets, paths, versions and phases, and the port's JSONL export
renders through the JAX package's `repro-obs` report; the quality monitor
computes the same rolling NDCG/Recall and drift score (within 1e-6) and
publishes the same events; the time-series ring answers the same windowed
queries over the same registry history.
"""
import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.obs import EventBus as JaxEventBus
from repro.obs import MetricsRegistry as JaxMetricsRegistry
from repro.obs import QualityConfig as JaxQualityConfig
from repro.obs import QualityMonitor as JaxQualityMonitor
from repro.obs import RouteTracer as JaxRouteTracer
from repro.obs import TimeSeriesRing as JaxTimeSeriesRing
from repro.obs.report import render_trace_report
from repro.router.gateway import SemanticRouter as JaxRouter
from repro.router.tooldb import ToolRecord as JaxToolRecord
from repro.router.tooldb import ToolsDatabase as JaxToolsDatabase
from repro_torch.control import ControllerConfig, OutcomeStore, RefinementController
from repro_torch.obs import (
    EventBus,
    HealthMonitor,
    MetricsRegistry,
    ObsServer,
    QualityConfig,
    QualityMonitor,
    RouteTracer,
    TimeSeriesRing,
    TraceSampler,
)
from repro_torch.router.gateway import SemanticRouter
from repro_torch.router.tooldb import ToolRecord, ToolsDatabase

D = 16  # embedding dim for the hand-rolled fixture router
CPU = "cpu"


def _embed(tokens):
    return np.bincount(np.asarray(tokens, np.int64) % D, minlength=D).astype(np.float32)


def _embed_batch(token_lists):
    return np.stack([_embed(t) for t in token_lists])


def _table(n_tools):
    return np.random.default_rng(0).standard_normal((n_tools, D)).astype(np.float32)


def _make_router(n_tools=12, backend="dense", **kw):
    records = [ToolRecord(i, f"t{i}", np.arange(3), 0) for i in range(n_tools)]
    db = ToolsDatabase(records, _table(n_tools))
    return SemanticRouter(db, _embed, k=3, backend=backend, device=CPU, **kw), db


def _wait_for(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


# ------------------------------------------------------------------ parity
@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_sampled_traces_match_jax(backend, tmp_path):
    n_tools = 12
    jdb = JaxToolsDatabase([JaxToolRecord(i, f"t{i}", np.arange(3), 0) for i in range(n_tools)],
                           _table(n_tools))
    jtracer = JaxRouteTracer(sample_every=3, capacity=16, seed=7)
    jax_router = JaxRouter(jdb, _embed, k=3, metrics=False, tracer=jtracer)
    tracer = RouteTracer(sample_every=3, capacity=16, seed=7)
    router, db = _make_router(n_tools, backend, metrics=False, tracer=tracer)
    for i in range(40):
        batch = [np.arange(i, i + 3 + j) for j in range(1 + i % 5)]
        if i == 20:
            for d in (jdb, db):
                d.swap_table(np.roll(_table(n_tools), 1, axis=0))
        jax_router.route_batch(batch)
        router.route_batch(batch)
    ours, theirs = tracer.traces(), jtracer.traces()
    assert len(ours) == len(theirs) > 5 and tracer.dropped == jtracer.dropped
    for a, b in zip(ours, theirs):
        assert (a.trace_id, a.batch_size, a.bucket, a.table_version, a.stage_version) == (
            b.trace_id, b.batch_size, b.bucket, b.table_version, b.stage_version)
        assert a.path == f"index:{backend}" and b.path == "index:dense"
        assert [n for n, _ in a.spans] == [n for n, _ in b.spans]
    out = tmp_path / "port.jsonl"
    assert tracer.export_jsonl(str(out)) == len(ours)
    records = [json.loads(line) for line in out.read_text().splitlines()]
    assert set(records[0]) == set(theirs[0].as_dict())
    report = render_trace_report(records)
    assert f"{len(ours)} traces" in report and f"index:{backend}={len(ours)}" in report


def test_quality_monitor_matches_jax():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((30, D)).astype(np.float32)
    results = {}
    for name, Bus, Reg, Cfg, Mon in (
            ("jax", JaxEventBus, JaxMetricsRegistry, JaxQualityConfig, JaxQualityMonitor),
            ("port", EventBus, MetricsRegistry, QualityConfig, QualityMonitor)):
        bus, reg = Bus(), Reg()
        mon = Mon(Cfg(window=32, drift_min_batches=3, drift_every=2), registry=reg, bus=bus)
        r = np.random.default_rng(5)
        scores = []
        for step in range(40):
            mon.observe([int(x) for x in r.permutation(30)[:5]],
                        [int(x) for x in r.choice(30, size=2, replace=False)])
            if step == 10:
                mon.set_reference(table, version=1)
            shift = 2.0 if 20 <= step < 30 else 0.0
            scores.append(mon.observe_queries(r.standard_normal((8, D)).astype(np.float32)
                                              + shift))
        s = mon.summary()
        results[name] = (scores, s, [(e.kind, e.details.get("table_version")) for e in
                                     bus.events()], reg.gauge("quality_ndcg", k="5").value())
    (js, jsum, jev, jg), (ts, tsum, tev, tg) = results["jax"], results["port"]
    assert [x is None for x in js] == [x is None for x in ts]
    np.testing.assert_allclose([x for x in ts if x is not None],
                               [x for x in js if x is not None], atol=1e-6)
    for key in ("n_labelled", "k", "drifting", "drift_events", "n_batches", "ref_table_version"):
        assert tsum[key] == jsum[key], key
    for key in ("ndcg", "recall", "drift_score"):
        assert abs(tsum[key] - jsum[key]) <= 1e-6, key
    assert tev == jev and ("quality_drift", 1) in tev
    assert abs(tg - jg) <= 1e-6


def test_timeseries_windows_match_jax():
    answers = []
    for Reg, Bus, Ring in ((JaxMetricsRegistry, JaxEventBus, JaxTimeSeriesRing),
                           (MetricsRegistry, EventBus, TimeSeriesRing)):
        reg, bus = Reg(), Bus()
        ring = Ring(reg, bus=bus, capacity=6)
        c, h = reg.counter("route_requests_total"), reg.histogram("route_batch_ms")
        r = np.random.default_rng(6)
        for t in range(10):
            c.inc(int(r.integers(1, 50)))
            for v in r.lognormal(0.0, 1.0, size=20):
                h.record(float(v))
            if t % 4 == 0:
                bus.publish("rollback", plane="control")
            ring.tick(now=float(t))
        win = ring.window_hist("route_batch_ms", 3.5)
        answers.append((len(ring), ring.delta("route_requests_total", 3.5),
                        ring.rate("route_requests_total", 5.0),
                        ring.delta('events_total{kind="rollback"}', 9.0),
                        win.count, round(win.sum, 9), win.quantile(99), win.fraction_gt(10.0),
                        ring.window_hist("route_batch_ms", 0.5)))
    assert answers[0] == answers[1]


# ---------------------------------------------- counters under concurrency
def test_counters_exact_under_concurrent_route_batch():
    reg = MetricsRegistry()
    router, db = _make_router(metrics=reg)
    n_threads, n_calls, batch = 8, 25, 4
    queries = [np.arange(j, j + 4) for j in range(batch)]
    errors = []

    def worker():
        try:
            for _ in range(n_calls):
                router.route_batch(queries)
        except Exception as exc:  # pragma: no cover - failure path
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    total = n_threads * n_calls
    assert reg.counter("route_batches_total").value() == total
    assert reg.counter("route_requests_total").value() == total * batch
    assert reg.histogram("route_batch_ms").count() == total
    for phase in ("embed", "adapter", "score", "assemble"):
        assert reg.histogram("route_phase_ms", phase=phase).count() == total
    assert reg.histogram("route_phase_ms", phase="rerank").count() == 0
    assert reg.gauge("route_table_version").value() == db.table_version


# ------------------------------------------------------------------ EventBus
def test_event_bus_ring_bounds_and_seq_semantics():
    bus = EventBus(capacity=4)
    for i in range(10):
        bus.publish("tick", plane="serve", i=i)
    assert len(bus) == 4
    assert bus.dropped == 6
    assert bus.counts() == {"tick": 10}
    assert [e.seq for e in bus.events()] == [6, 7, 8, 9]
    assert [e.seq for e in bus.events(since_seq=7)] == [8, 9]
    assert bus.events(kind="other") == []
    last = bus.last("tick")
    assert last is not None and last.seq == 9 and last.details["i"] == 9
    assert bus.last("other") is None
    d = last.as_dict()
    assert d["kind"] == "tick" and d["plane"] == "serve" and d["i"] == 9


def test_event_bus_subscriber_may_publish_without_deadlock():
    bus = EventBus()
    bus.subscribe(lambda e: bus.publish("echo", plane=e.plane) if e.kind == "ping" else None)
    bus.publish("ping", plane="control")
    assert bus.counts() == {"ping": 1, "echo": 1}


def test_event_bus_watch_db_publishes_every_version_change():
    bus = EventBus()
    router, db = _make_router(metrics=False, bus=bus)
    detach = bus.watch_db(db)
    db.swap_table(np.roll(db.embeddings, 1, axis=0))
    db.rollback()
    detach()
    db.swap_table(db.embeddings.copy())
    assert [e.details["version"] for e in bus.events(kind="swap")] == [1, 2]
    # the router's owned index publishes its rebuilds on the same bus
    assert bus.counts()["rebuild_finish"] == 1 + 3


# -------------------------------------------------------------------- tracer
def test_trace_sampler_seeded_determinism():
    a = TraceSampler(sample_every=8, seed=42)
    b = TraceSampler(sample_every=8, seed=42)
    seq_a = [a.sample() for _ in range(400)]
    assert seq_a == [b.sample() for _ in range(400)]
    c = TraceSampler(sample_every=8, seed=43)
    assert [c.sample() for _ in range(400)] != seq_a
    assert 20 <= sum(seq_a) <= 90
    always = TraceSampler(sample_every=1, seed=0)
    assert all(always.sample() for _ in range(32))


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_tracer_ring_and_export(backend, tmp_path):
    tracer = RouteTracer(sample_every=1, capacity=8, seed=0)
    router, _ = _make_router(metrics=False, tracer=tracer, backend=backend)
    for i in range(12):
        router.route_batch([np.arange(i, i + 3), np.arange(i + 1, i + 4)])
    assert len(tracer) == 8
    assert tracer.dropped == 4
    t = tracer.traces()[-1]
    assert t.batch_size == 2 and t.bucket == 2  # pow2 bucket of Q=2
    assert t.path == f"index:{backend}"
    phases = [name for name, _ in t.spans]
    assert phases == ["embed", "adapter", "score", "assemble"]  # no MLP
    assert t.total_ms >= sum(ms for _, ms in t.spans) * 0.5
    assert tracer.get(t.trace_id) is t and tracer.get(0) is None
    assert "embed" in tracer.phase_summaries()
    out = tmp_path / "trace.jsonl"
    assert tracer.export_jsonl(str(out)) == 8
    records = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(records) == 8 and records[0]["spans"].keys() == set(phases)


# ------------------------------------------------------------ health surface
def test_loop_error_sets_health_and_clears_on_recovery():
    bus = EventBus()
    router, db = _make_router(metrics=False)
    store = OutcomeStore(n_tools=len(db), capacity=256)
    controller = RefinementController(
        db, store, _embed_batch, routers=[router],
        config=ControllerConfig(min_events=10**9, max_interval_s=10**9), bus=bus)
    monitor = HealthMonitor(routers=[router], controllers=[controller], bus=bus)

    def boom():
        raise RuntimeError("injected step failure")

    controller.step = boom  # shadow the bound method; deleted to recover
    controller.start(interval_s=0.01)
    try:
        assert _wait_for(lambda: bus.last("loop_error") is not None)
        snap = monitor.snapshot()
        assert snap["status"] == "error" and snap["ok"] is False
        assert "injected step failure" in snap["control"][0]["last_loop_error"]
        del controller.step
        assert _wait_for(lambda: bus.last("loop_recovered") is not None)
        assert _wait_for(lambda: controller.last_loop_error is None)
        snap = monitor.snapshot()
        assert snap["status"] == "ok" and snap["ok"] is True
        assert snap["control"][0]["last_loop_error"] is None
    finally:
        controller.stop()
    assert bus.counts()["loop_error"] == 1
    assert bus.counts()["loop_recovered"] == 1


def test_outcomes_dropped_surfaces_through_counter_bus_and_health():
    reg = MetricsRegistry()
    bus = EventBus()
    router, _ = _make_router(metrics=reg, bus=bus, outcome_capacity=2)
    for i in range(5):
        router.record_outcome(np.arange(3), tool_id=i % 3, outcome=1)
    assert router.outcomes_dropped == 3
    assert reg.counter("route_outcomes_dropped_total").value() == 3
    drops = bus.events(kind="outcomes_dropping")
    assert len(drops) == 1 and drops[0].details["dropped"] == 1
    snap = HealthMonitor(routers=[router], bus=bus).snapshot()
    assert snap["status"] == "degraded" and snap["ok"] is True
    assert snap["serving"][0]["outcomes_dropped"] == 3
    assert snap["events"]["counts"]["outcomes_dropping"] == 1


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_health_snapshot_ok_with_healthy_planes(backend):
    bus = EventBus()
    router, db = _make_router(metrics=False, bus=bus, backend=backend)
    bus.watch_db(db)
    store = OutcomeStore(n_tools=len(db), capacity=256)
    monitor = HealthMonitor(routers=[router], indexes=[router.index], stores=[store], bus=bus)
    router.route_batch([np.arange(3)])
    snap = monitor.snapshot()
    assert snap["status"] == "ok"
    assert snap["serving"][0]["table_version"] == db.table_version
    assert snap["index"][0] == {"fresh": True, "backend": backend,
                                "stats": dict(router.index.stats)}
    assert snap["stores"][0] == {"n_events": 0, "dropped": 0, "total_ingested": 0}


# ----------------------------------------------------------------- ObsServer
def _get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, resp.read().decode()


def test_obs_server_endpoints():
    reg = MetricsRegistry()
    bus = EventBus()
    tracer = RouteTracer(sample_every=1, seed=0)
    router, _ = _make_router(metrics=reg, bus=bus, tracer=tracer)
    router.route_batch([np.arange(3), np.arange(4)])
    bus.publish("tick", plane="serve")
    monitor = HealthMonitor(routers=[router], bus=bus)
    server = ObsServer(monitor, reg, bus, tracer=tracer).start()
    base = f"http://{server.host}:{server.port}"
    try:
        code, text = _get(base + "/metrics")
        assert code == 200
        assert "# TYPE route_batches_total counter" in text
        assert "route_phase_ms_bucket" in text
        code, text = _get(base + "/health")
        assert code == 200 and json.loads(text)["status"] == "ok"
        code, text = _get(base + "/events?since=-1")
        assert code == 200 and "tick" in [e["kind"] for e in json.loads(text)]
        code, text = _get(base + "/traces?id=0")
        assert code == 200 and json.loads(text)["batch_size"] == 2
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(base + "/nope")
        assert err.value.code == 404
    finally:
        server.stop()
    server.stop()  # idempotent


def test_obs_server_health_returns_503_on_loop_error():
    failing = types.SimpleNamespace(last_loop_error=RuntimeError("dead loop"), reports=[])
    server = ObsServer(HealthMonitor(controllers=[failing])).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(f"http://{server.host}:{server.port}/health")
        assert err.value.code == 503
        snap = json.loads(err.value.fp.read())
        assert snap["status"] == "error"
        assert "dead loop" in snap["control"][0]["last_loop_error"]
    finally:
        server.stop()


# ------------------------------------------------------- latency re-exports
def test_router_latency_reexports_obs_summary():
    from repro_torch.obs import summary
    from repro_torch.router import latency

    assert latency.percentile_stats is summary.percentile_stats
    assert latency.LatencyStats is summary.LatencyStats
    stats = latency.percentile_stats([1.0, 2.0, 3.0])
    assert stats.p50_ms == 2.0 and stats.n == 3
    assert set(stats.as_dict()) == {"p50_ms", "p99_ms", "mean_ms", "n"}
    measured = latency.measure_latency(lambda i: i, n_requests=5, warmup=1)
    assert isinstance(measured, latency.LatencyStats) and measured.n == 5


def test_latency_summaries_match_jax():
    from repro.obs import summary as jax_summary
    from repro_torch.obs import summary

    rng = np.random.default_rng(8)
    samples = rng.lognormal(0.0, 1.0, size=257).tolist()
    assert summary.percentile_stats(samples).as_dict() == (
        jax_summary.percentile_stats(samples).as_dict())
    reg, jreg = MetricsRegistry(), JaxMetricsRegistry()
    for v in samples:
        reg.histogram("h").record(v)
        jreg.histogram("h").record(v)
    assert summary.stats_from_histogram(reg.histogram("h")).as_dict() == (
        jax_summary.stats_from_histogram(jreg.histogram("h")).as_dict())
