"""The port's flight recorder and profilers: every case of
`tests/test_flightrec.py` run on `repro_torch.obs`, with the profiler's
cases rewritten for the port's probe, and dumps across the packages.

* black-box dumps — an injected ``slo_burn`` and an injected controller
  crash each produce exactly ONE dump with the trigger, linked traces and
  the serving router's (table_version, stage_version) stamps; staging dirs
  are swept, retention keeps the newest ``max_dumps``; the report replays
  a dump offline;
* JitProfiler — the first collect baselines, later growth of a probe's
  `_cache_size()` counts as ``jit_compiles_total{fn=}``; the port's
  `topk_sim` probe counts the library load and each route's first launch;
  cost stamping records `kernel.cost()` (the hand count) and the route
  without loading or launching anything; `stamp_router_costs` stamps the
  fused backend at its padded shapes and nothing else; the chain from
  `hot_path_jits()` names to counter labels to ring keys to
  ``jit_retrace_rate`` firing;
* SamplingProfiler, the shutdown order, and concurrent scrapes during
  swaps and stage promotions;
* across the packages: one dump renders through `repro.obs.flightrec.
  render_replay` exactly as through the port's, whichever package wrote it.
"""
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

import torch

from repro_torch.control import ControllerConfig, OutcomeStore, RefinementController
from repro_torch.kernels.topk_sim import kernel as topk_kernel
from repro_torch.obs import (
    EventBus,
    FlightRecorder,
    HealthMonitor,
    JitProfiler,
    MetricsRegistry,
    ObsServer,
    RouteTracer,
    SamplingProfiler,
    SLOEngine,
    TimeSeriesRing,
    default_slos,
    list_dumps,
    load_dump,
    render_replay,
)
from repro_torch.obs.flightrec import DUMP_FORMAT_VERSION
from repro_torch.obs.profile import stamp_router_costs
from repro_torch.obs.report import main as report_main
from repro_torch.obs.slo import SLO, BurnWindow
from repro_torch.router.gateway import SemanticRouter, hot_path_jits
from repro_torch.router.stages import StageSet
from repro_torch.router.tooldb import ToolRecord, ToolsDatabase

D = 16
CPU = "cpu"


def _embed(tokens):
    return np.bincount(
        np.asarray(tokens, np.int64) % D, minlength=D
    ).astype(np.float32)


def _embed_batch(token_lists):
    return np.stack([_embed(t) for t in token_lists])


def _make_router(n_tools=12, **kw):
    rng = np.random.default_rng(0)
    records = [ToolRecord(i, f"t{i}", np.arange(3), 0) for i in range(n_tools)]
    table = rng.standard_normal((n_tools, D)).astype(np.float32)
    db = ToolsDatabase(records, table)
    return SemanticRouter(db, _embed, k=3, device=CPU, **kw), db


def _route_some(router, n=4, seed=1):
    rng = np.random.default_rng(seed)
    router.route_batch(
        [rng.integers(0, 40, size=4).astype(np.int64) for _ in range(n)]
    )


def _wait_for(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


class _FakeJit:
    """A `_cache_size`-bearing stand-in for a hot-path probe."""

    def __init__(self, size=0):
        self.size = size

    def _cache_size(self):
        return self.size


# ------------------------------------------------------------ trigger dumps


def test_slo_burn_triggers_exactly_one_debounced_dump(tmp_path):
    bus = EventBus()
    reg = MetricsRegistry()
    tracer = RouteTracer(sample_every=1)
    router, db = _make_router(metrics=reg, tracer=tracer, bus=bus)
    try:
        _route_some(router)
        rec = FlightRecorder(
            str(tmp_path / "dumps"), bus=bus, registry=reg, tracer=tracer,
            routers=[router], debounce_s=60.0,
        )
        # an incident storm: burn + the rollback it provokes, close together
        bus.publish("slo_burn", plane="serve", slo="route_p99_budget",
                    sli="latency", burn=25.0)
        bus.publish("rollback", plane="control", condemned_version=1)
        dumps = rec.list()
        assert len(dumps) == 1, "debounce must collapse the storm to one dump"
        assert rec.dumps_written == 1 and rec.dumps_suppressed == 1
        m = dumps[0].manifest
        assert m["format_version"] == DUMP_FORMAT_VERSION
        assert m["reason"] == "slo_burn"
        assert m["trigger"]["slo"] == "route_p99_budget"
        # version stamps must match the live serving composition
        sv, _stages = router.stage_set()
        assert m["serving"] == [{
            "table_version": db.table_version,
            "stage_version": sv,
            "active_stages": [],
        }]
        assert m["n_traces"] >= 1
        d = load_dump(dumps[0].path)
        assert any(e["kind"] == "slo_burn" for e in d["events"])
        for t in d["traces"]:  # linked traces carry the same stamps
            assert t["table_version"] == db.table_version
            assert t["stage_version"] == sv
        # recorder's own counters surface in the registry
        assert reg.counter("flightrec_dumps_total").value() == 1.0
        assert reg.counter("flightrec_suppressed_total").value() == 1.0
    finally:
        router.close()


def test_controller_crash_produces_one_dump_despite_bus_event(tmp_path):
    bus = EventBus()
    router, db = _make_router(metrics=False)
    store = OutcomeStore(n_tools=len(db), capacity=64)
    try:
        rec = FlightRecorder(str(tmp_path / "d"), bus=bus,
                             routers=[router], debounce_s=60.0)
        controller = RefinementController(
            db, store, _embed_batch, routers=[router],
            config=ControllerConfig(min_events=10**9, max_interval_s=10**9),
            bus=bus, flight_recorder=rec,
        )

        def boom():
            raise RuntimeError("injected daemon crash")

        controller.step = boom
        controller.start(interval_s=0.01)
        try:
            assert _wait_for(lambda: rec.dumps_written >= 1)
            # the loop keeps crashing but loop_error is transition-latched
            # and the crash dump is debounced: still exactly one dump
            time.sleep(0.05)
            dumps = rec.list()
            assert len(dumps) == 1
            m = dumps[0].manifest
            assert m["reason"] == "crash"
            assert m["trigger"]["source"] == "RefinementController"
            assert "injected daemon crash" in m["trigger"]["error"]
            # the direct hook fired before the bus event, so the bus-side
            # loop_error was suppressed by debounce, not double-dumped
            assert bus.last("loop_error") is not None
        finally:
            controller.stop()
    finally:
        router.close()


def test_crash_dump_without_bus_and_errors_never_escape(tmp_path):
    # the hook works with no bus wired at all
    rec = FlightRecorder(str(tmp_path / "d"), debounce_s=0.0)
    path = rec.record_crash(ValueError("standalone"), source="unit")
    assert path is not None and os.path.isdir(path)
    m = list_dumps(str(tmp_path / "d"))[0].manifest
    assert m["trigger"]["error_type"] == "ValueError"
    # a recorder whose out_dir write fails must raise to ITS caller only —
    # the controller loop wraps record_crash, verified here by the wrapper
    # contract: dump() cleans its staging dir on failure
    rec2 = FlightRecorder(str(tmp_path / "d2"), debounce_s=0.0)
    os.chmod(tmp_path / "d2", 0o500)
    try:
        if os.access(tmp_path / "d2", os.W_OK):
            pytest.skip("running as privileged user; chmod cannot revoke")
        with pytest.raises(OSError):
            rec2.dump(reason="unwritable")
        assert not [e for e in os.listdir(tmp_path / "d2")]
    finally:
        os.chmod(tmp_path / "d2", 0o700)


def test_retention_and_tmp_sweep(tmp_path):
    out = tmp_path / "dumps"
    rec = FlightRecorder(str(out), debounce_s=0.0, max_dumps=2)
    # an abandoned staging dir from a "crashed" prior process
    stale = out / ".tmp-dump-0-9999-crash"
    stale.mkdir()
    (stale / "manifest.json").write_text("{not json")
    for i in range(4):
        rec.dump(reason=f"r{i}")
    names = sorted(os.listdir(out))
    assert len(names) == 2, names
    assert all(n.startswith("dump-") for n in names)  # tmp dir swept
    assert [d.manifest["reason"] for d in list_dumps(str(out))] == ["r2", "r3"]
    # a dump dir without a readable manifest is not a dump
    bad = out / "dump-0-0000-zzz"
    bad.mkdir()
    assert [d.manifest["reason"] for d in list_dumps(str(out))] == ["r2", "r3"]


def test_replay_renders_trigger_traces_and_versions(tmp_path):
    bus = EventBus()
    reg = MetricsRegistry()
    tracer = RouteTracer(sample_every=1)
    ring = TimeSeriesRing(reg, bus=bus)
    router, db = _make_router(metrics=reg, tracer=tracer, bus=bus)
    try:
        _route_some(router)
        db.swap_table(np.asarray(db.embeddings) * 1.0, expect_current=0)
        _route_some(router, seed=2)
        ring.tick(now=0.0)
        ring.tick(now=1.0)
        rec = FlightRecorder(
            str(tmp_path / "dumps"), bus=bus, registry=reg, tracer=tracer,
            ring=ring, routers=[router], debounce_s=0.0,
        )
        bus.publish("quality_drift", plane="serve", score=9.9, threshold=4.0)
        [dump] = rec.list()
        text = render_replay(dump.path)
        assert "reason: quality_drift" in text
        assert "<-- trigger" in text
        assert "trace #" in text and "table=v1" in text
        assert "serving: table v1" in text
        # the CLI renders the same thing from the dumps root
        rc = report_main(["replay", str(tmp_path / "dumps")])
        assert rc == 0
        d = load_dump(dump.path)
        assert d["timeseries"]["points"], "ring window must be preserved"
    finally:
        router.close()


# ------------------------------------------------------------- jit profiler


def test_profiler_baselines_warmup_then_counts_growth():
    reg = MetricsRegistry()
    fn = _FakeJit(size=3)  # 3 warmup compiles before the profiler attaches
    prof = JitProfiler(jits={"fake": fn}, registry=reg)
    prof.collect()  # baseline
    assert prof.snapshot()["jits"]["fake"]["compiles_total"] == 0
    assert reg.counter("jit_compiles_total", fn="fake").value() == 0.0
    assert reg.gauge("jit_cache_size", fn="fake").value() == 3.0
    fn.size = 5  # two production retraces
    prof.collect()
    snap = prof.snapshot()["jits"]["fake"]
    assert snap["compiles_total"] == 2 and snap["cache_size"] == 5
    assert reg.counter("jit_compiles_total", fn="fake").value() == 2.0
    # unsupported callables degrade, never fail
    prof2 = JitProfiler(jits={"plain": lambda x: x})
    assert prof2.unsupported == ["plain"] and prof2.names() == []


def test_cost_stamping_reports_flops_without_growing_cache():
    # the topk_sim probe of hot_path_jits(): stamping reads shapes only, so
    # the library stays unloaded and no kernel is launched
    probe = hot_path_jits()["topk_sim"]
    prof = JitProfiler(jits={"topk_sim": probe})
    prof.collect()
    before, launches = probe._cache_size(), topk_kernel.launches
    n_q, n_t, d, k = 16, 100_000, 384, 5
    cost = prof.stamp_cost("topk_sim", n_q, n_t, d, k)
    assert probe._cache_size() == before, "stamping must not load or launch"
    assert topk_kernel.launches == launches and topk_kernel.LIBRARY.loads == 0
    # the hand count: 2QTD multiply-add FLOPs; float32 queries and table
    # read once, float32 scores and int64 indices written once
    assert cost["flops"] == 2 * 16 * 100_000 * 384
    assert cost["bytes_accessed"] == 4 * (16 * 384 + 100_000 * 384) + 16 * 5 * (4 + 8)
    assert cost["arg_shapes"] == [n_q, n_t, d, k]
    assert cost["route"] == "wgmma"  # 16 queries over a large table
    assert prof.stamp_cost("topk_sim", 8, 100_000, d, k)["route"] == "split"
    assert prof.stamp_cost("topk_sim", 64, 2413, d, 25)["route"] == "cluster"
    assert prof.stamp_cost("topk_sim", 64, 2413, d, 130)["route"] == "select"
    snap = prof.snapshot()["jits"]["topk_sim"]
    assert snap["cost"]["flops"] == 2 * 64 * 2413 * d
    assert snap["compiles_total"] == 0
    with pytest.raises(ValueError):  # a probe without an analytic cost
        JitProfiler(jits={"fake": _FakeJit()}).stamp_cost("fake", 1)


def test_router_costs_stamp_the_fused_backend_at_its_padded_shapes():
    prof = JitProfiler()
    assert prof.names() == ["topk_sim"]
    assert prof.unsupported == ["adapter_apply", "rerank_topk_scored"]
    fused, _ = _make_router(n_tools=40, backend="fused", metrics=False)
    dense, _ = _make_router(n_tools=40, metrics=False)
    try:
        assert stamp_router_costs(prof, dense, batch_size=5) == {}  # no kernel there
        [(name, cost)] = stamp_router_costs(prof, fused, batch_size=5).items()
        assert name == "topk_sim" and cost["arg_shapes"] == [8, 40, D, 3]  # Q padded to 8
        assert cost["route"] == "cluster"
        # a live re-ranker asks the index for k x candidate_multiplier rows
        mlp = {f"w{i}": torch.zeros(a, b) for i, (a, b) in enumerate(((7, 64), (64, 32), (32, 1)))}
        mlp.update({f"b{i}": torch.zeros(b) for i, b in enumerate((64, 32, 1))})
        fused.set_stages(StageSet(mlp_params=mlp, featurizer=object()), expect_version=0)
        cost = stamp_router_costs(prof, fused, batch_size=5)["topk_sim"]
        assert cost["arg_shapes"] == [8, 40, D, 15]
    finally:
        fused.close()
        dense.close()


def test_probe_counts_the_library_and_each_route_first_launch(monkeypatch):
    # what the card does, told to the probe: the library loads, then each
    # route's first launch loads its kernels once; later launches add nothing
    probe = hot_path_jits()["topk_sim"]
    monkeypatch.setattr(topk_kernel, "launched_routes", set())
    monkeypatch.setattr(topk_kernel.LIBRARY, "loads", 0)
    reg = MetricsRegistry()
    prof = JitProfiler(registry=reg)
    assert prof.collect() == {"topk_sim": 0}  # baseline: nothing loaded
    topk_kernel.LIBRARY.loads = 1
    topk_kernel.launched_routes.add("wgmma")
    assert prof.collect() == {"topk_sim": 2}
    topk_kernel.launched_routes.add("cluster")
    prof.collect()
    prof.collect()  # no growth: nothing counted
    snap = prof.snapshot()["jits"]["topk_sim"]
    assert snap["compiles_total"] == 3 and snap["cache_size"] == 3
    assert reg.counter("jit_compiles_total", fn="topk_sim").value() == 3.0
    assert reg.gauge("jit_cache_size", fn="topk_sim").value() == 3.0


def test_compile_rate_slo_keys_match_profiler_counters():
    # the contract chain: hot_path_jits() names -> profiler counter labels
    # -> ring point keys -> default_slos() jit_retrace_rate event_keys
    reg = MetricsRegistry()
    fakes = {name: _FakeJit(1) for name in hot_path_jits()}
    prof = JitProfiler(jits=fakes, registry=reg)
    prof.collect()
    ring = TimeSeriesRing(reg)
    point = ring.tick(now=0.0)
    slo = next(s for s in default_slos() if s.name == "jit_retrace_rate")
    for key in slo.event_keys:
        assert key in point.counters, key
    # and the SLO actually fires on sustained post-warmup compile growth
    engine = SLOEngine(
        ring,
        slos=(SLO(
            name="jit_retrace_rate", kind="rate",
            event_keys=slo.event_keys, max_per_hour=60.0,
            windows=(BurnWindow(long_s=10.0, short_s=4.0, factor=1.0),),
        ),),
        bus=(bus := EventBus()),
    )
    for step in range(1, 6):
        fakes["topk_sim"].size += 2  # a new load every tick
        prof.collect()
        ring.tick(now=float(step))
        engine.evaluate(now=float(step))
    assert engine.burning() == ["jit_retrace_rate"]
    assert bus.last("slo_burn") is not None


def test_sampling_profiler_catches_a_busy_thread_and_stops_clean():
    stop = threading.Event()

    def busy_loop():
        while not stop.is_set():
            sum(range(100))

    t = threading.Thread(target=busy_loop, name="busy", daemon=True)
    t.start()
    prof = SamplingProfiler(interval_s=0.001)
    prof.watch_thread(t, "busy")
    try:
        prof.start()
        assert _wait_for(
            lambda: prof.snapshot()["threads"].get("busy") is not None
        )
    finally:
        prof.stop()
        prof.stop()  # idempotent
        stop.set()
        t.join(timeout=5.0)
    snap = prof.snapshot()
    [top] = [s for s in snap["threads"]["busy"][:1]]
    assert "busy_loop@" in top["stack"] and top["samples"] >= 1
    assert snap["n_samples"] >= top["samples"]


# -------------------------------------------------------- shutdown discipline


def test_shutdown_order_leaves_no_leaked_threads():
    baseline = set(threading.enumerate())
    bus = EventBus()
    reg = MetricsRegistry()
    ring = TimeSeriesRing(reg, bus=bus)
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        rec = FlightRecorder(td, bus=bus, registry=reg, ring=ring,
                             debounce_s=60.0)
        ring.start(interval_s=0.01)
        server = ObsServer(registry=reg, bus=bus, recorder=rec).start()
        sampler = SamplingProfiler(interval_s=0.005)
        sampler.watch_thread(ring.thread(), "ring")
        sampler.start()
        assert _wait_for(lambda: len(ring) >= 2)
        # the serve.py signal order: recorder -> daemons -> server
        rec.stop()
        bus.publish("slo_burn", plane="serve", slo="x")  # post-stop: ignored
        assert rec.dumps_written == 0
        sampler.stop()
        ring.stop()
        server.stop()
        # all idempotent
        rec.stop(); sampler.stop(); ring.stop(); server.stop()
    leaked = [
        t for t in set(threading.enumerate()) - baseline
        if t.is_alive() and not t.daemon
    ]
    assert leaked == [], leaked
    # and the telemetry daemons we created are genuinely gone (not merely
    # daemonized): stop() joined them
    ours = [t for t in set(threading.enumerate()) - baseline
            if t.name in ("timeseries-ring", "obs-server", "sampling-profiler")
            and t.is_alive()]
    assert ours == [], ours


# ------------------------------------------------------- concurrent scrapes


def _get_json(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return json.loads(resp.read())


def test_concurrent_slo_traces_dumps_scrapes_during_swaps(tmp_path):
    bus = EventBus()
    reg = MetricsRegistry()
    tracer = RouteTracer(sample_every=1)
    ring = TimeSeriesRing(reg, bus=bus)
    engine = SLOEngine(ring, bus=bus, registry=reg)
    router, db = _make_router(metrics=reg, tracer=tracer, bus=bus)
    adapter = {
        "w1": torch.zeros((D, 4)), "b1": torch.zeros(4),
        "w2": torch.zeros((4, D)), "b2": torch.zeros(D),
    }
    try:
        _route_some(router)
        ring.tick(now=0.0)
        ring.tick(now=1.0)
        rec = FlightRecorder(str(tmp_path / "d"), bus=bus, registry=reg,
                             tracer=tracer, ring=ring, slo=engine,
                             routers=[router], debounce_s=0.0, max_dumps=32)
        server = ObsServer(
            HealthMonitor(routers=[router], bus=bus, slo=engine),
            reg, bus, slo=engine, tracer=tracer, recorder=rec,
        ).start()
        base = f"http://{server.host}:{server.port}"
        stop = threading.Event()
        errors = []

        def churn():
            # table swaps + stage promotions + dump-producing triggers
            i = 0
            while not stop.is_set():
                i += 1
                db.swap_table(np.asarray(db.embeddings),
                              expect_current=db.table_version)
                sv, _ = router.stage_set()
                router.set_stages(
                    StageSet(adapter_params=adapter, adapter_scale=0.0)
                    if i % 2 else StageSet(),
                    expect_version=sv,
                )
                bus.publish("demotion", plane="learn", condemned_version=i)

        def scrape(path, check):
            while not stop.is_set():
                try:
                    check(_get_json(base + path))
                except Exception as exc:  # noqa: BLE001 — collected
                    errors.append(f"{path}: {exc!r}")
                    return

        def check_slo(snap):
            assert set(snap) >= {"status", "burning", "slos"}

        def check_traces(recs):
            for t in recs:
                # stamps are internally consistent: versions the db/router
                # actually passed through, never torn/interleaved values
                assert 0 <= t["table_version"] <= db.table_version
                assert set(t["spans"]) <= {
                    "embed", "adapter", "score", "rerank", "assemble"
                }

        def check_dumps(body):
            assert body["recorder"]["out_dir"]
            for dmp in body["dumps"]:
                m = dmp["manifest"]
                assert m["format_version"] == DUMP_FORMAT_VERSION
                [s] = m["serving"]
                assert 0 <= s["table_version"] <= db.table_version

        threads = [threading.Thread(target=churn, daemon=True)] + [
            threading.Thread(target=scrape, args=(p, c), daemon=True)
            for p, c in (("/slo", check_slo), ("/traces", check_traces),
                         ("/dumps", check_dumps))
        ]
        for t in threads:
            t.start()
        time.sleep(0.8)
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
        server.stop()
        assert errors == [], errors
        assert rec.dumps_written >= 1  # the demotion triggers actually fired
        # every dump that landed is complete and readable after the fact
        for dmp in rec.list():
            d = load_dump(dmp.path)
            assert d["manifest"]["artifacts"]
    finally:
        router.close()


# ------------------------------------------------- dumps across the packages


def _dump(pkg_obs, tooldb, router_cls, out_dir, **router_kw):
    """One quality_drift dump after traced batches and a swap, written by
    `pkg_obs`'s FlightRecorder over a router of the same package."""
    bus = pkg_obs.EventBus()
    reg = pkg_obs.MetricsRegistry()
    tracer = pkg_obs.RouteTracer(sample_every=1, seed=0)
    ring = pkg_obs.TimeSeriesRing(reg, bus=bus)
    rng = np.random.default_rng(0)
    records = [tooldb.ToolRecord(i, f"t{i}", np.arange(3), 0) for i in range(12)]
    db = tooldb.ToolsDatabase(records, rng.standard_normal((12, D)).astype(np.float32))
    router = router_cls(db, _embed, k=3, metrics=reg, tracer=tracer, bus=bus, **router_kw)
    try:
        _route_some(router)
        db.swap_table(np.asarray(db.embeddings) * 1.0, expect_current=0)
        _route_some(router, seed=2)
        ring.tick(now=0.0)
        ring.tick(now=1.0)
        profiler = pkg_obs.JitProfiler(jits={"fake": _FakeJit(2)})
        profiler.collect()
        rec = pkg_obs.FlightRecorder(out_dir, bus=bus, registry=reg, tracer=tracer, ring=ring,
                                     slo=pkg_obs.SLOEngine(ring, bus=bus), routers=[router],
                                     profiler=profiler, debounce_s=0.0)
        bus.publish("quality_drift", plane="serve", score=9.9, threshold=4.0)
        [dump] = rec.list()
        return dump.path
    finally:
        router.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dumps_render_alike_through_both_packages(writer, tmp_path):
    import repro.obs as jax_obs
    import repro.router.tooldb as jax_tooldb
    import repro_torch.obs as port_obs
    import repro_torch.router.tooldb as port_tooldb
    from repro.obs.flightrec import DUMP_FORMAT_VERSION as JAX_DUMP_FORMAT_VERSION
    from repro.obs.flightrec import load_dump as jax_load_dump
    from repro.obs.flightrec import render_replay as jax_render_replay
    from repro.router.gateway import SemanticRouter as JaxRouter

    assert DUMP_FORMAT_VERSION == JAX_DUMP_FORMAT_VERSION
    if writer == "port":
        path = _dump(port_obs, port_tooldb, SemanticRouter, str(tmp_path / "d"), device=CPU)
    else:
        path = _dump(jax_obs, jax_tooldb, JaxRouter, str(tmp_path / "d"))
    text = render_replay(path)
    assert jax_render_replay(path) == text
    assert jax_load_dump(path) == load_dump(path)
    assert "reason: quality_drift" in text and "<-- trigger" in text
    assert "serving: table v1" in text and "table=v1" in text
    assert "jit fake: cache=2 compiles_post_warmup=0" in text
    # and the two packages' dumps of the same incident tell the same story:
    # the same lines once the clock's readings are masked
    other = (_dump(jax_obs, jax_tooldb, JaxRouter, str(tmp_path / "o")) if writer == "port"
             else _dump(port_obs, port_tooldb, SemanticRouter, str(tmp_path / "o"), device=CPU))
    import re

    def masked(t):
        t = re.sub(r"dump-[^ ]+", "dump-<name>", t)
        t = re.sub(r'"ts": [0-9.]+', '"ts": <t>', t)
        t = re.sub(r"build_ms=\S+", "build_ms=<t>", t)
        t = re.sub(r"[-+]?\d+\.\d+(ms|s)", "<t>", t)
        return re.sub(r"p50=<t> p99=<t>|n=\d+ ", "", t)

    assert masked(render_replay(other)) == masked(text)
