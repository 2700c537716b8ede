"""The port's route cache against the JAX package's, and the cases of
`tests/test_cache.py` as port cases.

Parity: the same insert and lookup sequence through both caches makes the
same hits and misses, serves the same entries, evicts the same LRU slots
and ends with the same counters; two routers (JAX dense, port dense and
fused on the CPU) fronted by a cache each serve the same stream with the
same hit pattern, tools and version stamps.

The mirrored cases: LSH/LRU/invalidation unit behaviour, the gateway's use
of the cache (hit correctness, mask bypass, mixed batches, swap and stage
invalidation), and the threaded churn race the version stamps exist for,
each through the port's router on the dense and on the fused backend.
"""
import threading

import numpy as np
import pytest

from repro.cache import CacheConfig as JaxCacheConfig
from repro.cache import SemanticRouteCache as JaxRouteCache
from repro.router.gateway import SemanticRouter as JaxRouter
from repro.router.tooldb import ToolRecord as JaxToolRecord
from repro.router.tooldb import ToolsDatabase as JaxToolsDatabase
from repro_torch.cache import CacheConfig, CachedRoute, SemanticRouteCache
from repro_torch.obs.events import EventBus
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.router.gateway import SemanticRouter
from repro_torch.router.tooldb import ToolRecord, ToolsDatabase

D = 32
CPU = "cpu"
BACKENDS = ["dense", "fused"]


def _embed(tokens):
    v = np.bincount(np.asarray(tokens, np.int64) % D, minlength=D).astype(np.float32)
    n = np.linalg.norm(v)
    return v / n if n else v


def _embed_batch(token_lists):
    return np.stack([_embed(t) for t in token_lists])


def _unit(rng, n=1):
    v = rng.standard_normal((n, D)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _table(n_tools):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((n_tools, D)).astype(np.float32)
    return table / np.linalg.norm(table, axis=1, keepdims=True)


def _make_router(n_tools=24, cache=None, metrics=False, bus=None, backend="dense"):
    records = [ToolRecord(i, f"t{i}", np.arange(3), 0) for i in range(n_tools)]
    db = ToolsDatabase(records, _table(n_tools))
    router = SemanticRouter(db, embed_fn=_embed, embed_batch_fn=_embed_batch, k=3,
                            cache=cache, metrics=metrics, bus=bus, backend=backend,
                            device=CPU)
    return router, db


def _queries(rng, n, lo=0, hi=200):
    return [rng.integers(lo, hi, size=8).astype(np.int64) for _ in range(n)]


# ------------------------------------------------------------------ parity
def _entry_key(e):
    return None if e is None else (e.tools, e.scores, e.table_version, e.stage_version)


@pytest.mark.parametrize("cfg", [dict(), dict(n_tables=4, capacity=16),
                                 dict(n_bits=6, n_tables=2, capacity=12, min_gap=0.05)])
def test_cache_hits_misses_and_evictions_match_jax(cfg):
    ours, theirs = (SemanticRouteCache(CacheConfig(**cfg), metrics=False),
                    JaxRouteCache(JaxCacheConfig(**cfg), metrics=False))
    rng = np.random.default_rng(1)
    seen = _unit(rng, 24)
    for step in range(60):
        # a batch mixing fresh directions, exact repeats and near-duplicates
        q = np.concatenate([_unit(rng, 2), seen[rng.integers(len(seen), size=2)]])
        q[3] += 0.05 * _unit(rng, 1)[0]
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        tv, sv = step // 20, step // 30
        got = [c.lookup_batch(q, table_version=tv, stage_version=sv) for c in (ours, theirs)]
        assert [_entry_key(e) for e in got[0]] == [_entry_key(e) for e in got[1]], step
        tools = [[int(t) for t in rng.permutation(30)[:3]] for _ in range(len(q))]
        scores = [sorted(rng.random(3).tolist(), reverse=True) for _ in range(len(q))]
        for c in (ours, theirs):
            c.insert_batch(q, tools, scores, table_version=tv, stage_version=sv)
        assert len(ours) == len(theirs)
        assert list(ours._entries) == list(theirs._entries)  # LRU order of the slots
    assert ours.stats == theirs.stats
    assert ours.stats["hits"] > 0 and ours.stats["misses"] > 0
    assert ours.invalidate(table_version=5, stage_version=5) == theirs.invalidate(
        table_version=5, stage_version=5)
    assert ours.stats == theirs.stats


@pytest.mark.parametrize("backend", BACKENDS)
def test_cached_router_matches_jax(backend):
    n_tools = 24
    table = _table(n_tools)
    jdb = JaxToolsDatabase([JaxToolRecord(i, f"t{i}", np.arange(3), 0) for i in range(n_tools)],
                           table)
    jax_router = JaxRouter(jdb, embed_fn=_embed, embed_batch_fn=_embed_batch, k=3,
                           cache=JaxRouteCache(metrics=False), metrics=False)
    router, db = _make_router(n_tools, cache=SemanticRouteCache(metrics=False),
                              backend=backend)
    rng = np.random.default_rng(2)
    pool = _queries(rng, 12)
    for step in range(16):
        batch = [pool[j] for j in rng.integers(len(pool), size=5)]
        if step in (6, 11):
            for d in (jdb, db):
                version, live = d.snapshot()
                d.swap_table(live.copy(), expect_current=version)
        a, b = jax_router.route_batch(batch), router.route_batch(batch)
        for x, y in zip(a, b):
            assert (x.tools, x.cache_hit, x.table_version, x.stage_version) == (
                y.tools, y.cache_hit, y.table_version, y.stage_version)
            np.testing.assert_allclose(y.scores, x.scores, atol=1e-5)
    assert router.cache.stats == jax_router.cache.stats
    router.close()


# ------------------------------------------------------------------ unit
def test_insert_then_lookup_hits_with_stamps():
    cache = SemanticRouteCache(CacheConfig(threshold=0.95), metrics=False)
    rng = np.random.default_rng(1)
    q = _unit(rng, 3)
    cache.insert_batch(q, [[1, 2], [3, 4], [5, 6]], [[0.9, 0.5], [0.8, 0.4], [0.7, 0.3]],
                       table_version=7, stage_version=2)
    out = cache.lookup_batch(q, table_version=7, stage_version=2)
    assert all(isinstance(e, CachedRoute) for e in out)
    assert out[0].tools == (1, 2) and out[0].scores == (0.9, 0.5)
    assert out[0].table_version == 7 and out[0].stage_version == 2
    near = q + 0.05 * _unit(rng, 3)
    near /= np.linalg.norm(near, axis=1, keepdims=True)
    hits = cache.lookup_batch(near, table_version=7, stage_version=2)
    assert sum(e is not None for e in hits) >= 2  # LSH recall is probabilistic
    assert cache.lookup_batch(_unit(rng, 1), table_version=7, stage_version=2) == [None]
    assert cache.hit_rate() > 0.0


def test_stamp_mismatch_is_never_served_and_reclaims():
    cache = SemanticRouteCache(metrics=False)
    q = _unit(np.random.default_rng(2), 1)
    cache.insert_batch(q, [[1]], [[0.9]], table_version=1, stage_version=1)
    assert len(cache) == cache.config.n_tables
    assert cache.lookup_batch(q, table_version=2, stage_version=1) == [None]
    assert len(cache) == 0
    cache.insert_batch(q, [[1]], [[0.9]], table_version=2, stage_version=1)
    assert cache.lookup_batch(q, table_version=2, stage_version=2) == [None]
    assert cache.stats["invalidated"] == 2 * cache.config.n_tables


def test_threshold_two_is_supported_never_hit_mode():
    cache = SemanticRouteCache(CacheConfig(threshold=2.0), metrics=False)
    q = _unit(np.random.default_rng(3), 2)
    cache.insert_batch(q, [[1], [2]], [[0.9], [0.8]], table_version=1, stage_version=1)
    assert cache.lookup_batch(q, table_version=1, stage_version=1) == [None, None]
    assert cache.stats["misses"] == 2 and cache.stats["hits"] == 0


def test_min_gap_guards_near_tie_decisions():
    cache = SemanticRouteCache(CacheConfig(min_gap=0.05), metrics=False)
    q = _unit(np.random.default_rng(4), 2)
    cache.insert_batch(q, [[1, 2], [3, 4]], [[0.90, 0.89], [0.90, 0.70]],
                       table_version=1, stage_version=1)
    out = cache.lookup_batch(q, table_version=1, stage_version=1)
    assert out[0] is None
    assert out[1] is not None and out[1].gap == pytest.approx(0.20)


def test_lru_eviction_bounds_capacity():
    cfg = CacheConfig(n_tables=4, capacity=16)
    cache = SemanticRouteCache(cfg, metrics=False)
    rng = np.random.default_rng(5)
    for i in range(10):
        cache.insert_batch(_unit(rng, 1), [[i]], [[0.5]], table_version=1, stage_version=1)
    assert len(cache) <= cfg.capacity
    assert cache.stats["evictions"] > 0


def test_invalidate_and_watch_purge_eagerly():
    bus = EventBus()
    registry = MetricsRegistry()
    cache = SemanticRouteCache(metrics=registry, bus=bus)
    detach = cache.watch(bus)
    rng = np.random.default_rng(6)
    cache.insert_batch(_unit(rng, 2), [[1], [2]], [[0.9], [0.8]], table_version=1,
                       stage_version=0)
    bus.publish("swap", plane="control", version=2)
    assert len(cache) == 0
    assert registry.counter("route_cache_invalidated_total").value() > 0
    events = bus.events(kind="cache_invalidated")
    assert events and events[-1].details["purged"] == 2 * cache.config.n_tables
    assert events[-1].details["reason"] == "swap"
    cache.insert_batch(_unit(rng, 1), [[3]], [[0.9]], table_version=2, stage_version=0)
    bus.publish("stage_swap", plane="learn", version=1)
    assert len(cache) == 0
    detach()
    cache.insert_batch(_unit(rng, 1), [[4]], [[0.9]], table_version=2, stage_version=1)
    bus.publish("swap", plane="control", version=3)
    assert len(cache) > 0  # detached: no eager purge (stamps still protect)


# ------------------------------------------------------------- integration
@pytest.mark.parametrize("backend", BACKENDS)
def test_gateway_serves_identical_results_from_cache(backend):
    router, _ = _make_router(cache=SemanticRouteCache(metrics=False), backend=backend)
    qs = _queries(np.random.default_rng(7), 4)
    first = router.route_batch(qs)
    second = router.route_batch(qs)
    assert all(not r.cache_hit for r in first)
    assert all(r.cache_hit for r in second)
    for a, b in zip(first, second):
        assert a.tools == b.tools
        assert np.allclose(a.scores, b.scores)
        assert (b.table_version, b.stage_version) == (a.table_version, a.stage_version)
    router.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_gateway_masked_batches_bypass_cache(backend):
    cache = SemanticRouteCache(metrics=False)
    router, db = _make_router(cache=cache, backend=backend)
    qs = _queries(np.random.default_rng(8), 2)
    router.route_batch(qs)
    before = dict(cache.stats)
    masked = router.route_batch(qs, candidate_masks=np.ones((2, len(db)), np.float32))
    assert all(not r.cache_hit for r in masked)
    assert cache.stats == before
    router.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_gateway_mixed_hit_miss_batch_preserves_order(backend):
    router, _ = _make_router(cache=SemanticRouteCache(metrics=False), backend=backend)
    rng = np.random.default_rng(9)
    qs = _queries(rng, 3)
    baseline = router.route_batch(qs)
    fresh = _queries(rng, 2, lo=300, hi=900)
    mixed = router.route_batch([qs[1], fresh[0], qs[2], fresh[1]])
    assert [r.cache_hit for r in mixed] == [True, False, True, False]
    assert mixed[0].tools == baseline[1].tools
    assert mixed[2].tools == baseline[2].tools
    assert len(mixed[1].tools) == router.k
    router.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_swap_and_stage_bump_invalidate_lazily(backend):
    router, db = _make_router(cache=SemanticRouteCache(metrics=False), backend=backend)
    qs = _queries(np.random.default_rng(10), 2)
    router.route_batch(qs)
    assert all(r.cache_hit for r in router.route_batch(qs))
    version, live = db.snapshot()
    db.swap_table(live.copy(), expect_current=version)
    post = router.route_batch(qs)
    assert all(not r.cache_hit for r in post)
    assert all(r.table_version == db.table_version for r in post)
    assert all(r.cache_hit for r in router.route_batch(qs))
    sv, stages = router.stage_set()
    router.set_stages(stages, expect_version=sv)
    post_stage = router.route_batch(qs)
    assert all(not r.cache_hit for r in post_stage)
    assert all(r.stage_version == router.stage_version for r in post_stage)
    router.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_threaded_churn_never_serves_stale_and_recovers(backend):
    registry = MetricsRegistry()
    cache = SemanticRouteCache(metrics=registry)
    router, db = _make_router(cache=cache, metrics=registry, backend=backend)
    rng = np.random.default_rng(11)
    pools = [_queries(rng, 4) for _ in range(6)]
    stop = threading.Event()
    violations = []

    def serve(worker: int):
        i = 0
        while not stop.is_set() or i < 20:
            batch = pools[(i + worker) % len(pools)]
            tv0, sv0 = db.table_version, router.stage_version
            results = router.route_batch(batch)
            tv1, sv1 = db.table_version, router.stage_version
            for r in results:
                if not (tv0 <= r.table_version <= tv1 and sv0 <= r.stage_version <= sv1):
                    violations.append((worker, r.table_version, r.stage_version,
                                       (tv0, sv0), (tv1, sv1)))
            i += 1
            if i >= 300:
                break

    workers = [threading.Thread(target=serve, args=(w,)) for w in range(3)]
    for t in workers:
        t.start()
    for step in range(30):
        if step % 3 == 0:
            version, live = db.snapshot()
            db.swap_table(live.copy(), expect_current=version)
        elif step % 3 == 1 and db.retained_versions():
            db.rollback(expect_current=db.table_version)
        else:
            sv, stages = router.stage_set()
            router.set_stages(stages, expect_version=sv)
    stop.set()
    for t in workers:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in workers)
    assert violations == []
    assert registry.counter("route_cache_stale_served_total").value() == 0
    qs = pools[0]
    router.route_batch(qs)
    assert all(r.cache_hit for r in router.route_batch(qs))
    router.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_cache_metrics_exported_through_gateway(backend):
    registry = MetricsRegistry()
    cache = SemanticRouteCache(metrics=registry)
    router, _ = _make_router(cache=cache, metrics=registry, backend=backend)
    qs = _queries(np.random.default_rng(12), 3)
    router.route_batch(qs)
    router.route_batch(qs)
    assert registry.counter("route_cache_hits_total").value() == 3
    assert registry.counter("route_cache_misses_total").value() == 3
    assert registry.gauge("route_cache_hit_ratio").value() == pytest.approx(0.5)
    assert registry.gauge("route_cache_size").value() == len(cache)
    assert registry.histogram("route_phase_ms", phase="cache").count() == 2
    router.close()
