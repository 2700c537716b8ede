"""The port's `SemanticRouter.route_batch` against the JAX gateway.

Both routers serve the same `small_bench` table with the same encoder,
stages and queries: the JAX one through its `dense` and `pallas` backends,
the port's through `dense` and `fused` on the CPU (where the fused backend
serves the kernel's plain version). Bare, with the adapter, with the
re-ranker, with candidate masks, at batch sizes 1, 3, 8 and 13 (so the
power-of-two padding is exercised), and across a CAS table swap and
`set_stages`/`rollback_stages`. Tools, table_version, stage_version and
cache_hit must be identical; scores within atol=1e-5. With a route cache in
front of each router the same rows must hit, across swaps and stage
promotions; with seeded tracers and a bus on each, the same batches must be
sampled and the same events published.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.cache import SemanticRouteCache as JaxRouteCache
from repro.core.features import OutcomeFeaturizer as JaxFeaturizer
from repro.embedding.bag_encoder import BagEncoder as JaxBagEncoder
from repro.obs import EventBus as JaxEventBus
from repro.obs import RouteTracer as JaxRouteTracer
from repro.router.gateway import SemanticRouter as JaxRouter
from repro.router.stages import StageSet as JaxStageSet
from repro.router.tooldb import ToolRecord as JaxToolRecord
from repro.router.tooldb import ToolsDatabase as JaxToolsDatabase
from repro_torch import convert
from repro_torch.cache import SemanticRouteCache
from repro_torch.core import reranker
from repro_torch.core.adapter import DIM, HIDDEN
from repro_torch.core.features import OutcomeFeaturizer
from repro_torch.embedding.bag_encoder import BagEncoder
from repro_torch.obs import EventBus, RouteTracer
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.router.gateway import RouteResult, SemanticRouter
from repro_torch.router.tooldb import ConflictError, ToolRecord, ToolsDatabase

CPU = "cpu"
BACKEND_PAIRS = [("dense", "dense"), ("pallas", "fused")]
BATCHES = (1, 3, 8, 13)


def _adapter_params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w1": (rng.normal(size=(DIM, HIDDEN)) * np.sqrt(2.0 / DIM)).astype(np.float32),
        "b1": (rng.normal(size=(HIDDEN,)) * 0.01).astype(np.float32),
        "w2": (rng.normal(size=(HIDDEN, DIM)) * 0.05).astype(np.float32),
        "b2": (rng.normal(size=(DIM,)) * 0.01).astype(np.float32),
    }


def _mlp_params(seed=0):
    rng = np.random.default_rng(seed)
    params = {}
    for li, (din, dout) in enumerate(zip(reranker.LAYERS[:-1], reranker.LAYERS[1:])):
        params[f"w{li}"] = (rng.normal(size=(din, dout)) * np.sqrt(2.0 / din)).astype(np.float32)
        params[f"b{li}"] = (rng.normal(size=(dout,)) * 0.1).astype(np.float32)
    return params


def _jnp(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


class _Pair:
    """A JAX router and a port router over identical databases."""

    def __init__(self, bench, jax_backend, torch_backend, k=5, jax_hooks=None,
                 torch_hooks=None):
        table = JaxBagEncoder(bench.vocab).encode(bench.desc_tokens)
        self.table = table
        n = bench.n_tools
        self.jdb = JaxToolsDatabase(
            [JaxToolRecord(i, f"tool_{i}", bench.desc_tokens[i], int(bench.tool_category[i]))
             for i in range(n)], table)
        self.tdb = ToolsDatabase(
            [ToolRecord(i, f"tool_{i}", bench.desc_tokens[i], int(bench.tool_category[i]))
             for i in range(n)], table)
        jenc = JaxBagEncoder(bench.vocab)
        tenc = BagEncoder(bench.vocab, device=CPU)
        self.jax = JaxRouter(self.jdb, embed_fn=jenc.encode_one, embed_batch_fn=jenc.encode,
                             k=k, backend=jax_backend, metrics=False, **(jax_hooks or {}))
        self.torch = SemanticRouter(self.tdb, embed_fn=tenc.encode_one,
                                    embed_batch_fn=tenc.encode, k=k, backend=torch_backend,
                                    metrics=MetricsRegistry(), device=CPU,
                                    **(torch_hooks or {}))

    def compare(self, queries, masks=None):
        jr = self.jax.route_batch(queries, masks)
        tr = self.torch.route_batch(queries, masks)
        assert len(jr) == len(tr) == len(queries)
        for a, b in zip(jr, tr):
            assert isinstance(b, RouteResult)
            assert a.tools == b.tools
            np.testing.assert_allclose(b.scores, a.scores, atol=1e-5)
            assert (a.table_version, a.stage_version, a.cache_hit) == (
                b.table_version, b.stage_version, b.cache_hit)
            assert a.pool == b.pool
        return tr


def _stage_pairs(bench, table, which):
    """(JAX StageSet, port StageSet) built from the same numpy params."""
    if which == "adapter":
        p = _adapter_params()
        return (JaxStageSet(adapter_params=_jnp(p)),
                convert.stages_from_jax(adapter_params=p, device=CPU))
    train = bench.train_idx
    q_emb = JaxBagEncoder(bench.vocab).encode([bench.query_tokens[j] for j in train])
    rel = bench.relevance_matrix()[train]
    retrieved = np.argsort(-(q_emb @ table.T), axis=1, kind="stable")[:, :5]
    toks = [bench.query_tokens[j] for j in train]
    args = (q_emb, toks, rel, retrieved, bench.tool_category)
    jfeat = JaxFeaturizer.fit(*args, n_clusters=8, seed=0)
    tfeat = OutcomeFeaturizer.fit(*args, n_clusters=8, seed=0)
    mlp = _mlp_params()
    return (JaxStageSet(mlp_params=_jnp(mlp), featurizer=jfeat),
            convert.stages_from_jax(mlp_params=mlp, featurizer=tfeat, device=CPU))


@pytest.mark.parametrize("jax_backend,torch_backend", BACKEND_PAIRS)
@pytest.mark.parametrize("stages", ["bare", "adapter", "rerank"])
def test_route_batch_matches_jax(small_bench, jax_backend, torch_backend, stages):
    pair = _Pair(small_bench, jax_backend, torch_backend)
    if stages != "bare":
        js, ts = _stage_pairs(small_bench, pair.table, stages)
        pair.jax.set_stages(js, expect_version=0)
        pair.torch.set_stages(ts, expect_version=0)
    start = 0
    for n in BATCHES:
        queries = small_bench.query_tokens[start:start + n]
        start += n
        results = pair.compare(queries)
        assert all(r.stage_version == (0 if stages == "bare" else 1) for r in results)
        assert all(len(r.tools) == 5 for r in results)
    assert pair.torch.index.last_path() == f"index:{torch_backend}"
    if stages == "rerank":
        reg = pair.torch._obs.registry
        assert reg.histogram("route_phase_ms", phase="rerank").count() == len(BATCHES)


@pytest.mark.parametrize("jax_backend,torch_backend", BACKEND_PAIRS)
def test_route_batch_reranks_26_over_400_tools_matches_jax(small_bench_sparse, jax_backend,
                                                           torch_backend):
    """k = 26 with the re-ranker asks the backend for C = 130 candidates,
    past the 128 that the fused kernel's first three routes take (on the
    card the select route serves them; here its plain version). The port
    routes as the JAX gateway does, whose Pallas backend takes any k."""
    pair = _Pair(small_bench_sparse, jax_backend, torch_backend, k=26)
    js, ts = _stage_pairs(small_bench_sparse, pair.table, "rerank")
    pair.jax.set_stages(js, expect_version=0)
    pair.torch.set_stages(ts, expect_version=0)
    results = pair.compare(small_bench_sparse.query_tokens[:13])
    assert all(len(r.tools) == 26 for r in results)
    assert pair.torch.index.last_path() == f"index:{torch_backend}"


@pytest.mark.parametrize("jax_backend,torch_backend", BACKEND_PAIRS)
def test_route_batch_with_candidate_masks_matches_jax(small_bench, jax_backend, torch_backend):
    pair = _Pair(small_bench, jax_backend, torch_backend)
    mask = small_bench.candidate_mask()
    start = 0
    for n in BATCHES:
        sl = slice(start, start + n)
        results = pair.compare(small_bench.query_tokens[sl], mask[sl])
        for j, r in enumerate(results):
            assert set(r.tools) <= set(np.flatnonzero(mask[start + j]).tolist())
        start += n
    assert pair.torch.index.last_path() == (
        "exact" if torch_backend == "fused" else "index:dense")
    # a mask that admits fewer than k tools gives a correspondingly short list
    short = np.zeros((2, small_bench.n_tools), np.float32)
    short[0, [3, 11]] = 1.0
    short[1, 7] = 1.0
    results = pair.compare(small_bench.query_tokens[:2], short)
    assert [len(r.tools) for r in results] == [2, 1]


@pytest.mark.parametrize("jax_backend,torch_backend", BACKEND_PAIRS)
def test_route_batch_across_cas_swap_and_stage_rollback(small_bench, jax_backend,
                                                         torch_backend):
    pair = _Pair(small_bench, jax_backend, torch_backend)
    queries = small_bench.query_tokens[:13]
    pair.compare(queries)
    moved = pair.table[np.random.default_rng(0).permutation(small_bench.n_tools)]
    with pytest.raises(ConflictError):
        pair.tdb.swap_table(moved, expect_current=3)
    for db in (pair.jdb, pair.tdb):
        db.swap_table(moved, expect_current=0)
    results = pair.compare(queries)
    assert all(r.table_version == 1 for r in results)
    assert pair.torch.index.last_path() == f"index:{torch_backend}"
    js, ts = _stage_pairs(small_bench, moved, "adapter")
    assert pair.jax.set_stages(js, expect_version=0) == 1
    assert pair.torch.set_stages(ts, expect_version=0) == 1
    with pytest.raises(ConflictError):
        pair.torch.set_stages(ts, expect_version=0)
    results = pair.compare(queries[:8])
    assert all(r.stage_version == 1 for r in results)
    assert pair.jax.rollback_stages(expect_current=1) == 2
    assert pair.torch.rollback_stages(expect_current=1) == 2
    assert pair.torch.retained_stage_versions() == pair.jax.retained_stage_versions()
    results = pair.compare(queries[:3])
    assert all(r.stage_version == 2 for r in results)
    for db in (pair.jdb, pair.tdb):
        db.rollback(expect_current=1)
    results = pair.compare(queries[:1])
    assert results[0].table_version == 2
    pair.torch.close()


def test_route_single_and_empty_and_outcomes(small_bench):
    pair = _Pair(small_bench, "dense", "fused")
    q = small_bench.query_tokens[5]
    a, b = pair.jax.route(q), pair.torch.route(q)
    assert a.tools == b.tools
    assert pair.torch.route_batch([]) == []
    pair.torch.record_outcome(q, b.tools[0], 1)
    events = pair.torch.drain_outcomes()
    assert len(events) == 1 and events[0].tool_id == b.tools[0]
    reg = pair.torch._obs.registry
    assert reg.counter("route_requests_total").value() == 1
    assert reg.histogram("route_phase_ms", phase="score").count() >= 1


def _near_duplicates(bench, rng, n):
    """Repeats and near-duplicates (one token dropped) of a few queries."""
    base = [bench.query_tokens[j] for j in range(6)]
    out = []
    for _ in range(n):
        toks = base[rng.integers(len(base))]
        if rng.random() < 0.5 and len(toks) > 3:
            toks = np.delete(toks, rng.integers(len(toks)))
        out.append(np.asarray(toks))
    return out


@pytest.mark.parametrize("jax_backend,torch_backend", BACKEND_PAIRS)
@pytest.mark.parametrize("stages", ["bare", "adapter"])
def test_route_batch_with_cache_matches_jax(small_bench, jax_backend, torch_backend, stages):
    pair = _Pair(small_bench, jax_backend, torch_backend,
                 jax_hooks={"cache": JaxRouteCache(metrics=False)},
                 torch_hooks={"cache": SemanticRouteCache(metrics=False)})
    if stages != "bare":
        js, ts = _stage_pairs(small_bench, pair.table, stages)
        pair.jax.set_stages(js, expect_version=0)
        pair.torch.set_stages(ts, expect_version=0)
    rng = np.random.default_rng(1)
    hits = 0
    for step in range(12):
        if step == 5:
            moved = pair.table[np.random.default_rng(0).permutation(small_bench.n_tools)]
            for db in (pair.jdb, pair.tdb):
                db.swap_table(moved, expect_current=0)
        if step == 8:
            for r in (pair.jax, pair.torch):
                sv, st = r.stage_set()
                r.set_stages(st, expect_version=sv)
        results = pair.compare(_near_duplicates(small_bench, rng, 1 + step % 8))
        hits += sum(r.cache_hit for r in results)
    assert hits > 0
    assert pair.torch.cache.stats == pair.jax.cache.stats
    reg = pair.torch._obs.registry
    assert reg.counter("route_cache_stale_served_total").value() == 0
    # a masked batch bypasses both caches
    mask = small_bench.candidate_mask()[:3]
    assert not any(r.cache_hit for r in pair.compare(small_bench.query_tokens[:3], mask))
    pair.torch.close()


@pytest.mark.parametrize("jax_backend,torch_backend", BACKEND_PAIRS)
def test_tracer_and_bus_match_jax(small_bench, jax_backend, torch_backend):
    jbus, tbus = JaxEventBus(), EventBus()
    pair = _Pair(small_bench, jax_backend, torch_backend,
                 jax_hooks={"tracer": JaxRouteTracer(sample_every=2, seed=3), "bus": jbus},
                 torch_hooks={"tracer": RouteTracer(sample_every=2, seed=3), "bus": tbus})
    jbus.watch_db(pair.jdb)
    tbus.watch_db(pair.tdb)
    start = 0
    for step, n in enumerate(BATCHES * 3):
        if step == 4:
            for db in (pair.jdb, pair.tdb):
                db.swap_table(pair.table[::-1].copy(), expect_current=0)
        if step == 7:
            js, ts = _stage_pairs(small_bench, pair.table, "adapter")
            pair.jax.set_stages(js, expect_version=0)
            pair.torch.set_stages(ts, expect_version=0)
        pair.compare(small_bench.query_tokens[start:start + n])
        start += n
    jt, tt = pair.jax._tracer.traces(), pair.torch._tracer.traces()
    assert len(tt) == len(jt) > 2
    for a, b in zip(jt, tt):
        assert (a.trace_id, a.batch_size, a.bucket, a.table_version, a.stage_version) == (
            b.trace_id, b.batch_size, b.bucket, b.table_version, b.stage_version)
        assert b.path == f"index:{torch_backend}" and a.path == f"index:{jax_backend}"
        assert [n for n, _ in a.spans] == [n for n, _ in b.spans]
    assert [(e.kind, e.plane) for e in jbus.events()] == [(e.kind, e.plane)
                                                          for e in tbus.events()]
    assert {"swap", "stage_swap", "rebuild_finish"} <= set(tbus.counts())
    pair.torch.close()
