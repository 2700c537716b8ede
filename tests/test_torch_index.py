"""Parity of the port's retrieval core and index layer with the JAX reference.

`topk_dense` (masks, short rows, zero pad queries), the dense and fused
backends (the fused one serves its plain version on CPU tensors), and the
`ToolIndexManager` lifecycle: masked batches to the exact path, inline
rebuild on a CAS swap, `last_path`. Inputs are made once with numpy from a
seed and given to both packages. Indices must be exactly equal, scores
within atol=1e-5 (the top-K tolerance of `tests/test_kernels.py`).

IVF and its int8 codes: `quantize_tree` bitwise the JAX package's; the
IVF build from the same host draws (equal k-means iterations, cold and
warm, assignments equal on >= 99.9% of rows); Recall@5 >= 0.98 against
exact (the reference's floor) and within 0.005 of the JAX IVF's, top-5 ids
equal to the JAX IVF's on >= 99% of queries with scores within 1e-5 where
they agree. The manager's background rebuild mirrors `tests/test_index.py`:
the exact fallback while a build runs, the warm start across swap
rebuilds, the swap listener, `close()`, fail-fast `backend_opts`, and a
failed build that keeps the fallback serving.
"""
import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.retrieval import topk_dense as jax_topk_dense
from repro.data.benchmarks import scale_tool_corpus
from repro.embedding.bag_encoder import BagEncoder as JaxBagEncoder
from repro.index import DenseBackend as JaxDenseBackend
from repro.index import IVFBackend as JaxIVFBackend
from repro.index import IVFConfig as JaxIVFConfig
from repro.index import ToolIndexManager as JaxToolIndexManager
from repro.router.tooldb import ToolRecord as JaxToolRecord
from repro.router.tooldb import ToolsDatabase as JaxToolsDatabase
from repro_torch.core.retrieval import NEG_INF, rank_dense, topk_dense
from repro_torch.index import (
    BACKENDS,
    DenseBackend,
    FusedBackend,
    IVFBackend,
    IVFConfig,
    ScorerBackend,
    ToolIndexManager,
    build_backend,
)
from repro_torch.router.tooldb import ConflictError, ToolRecord, ToolsDatabase

SCALED_T = 3_000
CPU = "cpu"


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


@pytest.fixture(scope="module")
def scaled(small_bench):
    """(table [3000, D], queries [48, D]) from the small benchmark."""
    enc = JaxBagEncoder(small_bench.vocab)
    table = scale_tool_corpus(enc.encode(small_bench.desc_tokens), SCALED_T, seed=0)
    return table, enc.encode(small_bench.query_tokens[:48])


def _dbs(table):
    """The same table in a JAX ToolsDatabase and in the port's copy."""
    n = table.shape[0]
    jdb = JaxToolsDatabase(
        [JaxToolRecord(i, f"t{i}", np.zeros(1, np.int64), 0) for i in range(n)], table
    )
    tdb = ToolsDatabase(
        [ToolRecord(i, f"t{i}", np.zeros(1, np.int64), 0) for i in range(n)], table
    )
    return jdb, tdb


def _jax_topk(q, t, k, mask=None):
    s, i = jax_topk_dense(
        jnp.asarray(q), jnp.asarray(t), k, None if mask is None else jnp.asarray(mask)
    )
    return np.asarray(s), np.asarray(i)


def _torch_topk(q, t, k, mask=None):
    s, i = topk_dense(
        torch.from_numpy(q), torch.from_numpy(t), k,
        None if mask is None else torch.from_numpy(mask),
    )
    return s.numpy(), i.numpy()


def _assert_same(a, b, atol=1e-5):
    np.testing.assert_allclose(a[0], b[0], atol=atol)
    np.testing.assert_array_equal(a[1], b[1])


# ------------------------------------------------------------- topk_dense
@pytest.mark.parametrize("k", [1, 5, 17])
def test_topk_dense_masks_with_short_rows(k):
    """Masks that admit fewer than k candidates: the unfilled slots carry
    NEG_INF and tie toward the lowest index in both packages."""
    rng = np.random.default_rng(k)
    q = _unit(rng.normal(size=(9, 64))).astype(np.float32)
    t = _unit(rng.normal(size=(40, 64))).astype(np.float32)
    mask = (rng.random((9, 40)) < 0.15).astype(np.float32)
    mask[0] = 0.0  # a row with no candidate at all
    mask[1, :] = 0.0
    mask[1, 7] = 1.0  # exactly one candidate
    jx, tr = _jax_topk(q, t, k, mask), _torch_topk(q, t, k, mask)
    _assert_same(jx, tr)
    n_allowed = mask.sum(axis=1).astype(int)
    for row in range(9):
        filled = min(k, n_allowed[row])
        assert (tr[0][row, :filled] > NEG_INF / 2).all()
        assert (tr[0][row, filled:] == np.float32(NEG_INF)).all()
        assert set(tr[1][row, :filled]) <= set(np.flatnonzero(mask[row]))


@pytest.mark.parametrize("n_real", [1, 3, 5, 13])
def test_topk_dense_with_gateway_zero_pad_rows(scaled, n_real):
    """The gateway pads its miss block with zero queries up to a power of
    two; every pad row scores 0 everywhere and must rank identically."""
    from repro_torch.common.bucketing import pad_amount

    table, queries = scaled
    q = queries[:n_real]
    q = np.concatenate([q, np.zeros((pad_amount(n_real), q.shape[1]), np.float32)])
    _assert_same(_jax_topk(q, table, 25), _torch_topk(q, table, 25))
    mask = np.ones((q.shape[0], table.shape[0]), np.float32)
    mask[: n_real, 1::2] = 0.0
    _assert_same(_jax_topk(q, table, 25, mask), _torch_topk(q, table, 25, mask))


def test_rank_dense_and_k_bounds(scaled):
    table, queries = scaled
    np.testing.assert_array_equal(
        rank_dense(queries, table, 5, device=CPU), _jax_topk(queries, table, 5)[1]
    )
    with pytest.raises(ValueError):
        topk_dense(torch.zeros(2, 4), torch.zeros(3, 4), 4)


# -------------------------------------------------------------- backends
def test_registry_and_protocol(scaled):
    table, queries = scaled
    assert set(BACKENDS) == {"dense", "fused", "ivf"}
    for kind in BACKENDS:
        b = build_backend(kind, table, table_version=7, device=CPU)
        assert isinstance(b, ScorerBackend)
        assert b.name == kind and b.table_version == 7 and b.n_tools == SCALED_T
        scores, idx = b.topk(queries, 5)
        assert scores.shape == (len(queries), 5) and idx.shape == (len(queries), 5)
        assert (np.diff(scores, axis=1) <= 0).all()
        empty_s, empty_i = b.topk(queries[:0], 5)  # contract: any Q, even 0
        assert empty_s.shape == (0, 5) and empty_i.shape == (0, 5)
    with pytest.raises(ValueError):
        build_backend("flat", table, table_version=0, device=CPU)


@pytest.mark.parametrize("k", [5, 25])
def test_dense_and_fused_identical_and_match_jax(scaled, k):
    """Both port backends are exact: identical top-K to each other and to
    the JAX DenseBackend on the same table and queries."""
    table, queries = scaled
    ref = JaxDenseBackend(table, 0).topk(queries, k)
    dense = DenseBackend(table, 0, device=CPU).topk(queries, k)
    fused = FusedBackend(table, 0, device=CPU).topk(queries, k)
    _assert_same(ref, dense)
    _assert_same(ref, fused)
    np.testing.assert_array_equal(dense[1], fused[1])
    np.testing.assert_array_equal(dense[0], fused[0])


def test_fused_backend_refuses_masks(scaled):
    table, queries = scaled
    with pytest.raises(ValueError):
        FusedBackend(table, 0, device=CPU).topk(
            queries[:2], 5, np.ones((2, SCALED_T), np.float32)
        )


# --------------------------------------------------------------- manager
@pytest.mark.parametrize("kind", ["dense", "fused"])
def test_manager_masked_batches_go_exact(scaled, kind):
    table, queries = scaled
    jdb, tdb = _dbs(table)
    jman = JaxToolIndexManager(jdb, backend="dense", async_rebuild=False, metrics=False)
    tman = ToolIndexManager(tdb, backend=kind, metrics=False, device=CPU)
    mask = (np.random.default_rng(3).random((8, SCALED_T)) < 0.01).astype(np.float32)
    js, ji, jv = jman.topk(queries[:8], 5, mask)
    ts, ti, tv = tman.topk(queries[:8], 5, mask)
    _assert_same((js, ji), (ts, ti))
    assert jv == tv == 0
    expected = "index:dense" if kind == "dense" else "exact"
    assert tman.last_path() == expected
    ts, ti, _ = tman.topk(queries[:8], 5)
    assert tman.last_path() == f"index:{kind}"
    _assert_same(jman.topk(queries[:8], 5)[:2], (ts, ti))
    if kind == "fused":
        assert tman.stats["served_exact"] == 1 and tman.stats["served_index"] == 1


def test_manager_rebuilds_inline_on_cas_swap(scaled):
    """A CAS swap fires the listener, which rebuilds the cheap fused index
    inline: the next batch is served by the index at the new version, with
    the scores of the new table."""
    table, queries = scaled
    jdb, tdb = _dbs(table)
    jman = JaxToolIndexManager(jdb, backend="pallas", async_rebuild=False, metrics=False)
    tman = ToolIndexManager(tdb, backend="fused", metrics=False, device=CPU)
    assert tman.wait_ready() and tman.stats["rebuilds"] == 1
    moved = table[np.random.default_rng(0).permutation(SCALED_T)]
    with pytest.raises(ConflictError):
        tdb.swap_table(moved, expect_current=5)
    for db in (jdb, tdb):
        db.swap_table(moved, expect_current=0)
    assert tman.is_fresh() and tman.stats["rebuilds"] == 2
    js, ji, jv = jman.topk(queries, 5)
    ts, ti, tv = tman.topk(queries, 5)
    assert jv == tv == 1
    assert tman.last_path() == "index:fused"
    _assert_same((js, ji), (ts, ti))
    np.testing.assert_allclose(
        ts, np.take_along_axis(queries @ moved.T, ti, axis=1), atol=1e-5
    )
    tdb.rollback(expect_current=1)
    assert tman.is_fresh()
    assert tman.topk(queries, 5)[2] == 2


def test_manager_stale_index_serves_exact_then_recovers(scaled):
    table, queries = scaled
    _, tdb = _dbs(table)
    tman = ToolIndexManager(tdb, backend="fused", watch_swaps=False, metrics=False,
                            device=CPU)
    tdb.swap_table(table[::-1].copy(), expect_current=0)
    # no listener: the serving call notices the stale index and rebuilds
    # inline (cheap build), so the batch is still served by the index
    s, i, v = tman.topk(queries[:4], 5)
    assert v == 1 and tman.last_path() == "index:fused"
    np.testing.assert_allclose(
        s, np.take_along_axis(queries[:4] @ table[::-1].T, i, axis=1), atol=1e-5
    )
    tman.close()
    tman.close()


@pytest.mark.parametrize("kind", ["dense", "fused"])
def test_manager_failed_build_raises(scaled, kind, monkeypatch):
    """A failed build is counted and raised, at construction and when a
    serving call finds the index stale; no batch moves to the exact path."""
    import repro_torch.index as index_pkg

    table, queries = scaled
    _, tdb = _dbs(table)
    tman = ToolIndexManager(tdb, backend=kind, metrics=False, device=CPU)

    def broken(*args, **kwargs):
        raise MemoryError("upload failed")

    monkeypatch.setattr(index_pkg, "build_backend", broken)
    tdb.swap_table(table[::-1].copy(), expect_current=0)  # listener fails quietly
    assert tman.stats["build_failures"] == 1 and not tman.is_fresh()
    with pytest.raises(MemoryError):
        tman.topk(queries[:4], 5)
    assert tman.stats["build_failures"] == 2
    assert tman.stats["served_exact"] == 0 and tman.last_path() == "unknown"
    with pytest.raises(MemoryError):
        ToolIndexManager(tdb, backend=kind, metrics=False, device=CPU)
    monkeypatch.undo()
    assert tman.wait_ready() and tman.topk(queries[:4], 5)[2] == 1
    assert tman.last_path() == f"index:{kind}"


# ------------------------------------------------------------ quantization
@pytest.mark.parametrize("shape,dtype", [
    ((3000, 384), np.float32), ((2, 96, 64), np.float32), ((64, 64), "bfloat16"),
    ((40, 384), np.float32), ((128, 32), np.float32), ((7,), np.float32)])
def test_quantize_tree_is_bitwise_the_jax_packages(shape, dtype):
    """Codes equal exactly, scales equal as bf16, pass-through leaves
    untouched, and dequantization equal, on one tree in both packages."""
    import jax.numpy as jnp

    from repro.models.quant import dequantize_tree as jax_dequantize
    from repro.models.quant import quantize_tree as jax_quantize
    from repro.models.quant import should_quantize as jax_should
    from repro_torch import convert
    from repro_torch.models.quant import dequantize_tree, quantize_tree, should_quantize

    rng = np.random.default_rng(len(shape) * 7 + shape[-1])
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 3.0, size=shape[-1:])).astype(np.float32)
    w.flat[::97] = 0.0  # zero entries and, below, an all-zero channel
    if len(shape) >= 2:
        w[..., 0] = 0.0
    jw = jnp.asarray(w, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tree = {"a": {"w": jw}, "b": jnp.asarray(w[..., :3])}
    jq = jax_quantize(tree)
    tq = quantize_tree(convert.params_from_jax({"a": {"w": np.asarray(jw)},
                                                "b": np.asarray(tree["b"])}, CPU))
    assert should_quantize(shape) == jax_should(shape)
    if should_quantize(shape):
        assert tq["a"]["w"]["q"].dtype == torch.int8
        assert tq["a"]["w"]["scale"].dtype == torch.bfloat16
        np.testing.assert_array_equal(tq["a"]["w"]["q"].numpy(), np.asarray(jq["a"]["w"]["q"]))
        np.testing.assert_array_equal(
            tq["a"]["w"]["scale"].view(torch.int16).numpy(),
            np.asarray(jq["a"]["w"]["scale"]).view(np.int16))
    else:
        assert torch.equal(tq["a"]["w"], convert.params_from_jax(np.asarray(jw), CPU))
    back = dequantize_tree(tq, dtype=torch.float32)
    jback = jax_dequantize(jq, dtype=jnp.float32)
    np.testing.assert_array_equal(back["a"]["w"].numpy(), np.asarray(jback["a"]["w"]))
    np.testing.assert_array_equal(back["b"].numpy(), np.asarray(jback["b"]))


# --------------------------------------------------------------------- IVF
def _recall(exact, approx):
    return float(np.mean([len(set(exact[j]) & set(approx[j])) / exact.shape[1]
                          for j in range(len(exact))]))


def _assignment(backend):
    """Each table row's cluster, from the CSR layout."""
    member_ids = np.asarray(backend.member_ids.cpu() if torch.is_tensor(backend.member_ids)
                            else backend.member_ids)
    offsets = np.asarray(backend.offsets.cpu() if torch.is_tensor(backend.offsets)
                         else backend.offsets)
    out = np.empty(len(member_ids), np.int64)
    for c in range(len(offsets) - 1):
        out[member_ids[offsets[c]:offsets[c + 1]]] = c
    return out


def _moved(table, seed):
    rng = np.random.default_rng(seed)
    moved = table + 1e-3 * rng.standard_normal(table.shape).astype(np.float32)
    return moved / np.maximum(np.linalg.norm(moved, axis=-1, keepdims=True), 1e-9)


@pytest.fixture(scope="module")
def ivf_pair(scaled):
    """The JAX package's IVF and the port's over one table (default config)."""
    table, _ = scaled
    return JaxIVFBackend(table, 0), IVFBackend(table, 0, device=CPU)


def test_ivf_build_matches_jax(scaled, ivf_pair):
    """The same host draws seed the same k-means: equal iterations,
    centroids within 1e-6, assignments equal on >= 99.9% of rows."""
    table, _ = scaled
    jivf, tivf = ivf_pair
    assert tivf.n_clusters == jivf.n_clusters
    assert tivf.kmeans_iters_run == jivf.kmeans_iters_run
    np.testing.assert_allclose(tivf.centroids.numpy(), jivf.centroids, atol=1e-6, rtol=0)
    assert np.mean(_assignment(tivf) == _assignment(jivf)) >= 0.999
    assert tivf.member_ids.dtype == torch.int64
    assert tivf._max_cluster == jivf._max_cluster


def test_ivf_recall_floor_at_default_nprobe(scaled, ivf_pair):
    """Recall@5 >= 0.98 against exact at the default nprobe and within
    0.005 of the JAX IVF's; top-5 equal to the JAX IVF's on >= 99% of
    queries, scores within 1e-5 where they agree; the scores returned are
    exact similarities of the indexed table."""
    table, queries = scaled
    jivf, tivf = ivf_pair
    _, exact = DenseBackend(table, 0, device=CPU).topk(queries, 5)
    scores, approx = tivf.topk(queries, 5)
    js, ji = jivf.topk(queries, 5)
    recall, jrecall = _recall(exact, approx), _recall(exact, ji)
    assert recall >= 0.98, f"IVF recall@5 {recall:.4f} below floor"
    assert abs(recall - jrecall) <= 0.005
    same = (approx == ji).all(axis=1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(scores[same], js[same], atol=1e-5, rtol=0)
    assert approx.dtype == np.int64 and scores.dtype == np.float32
    for j in range(0, len(queries), 7):
        np.testing.assert_allclose(scores[j], table[approx[j]] @ queries[j], atol=1e-5)
    assert (np.diff(scores, axis=1) <= 0).all()


def test_ivf_rejects_masks_and_tiny_tables_work(scaled):
    table, queries = scaled
    ivf = IVFBackend(table, 0, device=CPU)
    with pytest.raises(AssertionError):
        ivf.topk(queries, 5, candidate_mask=np.ones((len(queries), SCALED_T)))
    # below the quantizer's size floor: float32 codes, still correct
    tiny = table[:40]
    _, exact = DenseBackend(tiny, 0, device=CPU).topk(queries, 5)
    tiny_ivf = IVFBackend(tiny, 0, IVFConfig(nprobe=10), device=CPU)
    assert tiny_ivf._codes.dtype == torch.float32
    _, approx = tiny_ivf.topk(queries, 5)
    assert _recall(exact, approx) >= 0.98
    # fewer reachable candidates than k: the tail pads NEG_INF with index 0
    s, i = IVFBackend(table[:12], 0, device=CPU).topk(queries[:3], 20)
    assert (s[:, 12:] == np.float32(NEG_INF)).all() and (i[:, 12:] == 0).all()
    assert (s[:, :12] > NEG_INF / 2).all()
    np.testing.assert_array_equal(np.sort(i[:, :12], axis=1), np.tile(np.arange(12), (3, 1)))


def test_ivf_shortlist_quota_extends_probes_like_jax(scaled):
    """A skewed config (many clusters, one probe, k = 25): queries whose
    probed cluster holds fewer rows than the shortlist extend their probes
    in coarse order, as the reference does."""
    table, queries = scaled
    cfg = dict(n_clusters=700, nprobe=1, rerank_multiplier=2)
    jivf = JaxIVFBackend(table, 0, JaxIVFConfig(**cfg))
    tivf = IVFBackend(table, 0, IVFConfig(**cfg), device=CPU)
    js, ji = jivf.topk(queries, 25)
    ts, ti = tivf.topk(queries, 25)
    assert _recall(ji, ti) >= 0.99
    same = (ji == ti).all(axis=1)
    np.testing.assert_allclose(ts[same], js[same], atol=1e-5, rtol=0)


def test_ivf_warm_start_converges_faster_with_recall_parity(scaled, ivf_pair):
    """Seeding k-means from the previous index's centroids on a gently moved
    table cuts iterations, as in the JAX package (equal counts, cold and
    warm), with recall parity against a cold build."""
    table, queries = scaled
    jcold, cold = ivf_pair
    moved = _moved(table, 1)
    warm = IVFBackend(moved, 1, warm_start=cold.warm_start_state(), device=CPU)
    cold2 = IVFBackend(moved, 1, device=CPU)
    jwarm = JaxIVFBackend(moved, 1, warm_start=jcold.warm_start_state())
    assert (warm.kmeans_iters_run, cold2.kmeans_iters_run) == (
        jwarm.kmeans_iters_run, JaxIVFBackend(moved, 1).kmeans_iters_run)
    assert warm.kmeans_iters_run < cold2.kmeans_iters_run
    assert warm.kmeans_iters_run == 1  # seeded at the fixed point
    # a numpy warm start (the JAX package's centroids) is taken as well
    assert IVFBackend(moved, 1, warm_start=jcold.warm_start_state(),
                      device=CPU).kmeans_iters_run == 1
    _, exact = DenseBackend(moved, 1, device=CPU).topk(queries, 5)
    r_warm, r_cold = _recall(exact, warm.topk(queries, 5)[1]), _recall(
        exact, cold2.topk(queries, 5)[1])
    assert r_warm >= 0.98 and r_warm >= r_cold - 0.02
    # an incompatible warm start is ignored: the cold path, deterministic
    bad = IVFBackend(moved, 2, warm_start=cold.centroids[:3], device=CPU)
    assert bad.kmeans_iters_run == cold2.kmeans_iters_run
    assert torch.equal(bad.centroids, cold2.centroids)


def _router_db(table):
    n = table.shape[0]
    return ToolsDatabase([ToolRecord(i, f"t{i}", np.arange(2), 0) for i in range(n)], table)


def test_manager_passes_warm_start_across_swap_rebuilds(scaled):
    table, queries = scaled
    db = _router_db(table)
    manager = ToolIndexManager(db, backend="ivf", async_rebuild=False, metrics=False,
                               device=CPU)
    assert manager.wait_ready()
    first = manager._backend
    moved = _moved(table, 2)
    db.swap_table(moved, expect_current=0)  # synchronous listener: rebuilt inline
    assert manager.is_fresh()
    rebuilt = manager._backend
    assert rebuilt.table_version == db.table_version
    assert rebuilt.kmeans_iters_run < first.kmeans_iters_run
    scores, idx, version = manager.topk(queries, 5)
    assert version == db.table_version and manager.last_path() == "index:ivf"
    _, exact = DenseBackend(moved, version, device=CPU).topk(queries, 5)
    assert _recall(exact, idx) >= 0.98
    manager.close()


def test_route_result_fields_consistent_across_backends(small_bench):
    """Every backend's RouteResult carries the same fields; the exact
    backends agree on the ranking; IVF reaches the recall floor."""
    from repro_torch.embedding.bag_encoder import BagEncoder
    from repro_torch.router.gateway import SemanticRouter

    expected = {"tools", "scores", "latency_ms", "pool", "table_version", "stage_version",
                "cache_hit"}
    per_backend = {}
    enc = BagEncoder(small_bench.vocab, device=CPU)
    for kind in BACKENDS:
        db = _router_db(enc.encode(small_bench.desc_tokens))
        router = SemanticRouter(
            db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5, device=CPU,
            index=ToolIndexManager(db, backend=kind, async_rebuild=False, device=CPU))
        results = router.route_batch(small_bench.query_tokens[:12])
        for r in results:
            assert {f.name for f in dataclasses.fields(r)} == expected
            assert r.table_version == db.table_version
            assert r.scores == sorted(r.scores, reverse=True)
            assert len(r.tools) == len(r.scores) == 5
        per_backend[kind] = results
        assert router.index.stats["served_index"] >= 1
    for a, b in zip(per_backend["dense"], per_backend["fused"]):
        assert a.tools == b.tools
    hits = [len(set(a.tools) & set(b.tools)) for a, b in zip(per_backend["dense"],
                                                             per_backend["ivf"])]
    assert np.mean(hits) / 5 >= 0.98


def test_ivf_masked_batches_fall_back_to_exact(small_bench):
    from repro_torch.embedding.bag_encoder import BagEncoder
    from repro_torch.router.gateway import SemanticRouter

    enc = BagEncoder(small_bench.vocab, device=CPU)
    db = _router_db(enc.encode(small_bench.desc_tokens))
    manager = ToolIndexManager(db, backend="ivf", async_rebuild=False, device=CPU)
    router = SemanticRouter(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                            index=manager, device=CPU)
    mask = small_bench.candidate_mask()[:4]
    results = router.route_batch(small_bench.query_tokens[:4], candidate_masks=mask)
    assert manager.stats["served_exact"] >= 1 and manager.last_path() == "exact"
    for j, r in enumerate(results):
        assert set(r.tools) <= set(np.flatnonzero(mask[j]).tolist())


def test_swap_serves_exact_fallback_then_rebuilds(scaled):
    """A live swap during IVF serving: the stale index is bypassed for the
    exact fallback on the new snapshot, and the background rebuild
    restores index serving."""
    table, queries = scaled
    db = _router_db(table)
    # watch_swaps=False: the serving call itself must notice the swap
    manager = ToolIndexManager(db, backend="ivf", async_rebuild=True, watch_swaps=False,
                               device=CPU)
    assert manager.async_rebuild and manager.wait_ready(60.0)
    _, _, v0 = manager.topk(queries[:8], 5)
    assert v0 == 0 and manager.last_path() == "index:ivf"
    perm = np.random.default_rng(0).permutation(SCALED_T)
    db.swap_table(table[perm], expect_current=0)
    assert not manager.is_fresh()
    exact_before = manager.stats["served_exact"]
    s1, i1, v1 = manager.topk(queries[:8], 5)  # index stale -> exact + a background build
    assert v1 == 1 and manager.last_path() == "exact"
    assert manager.stats["served_exact"] == exact_before + 1
    _, want = DenseBackend(table[perm], 1, device=CPU).topk(queries[:8], 5)
    np.testing.assert_array_equal(i1, want)
    np.testing.assert_allclose(s1, np.take_along_axis(queries[:8] @ table[perm].T, i1, 1),
                               atol=1e-5)
    assert manager.wait_ready(120.0), "background rebuild never landed"
    served = manager.stats["served_index"]
    _, _, v2 = manager.topk(queries[:8], 5)
    assert v2 == 1 and manager.last_path() == "index:ivf"
    assert manager.stats["served_index"] == served + 1 and manager.stats["rebuilds"] >= 2
    assert not [t for t in threading.enumerate() if t.name.startswith("index-rebuild")]


def test_swap_listener_triggers_rebuild_and_reports_version(scaled):
    """The database listener rebuilds the IVF index on swap AND rollback;
    every batch's scores stay self-consistent with the version it reports
    while swaps land concurrently."""
    table, queries = scaled
    db = _router_db(table)
    manager = ToolIndexManager(
        db, backend="ivf", async_rebuild=False, device=CPU,
        backend_opts={"config": IVFConfig(kmeans_iters=2, train_sample=1500)})
    tables = {0: table}
    rng = np.random.default_rng(1)
    stop = threading.Event()
    errors = []

    def churn():
        try:
            while not stop.is_set():
                new = table[rng.permutation(SCALED_T)]
                tables[db.table_version + 1] = new  # only this thread swaps
                db.swap_table(new, expect_current=db.table_version)
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    thread = threading.Thread(target=churn, daemon=True)
    thread.start()
    try:
        for _ in range(6):
            s, i, v = manager.topk(queries[:6], 5)
            np.testing.assert_allclose(s, np.take_along_axis(queries[:6] @ tables[v].T, i, 1),
                                       atol=1e-4)
    finally:
        stop.set()
        thread.join()
    assert not errors
    db.rollback(expect_current=db.table_version)  # also fires the listener
    assert manager.is_fresh()


def test_close_unregisters_swap_listener(scaled):
    table, queries = scaled
    db = _router_db(table)
    manager = ToolIndexManager(db, backend="ivf", async_rebuild=False, device=CPU,
                               backend_opts={"config": IVFConfig(kmeans_iters=2)})
    before = manager.stats["rebuilds"]
    db.swap_table(np.roll(db.embeddings, 1, axis=0), expect_current=0)
    assert manager.stats["rebuilds"] == before + 1
    manager.close()
    manager.close()  # idempotent
    db.swap_table(np.roll(db.embeddings, 2, axis=0), expect_current=1)
    assert manager.stats["rebuilds"] == before + 1 and not manager.is_fresh()
    # a closed manager still serves the live version (exact, then rebuilt)
    assert manager.topk(queries[:2], 5)[2] == db.table_version


def test_misconfigured_backend_opts_fail_fast(scaled):
    table, _ = scaled
    with pytest.raises(TypeError):
        # IVFBackend takes config=IVFConfig(...), not raw kwargs
        ToolIndexManager(_router_db(table), backend="ivf", backend_opts={"nprobe": 16},
                         device=CPU)


def test_build_failure_keeps_fallback_serving(scaled):
    table, queries = scaled
    db = _router_db(table)
    manager = ToolIndexManager(db, backend="ivf", async_rebuild=False, device=CPU,
                               backend_opts={"config": IVFConfig(kmeans_iters=-1)})
    assert manager.wait_ready() and manager._backend.kmeans_iters_run == 0
    manager.backend_opts = {"config": "not-a-config"}  # a genuinely broken build next
    db.swap_table(np.roll(db.embeddings, 1, axis=0), expect_current=0)
    assert manager.stats["build_failures"] == 1
    assert manager.wait_ready(1.0) is False  # doomed: no retry in flight
    scores, idx, version = manager.topk(queries[:3], 5)
    assert version == db.table_version and idx.shape == (3, 5)
    assert manager.stats["served_exact"] >= 1 and manager.last_path() == "exact"
    assert manager.stats["build_failures"] == 1  # no doomed rebuild per serving call
