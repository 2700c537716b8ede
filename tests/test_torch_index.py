"""Parity of the port's retrieval core and index layer with the JAX reference.

`topk_dense` (masks, short rows, zero pad queries), the dense and fused
backends (the fused one serves its plain version on CPU tensors), and the
`ToolIndexManager` lifecycle: masked batches to the exact path, inline
rebuild on a CAS swap, `last_path`. Inputs are made once with numpy from a
seed and given to both packages. Indices must be exactly equal, scores
within atol=1e-5 (the top-K tolerance of `tests/test_kernels.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.retrieval import topk_dense as jax_topk_dense
from repro.data.benchmarks import scale_tool_corpus
from repro.embedding.bag_encoder import BagEncoder as JaxBagEncoder
from repro.index import DenseBackend as JaxDenseBackend
from repro.index import ToolIndexManager as JaxToolIndexManager
from repro.router.tooldb import ToolRecord as JaxToolRecord
from repro.router.tooldb import ToolsDatabase as JaxToolsDatabase
from repro_torch.core.retrieval import NEG_INF, rank_dense, topk_dense
from repro_torch.index import (
    BACKENDS,
    DenseBackend,
    FusedBackend,
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
    assert set(BACKENDS) == {"dense", "fused"}
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
