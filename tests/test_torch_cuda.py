"""The port's hand-written CUDA kernels against their plain versions, on
the card, and the training path there (gradients against the CPU's; the
kernels' refusal of grad-requiring inputs). Every test here is marked
`cuda` and skips without a card.

This file imports neither JAX nor `repro`, so it runs on a machine that has
only the port's dependencies. There, run it without the suite's conftest
(which builds a JAX benchmark fixture):

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import functools
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import scenarios
from repro_torch.data.benchmarks import scale_tool_corpus
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rope_heads import kernel as rope_kernel
from repro_torch.kernels.rope_heads.ops import rope_heads
from repro_torch.kernels.rope_heads.ref import rope_heads_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.kernels.topk_sim import kernel as topk_kernel
from repro_torch.kernels.topk_sim.ops import topk_sim
from repro_torch.kernels.topk_sim.ref import topk_sim_ref
from repro_torch.optim.base import tree_map

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    return torch.device("cuda")


def _unit_rows(rng, n, d, device):
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy(x).to(device)


def _assert_cluster_ranking(q, t, ks, ki, rs, ri):
    """Scores within 1e-5 of the plain version; indices equal to its own
    except between rows whose float64 similarities are within 1e-6 of each
    other: the cluster kernel sums each product over a tree of lanes and
    cuBLAS in its own order, so float32 near-ties may fall either way."""
    torch.testing.assert_close(ks, rs, atol=1e-5, rtol=0)
    exact = q.double() @ t.double().T
    differ = ki != ri
    gap = (exact.gather(1, ki) - exact.gather(1, ri)).abs()
    assert bool((gap[differ] < 1e-6).all()), gap[differ].max()
    assert all(len(set(row)) == len(row) for row in ki.tolist())


@pytest.mark.parametrize(
    "q,t,d,k",
    [(1, 2413, 384, 5), (8, 2413, 384, 25), (33, 5003, 384, 25), (7, 199, 384, 5),
     (33, 513, 256, 3), (5, 300, 64, 128), (130, 777, 100, 1), (2, 1, 8, 1)],
)
def test_topk_sim_kernel_matches_plain(cuda_device, q, t, d, k):
    rng = np.random.default_rng(q * 7919 + t)
    qt, tt = _unit_rows(rng, q, d, cuda_device), _unit_rows(rng, t, d, cuda_device)
    route = topk_kernel.topk_route(q, t, d, k, tt, qt)
    before, before_route = topk_kernel.launches, topk_kernel.launches_by_route[route]
    ks, ki = topk_sim(qt, tt, k)
    torch.cuda.synchronize()
    n_launch = 1 if route == "cluster" else 2  # one cluster launch, or pass 1 and pass 2
    assert topk_kernel.launches == before + n_launch
    assert topk_kernel.launches_by_route[route] == before_route + n_launch
    rs, ri = topk_sim_ref(qt, tt, k)
    torch.testing.assert_close(ks, rs, atol=1e-5, rtol=0)
    assert torch.equal(ki, ri)
    if route == "cluster":  # the same inputs on the split route
        ss, si = topk_kernel.topk_sim_cuda(qt, tt, k, route="split")
        torch.testing.assert_close(ss, rs, atol=1e-5, rtol=0)
        assert torch.equal(si, ri)


@pytest.mark.parametrize("k", [5, 25, 128])
@pytest.mark.parametrize("t", [300, 2047, 2413, topk_kernel.CLUSTER_MAX_T])
@pytest.mark.parametrize("q", [1, 8, 33, 64])
def test_topk_sim_cluster_route_matches_plain(cuda_device, q, t, k):
    """Small tables take the one-launch cluster route, which agrees with the
    plain version as `_assert_cluster_ranking` says."""
    rng = np.random.default_rng(q * 131 + t + k)
    qt, tt = _unit_rows(rng, q, 384, cuda_device), _unit_rows(rng, t, 384, cuda_device)
    assert topk_kernel.topk_route(q, t, 384, k, tt, qt) == "cluster"
    before = dict(topk_kernel.launches_by_route)
    ks, ki = topk_sim(qt, tt, k)
    torch.cuda.synchronize()
    assert topk_kernel.launches_by_route == {**before, "cluster": before["cluster"] + 1}
    rs, ri = topk_sim_ref(qt, tt, k)
    _assert_cluster_ranking(qt, tt, ks, ki, rs, ri)


@pytest.mark.parametrize("route,k", [("cluster", 8), ("cluster", 128), ("split", 8),
                                     ("split", 128), ("wgmma", 8),
                                     ("wgmma", topk_kernel.WGMMA_MAX_K), ("select", 8),
                                     ("select", 129), ("select", 600)])
def test_topk_sim_routes_break_ties_at_every_boundary(cuda_device, route, k):
    """One-hot rows tiled past CLUSTER_MAX_T so bitwise ties cross every
    chunk, tile, slice and cluster boundary of each route: lowest index first."""
    base = torch.zeros((9, 128), device=cuda_device)
    base[torch.arange(9), torch.arange(9)] = 1.0
    table = base.repeat(topk_kernel.CLUSTER_MAX_T // 9 + 2, 1).contiguous()
    assert table.shape[0] > topk_kernel.CLUSTER_MAX_T
    q = _unit_rows(np.random.default_rng(2), 40, 128, cuda_device)
    ks, ki = topk_kernel.topk_sim_cuda(q, table, k, route=route)
    rs, ri = topk_sim_ref(q, table, k)
    torch.testing.assert_close(ks, rs, atol=1e-6, rtol=0)
    best = q[:, :9].argmax(dim=1)
    assert torch.equal(ki, best[:, None] + 9 * torch.arange(k, device=cuda_device)[None, :])


@pytest.mark.parametrize("q,t,d,k", [
    (8, 2413, 384, 129), (64, 2413, 384, 130), (5, 300, 384, 300), (3, 9000, 64, 9000),
    (33, 5003, 1025, 5), (8, 2413, 1536, 25), (2, 100_003, 384, 130), (1, 1, 1100, 1),
])
def test_topk_sim_select_route_matches_plain(cuda_device, q, t, d, k):
    """k above 128 (the re-ranker's C = 5k at k >= 26), k = T (9,000 sorts
    in the scratch, past the 4,096 keys of shared memory) and D above 1,024
    take the select route, two launches, whose ranking is the plain
    version's (scores within 1e-5; indices as `_assert_cluster_ranking`
    says: its FMA chain and cuBLAS may order float32 near-ties apart)."""
    rng = np.random.default_rng(q * 7 + t + d)
    qt, tt = _unit_rows(rng, q, d, cuda_device), _unit_rows(rng, t, d, cuda_device)
    assert topk_kernel.topk_route(q, t, d, k, tt, qt) == "select"
    assert not topk_kernel.can_take("split", qt, tt, k)
    before = dict(topk_kernel.launches_by_route)
    ks, ki = topk_sim(qt, tt, k)
    torch.cuda.synchronize()
    assert topk_kernel.launches_by_route == {**before, "select": before["select"] + 2}
    assert bool((ks[:, :-1] >= ks[:, 1:]).all())
    rs, ri = topk_sim_ref(qt, tt, k)
    _assert_cluster_ranking(qt, tt, ks, ki, rs, ri)


@pytest.mark.parametrize("q,t,k", [(8, 2413, 25), (64, 2413, 128), (33, 100_003, 5)])
def test_topk_sim_select_route_is_bitwise_the_split_route(cuda_device, q, t, k):
    """Forced where the split route can run too, the select route returns
    its bits: the same FMA chain and the same keys."""
    rng = np.random.default_rng(t + k)
    qt, tt = _unit_rows(rng, q, 384, cuda_device), _unit_rows(rng, t, 384, cuda_device)
    ss, si = topk_kernel.topk_sim_cuda(qt, tt, k, route="split")
    xs, xi = topk_kernel.topk_sim_cuda(qt, tt, k, route="select")
    assert torch.equal(xs, ss) and torch.equal(xi, si)


def test_topk_sim_select_route_ties_in_the_scratch_sort(cuda_device):
    """One-hot rows tiled 5,000 times and k = 4,500: the sort runs in the
    global scratch (past 4,096 keys) and still puts ties lowest index first."""
    base = torch.zeros((9, 128), device=cuda_device)
    base[torch.arange(9), torch.arange(9)] = 1.0
    table = base.repeat(5000, 1).contiguous()
    q = _unit_rows(np.random.default_rng(3), 4, 128, cuda_device)
    k = 4500
    assert topk_kernel.select_sort_len(k) > topk_kernel.SEL_SMEM_KEYS
    ks, ki = topk_sim(q, table, k)
    best = q[:, :9].argmax(dim=1)
    assert torch.equal(ki, best[:, None] + 9 * torch.arange(k, device=cuda_device)[None, :])
    torch.testing.assert_close(ks, q.gather(1, best[:, None]).expand(-1, k), atol=1e-6, rtol=0)


@pytest.mark.parametrize("q,t,d,k", [(1, 100_003, 384, 130), (8, 100_003, 384, 130),
                                     (2, 1_000_003, 8, 130)])
def test_topk_sim_select_route_cluster_split(cuda_device, q, t, d, k):
    """The select route's pass 2 over a 16-block cluster a query (one query
    and eight over 100,003 rows), and over more keys than the cluster's
    shared memory holds (1,000,003 rows: each block streams the rest of its
    slice from the scratch in every pass): the plain version's ranking, as
    `_assert_cluster_ranking` says."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = topk_kernel.select_plan(q, t, d, k, n_sms)
    assert plan.cs == topk_kernel.SEL_MAX_CS
    assert (plan.cs * plan.cap < t) == (t > 1_000_000)
    rng = np.random.default_rng(q + t)
    qt, tt = _unit_rows(rng, q, d, cuda_device), _unit_rows(rng, t, d, cuda_device)
    before = dict(topk_kernel.launches_by_route)
    ks, ki = topk_sim(qt, tt, k)
    torch.cuda.synchronize()
    assert topk_kernel.launches_by_route == {**before, "select": before["select"] + 2}
    rs, ri = topk_sim_ref(qt, tt, k)
    _assert_cluster_ranking(qt, tt, ks, ki, rs, ri)


def test_topk_sim_select_route_plain_loads(cuda_device):
    """D = 130 on a table base off a 16-byte boundary: pass 1 stages its
    chunks by 4-byte cp.async, zero-filled past D, in place of bulk copies.
    At k = 200 it agrees with the plain version; forced at k = 25 it returns
    the split route's bits."""
    rng = np.random.default_rng(130)
    flat = torch.empty(2413 * 130 + 1, device=cuda_device)
    tt = flat[1:].view(2413, 130)
    tt.copy_(_unit_rows(rng, 2413, 130, cuda_device))
    assert tt.data_ptr() % 16 != 0
    qt = _unit_rows(rng, 8, 130, cuda_device)
    ks, ki = topk_sim(qt, tt, 200)
    rs, ri = topk_sim_ref(qt, tt, 200)
    _assert_cluster_ranking(qt, tt, ks, ki, rs, ri)
    ss, si = topk_kernel.topk_sim_cuda(qt, tt, 25, route="split")
    xs, xi = topk_kernel.topk_sim_cuda(qt, tt, 25, route="select")
    assert torch.equal(xs, ss) and torch.equal(xi, si)


def test_topk_sim_select_route_all_zero_query(cuda_device):
    """An all-zero query scores 0 against every row: every key ties at the
    threshold, and the k = 300 lowest rows come out in order."""
    rng = np.random.default_rng(0)
    tt = _unit_rows(rng, 2413, 384, cuda_device)
    qt = torch.cat([torch.zeros((1, 384), device=cuda_device),
                    _unit_rows(rng, 3, 384, cuda_device)]).contiguous()
    ks, ki = topk_sim(qt, tt, 300)
    assert torch.equal(ki[0], torch.arange(300, device=cuda_device))
    assert bool((ks[0] == 0).all())
    rs, ri = topk_sim_ref(qt, tt, 300)
    _assert_cluster_ranking(qt, tt, ks, ki, rs, ri)


def _assert_same_up_to_near_ties(idx_a, sc_a, idx_b, sc_b, tie=1e-5):
    """Ranking a equals b, scores within 1e-5, except that a may reorder
    runs of b's positions whose adjacent scores are closer than `tie` (the
    last run may take in a member from just beyond the list)."""
    np.testing.assert_allclose(sc_a, sc_b, atol=1e-5, rtol=0)
    if list(idx_a) == list(idx_b):
        return
    assert len(set(idx_a)) == len(idx_a)
    start = 0
    for p in range(1, len(idx_b) + 1):
        if p == len(idx_b) or sc_b[p - 1] - sc_b[p] >= tie:
            if p < len(idx_b):
                assert set(idx_a[start:p]) == set(idx_b[start:p]), (idx_a, idx_b)
            start = p


def test_gateway_reranks_26_over_the_fused_backend(cuda_device):
    """A SemanticRouter with the re-ranker at k = 26 asks the fused backend
    for C = 130 candidates: it serves them on the select route, without
    raising, and routes as the dense backend does (the near-tie rule of
    `_assert_cluster_ranking` on the candidates' similarities)."""
    from repro_torch.core.features import OutcomeFeaturizer
    from repro_torch.core.reranker import LAYERS
    from repro_torch.embedding.bag_encoder import BagEncoder
    from repro_torch.router.gateway import SemanticRouter
    from repro_torch.router.stages import StageSet
    from repro_torch.router.tooldb import ToolRecord, ToolsDatabase

    rng = np.random.default_rng(0)
    n_t, d, n_q = 2413, 384, 64
    words = rng.normal(size=(4000, d)).astype(np.float32)
    vocab = SimpleNamespace(word_vecs=words)
    enc = BagEncoder(vocab, device=cuda_device)
    desc = [rng.integers(0, 4000, 12) for _ in range(n_t)]
    queries = [rng.integers(0, 4000, 8) for _ in range(n_q)]
    table = enc.encode(desc)
    q_emb = enc.encode(queries)
    rel = np.zeros((n_q, n_t), np.float32)
    rel[np.arange(n_q), rng.integers(0, n_t, n_q)] = 1.0
    retrieved = np.argsort(-(q_emb @ table.T), axis=1, kind="stable")[:, :26]
    feat = OutcomeFeaturizer.fit(q_emb, queries, rel, retrieved, rng.integers(0, 10, n_t),
                                 n_clusters=8, seed=0)
    mlp = {}
    for li, (din, dout) in enumerate(zip(LAYERS[:-1], LAYERS[1:])):
        mlp[f"w{li}"] = torch.from_numpy(
            (rng.normal(size=(din, dout)) * np.sqrt(2.0 / din)).astype(np.float32)).to(cuda_device)
        mlp[f"b{li}"] = torch.zeros(dout, device=cuda_device)
    db = ToolsDatabase([ToolRecord(i, f"t{i}", desc[i], 0) for i in range(n_t)], table)
    routers = {b: SemanticRouter(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=26,
                                 backend=b, stages=StageSet(mlp_params=mlp, featurizer=feat),
                                 metrics=False, device=cuda_device)
               for b in ("fused", "dense")}
    before = dict(topk_kernel.launches_by_route)
    fused = routers["fused"].route_batch(queries)
    assert routers["fused"].index.last_path() == "index:fused"
    assert topk_kernel.launches_by_route["select"] >= before["select"] + 2
    dense = routers["dense"].route_batch(queries)
    for a, b in zip(fused, dense):
        assert len(a.tools) == 26 and a.table_version == b.table_version
        _assert_same_up_to_near_ties(a.tools, a.scores, b.tools, b.scores)
    for r in routers.values():
        r.close()


def _auto_route(q, k):
    """topk_route's choice past CLUSTER_MAX_T rows for aligned D = 384."""
    wgmma = q >= topk_kernel.WGMMA_MIN_Q and q * k <= topk_kernel.WGMMA_MAX_QK
    return "wgmma" if wgmma else "split"


@functools.lru_cache(maxsize=None)
def _wgmma_table(t):
    """[t, 384] unit rows from a seed, made once per size (numpy, host)."""
    return _unit_rows(np.random.default_rng(t), t, 384, "cpu")


def _assert_wgmma_is_split(qt, tt, k):
    """The wgmma route (two launches) returns bitwise the split route's
    scores and indices; returns them with the rows it rescored."""
    before = dict(topk_kernel.launches_by_route)
    topk_kernel.reset_rescored()
    ws, wi = topk_kernel.topk_sim_cuda(qt, tt, k, route="wgmma")
    torch.cuda.synchronize()
    assert topk_kernel.launches_by_route == {**before, "wgmma": before["wgmma"] + 2}
    n_rescored = topk_kernel.rescored()
    ss, si = topk_kernel.topk_sim_cuda(qt, tt, k, route="split")
    assert torch.equal(ws, ss) and torch.equal(wi, si)
    assert qt.shape[0] * k <= n_rescored <= qt.shape[0] * tt.shape[0]
    return ws, wi, n_rescored


@pytest.mark.parametrize("k", [1, 5, 25, topk_kernel.WGMMA_MAX_K])
@pytest.mark.parametrize("t", [topk_kernel.CLUSTER_MAX_T + 1, 16_384, 100_003])
@pytest.mark.parametrize("q", [1, 8, 33, 64])
def test_topk_sim_wgmma_route_is_bitwise_the_split_route(cuda_device, q, t, k):
    """Tables past CLUSTER_MAX_T (6,145 and 100,003 rows end in a ragged
    tile) take the wgmma route where it beat the split route (WGMMA_MIN_Q
    <= Q, Q * k <= WGMMA_MAX_QK; forced elsewhere): the TF32 filter plus
    the float32 rescore give the split route's bits, and the plain
    version's ranking (scores within 1e-5; indices as
    `_assert_cluster_ranking` says)."""
    tt = _wgmma_table(t).to(cuda_device)
    qt = _unit_rows(np.random.default_rng(q * 31 + k), q, 384, cuda_device)
    route = _auto_route(q, k)
    assert topk_kernel.topk_route(q, t, 384, k, tt, qt) == route
    before = dict(topk_kernel.launches_by_route)
    ks, ki = topk_sim(qt, tt, k)
    torch.cuda.synchronize()
    assert topk_kernel.launches_by_route == {**before, route: before[route] + 2}
    ws, wi, _ = _assert_wgmma_is_split(qt, tt, k)
    assert torch.equal(ks, ws) and torch.equal(ki, wi)
    rs, ri = topk_sim_ref(qt, tt, k)
    _assert_cluster_ranking(qt, tt, ks, ki, rs, ri)


@pytest.mark.parametrize("q,k", [(64, 25), (8, 5), (64, topk_kernel.WGMMA_MAX_K)])
def test_topk_sim_wgmma_route_on_a_clone_table(cuda_device, q, k):
    """A scale_tool_corpus table (100,000 rows, clones of 2,413 with 0.02
    noise a dimension) and queries near its rows: clusters of similar
    scores stress the filter; the result is still the split route's."""
    rng = np.random.default_rng(7)
    native = rng.normal(size=(2413, 384)).astype(np.float32)
    native /= np.linalg.norm(native, axis=1, keepdims=True)
    tt = torch.from_numpy(scale_tool_corpus(native, 100_000, seed=0)).to(cuda_device)
    qn = native[rng.integers(0, 2413, q)] + 0.05 * rng.normal(size=(q, 384)).astype(np.float32)
    qt = torch.from_numpy(qn / np.linalg.norm(qn, axis=1, keepdims=True)).to(cuda_device)
    assert topk_kernel.topk_route(q, tt.shape[0], 384, k, tt, qt) == _auto_route(q, k)
    ks, ki, n_rescored = _assert_wgmma_is_split(qt, tt, k)
    print(f"clone table Q={q} k={k}: {n_rescored} (query, row) pairs rescored of "
          f"{q * tt.shape[0]}")
    rs, ri = topk_sim_ref(qt, tt, k)
    _assert_cluster_ranking(qt, tt, ks, ki, rs, ri)


def test_topk_sim_wgmma_route_with_zero_query_rows(cuda_device):
    """All-zero query rows, as the gateway pads a batch to a power of two:
    every row ties at zero, the split route's answer is the lowest rows,
    and the wgmma route gives the same bits while rescoring far fewer rows
    than the all-tied worst case."""
    tt = _wgmma_table(100_003).to(cuda_device)
    qt = _unit_rows(np.random.default_rng(24), 32, 384, cuda_device)
    qt[24:] = 0.0
    assert topk_kernel.topk_route(32, tt.shape[0], 384, 5, tt, qt) == "wgmma"
    ks, ki, n_rescored = _assert_wgmma_is_split(qt, tt, 5)
    print(f"zero query rows: {n_rescored} (query, row) pairs rescored of {32 * tt.shape[0]}")
    assert n_rescored < 8 * tt.shape[0] // 4
    assert bool((ks[24:] == 0).all())
    rs, ri = topk_sim_ref(qt, tt, 5)
    _assert_cluster_ranking(qt, tt, ks, ki, rs, ri)


def test_topk_sim_wgmma_route_rejects_what_it_cannot_take(cuda_device):
    """Forcing the wgmma route on inputs outside its reach raises before
    any launch."""
    t = _unit_rows(np.random.default_rng(3), topk_kernel.CLUSTER_MAX_T + 1, 384, cuda_device)
    q = _unit_rows(np.random.default_rng(4), 8, 384, cuda_device)
    flat = torch.zeros(t.numel() + 1, device=cuda_device)
    before = dict(topk_kernel.launches_by_route)
    for bad in (
        lambda: topk_kernel.topk_sim_cuda(
            _unit_rows(np.random.default_rng(5), 65, 384, cuda_device), t, 5, route="wgmma"),
        lambda: topk_kernel.topk_sim_cuda(q, t, topk_kernel.WGMMA_MAX_K + 1, route="wgmma"),
        lambda: topk_kernel.topk_sim_cuda(q[:, :130].contiguous(), t[:, :130].contiguous(), 5,
                                          route="wgmma"),  # D % 4 != 0
        lambda: topk_kernel.topk_sim_cuda(q[:, :16].contiguous(), t[:, :16].contiguous(), 5,
                                          route="wgmma"),  # D under one 32-column box
        lambda: topk_kernel.topk_sim_cuda(q, flat[1:].view(t.shape), 5, route="wgmma"),
    ):
        with pytest.raises(ValueError):
            bad()
    assert topk_kernel.launches_by_route == before


@pytest.mark.parametrize("case", ["d130", "misaligned", "large"])
def test_topk_sim_split_route_takes_what_the_cluster_cannot(cuda_device, case):
    """D % 4 != 0, a base off a 16-byte boundary, and a table past
    CLUSTER_MAX_T with a batch below WGMMA_MIN_Q go to the split route,
    which agrees with the plain version."""
    rng = np.random.default_rng(130)
    d = 130 if case == "d130" else 384
    t = topk_kernel.CLUSTER_MAX_T + 1 if case == "large" else 2413
    k = 25
    assert 8 < topk_kernel.WGMMA_MIN_Q
    qt = _unit_rows(rng, 8, d, cuda_device)
    tt = _unit_rows(rng, t + 1, d, cuda_device).view(-1)
    tt = (tt[1:1 + t * d] if case == "misaligned" else tt[:t * d]).view(t, d)
    assert topk_kernel.topk_route(8, t, d, k, tt, qt) == "split"
    if case != "large":
        for route in ("cluster", "wgmma"):
            with pytest.raises(ValueError):
                topk_kernel.topk_sim_cuda(qt, tt, k, route=route)
    before = dict(topk_kernel.launches_by_route)
    ks, ki = topk_sim(qt, tt, k)
    torch.cuda.synchronize()
    assert topk_kernel.launches_by_route == {**before, "split": before["split"] + 2}
    rs, ri = topk_sim_ref(qt, tt, k)
    torch.testing.assert_close(ks, rs, atol=1e-5, rtol=0)
    assert torch.equal(ki, ri)


@pytest.mark.parametrize("k", [8, 128])
def test_topk_sim_kernel_ties_to_lowest_index(cuda_device, k):
    """One-hot rows tiled so bitwise ties cross every tile and split."""
    base = torch.zeros((9, 128), device=cuda_device)
    base[torch.arange(9), torch.arange(9)] = 1.0
    table = base.repeat(5000, 1).contiguous()
    q = _unit_rows(np.random.default_rng(1), 4, 128, cuda_device)
    ks, ki = topk_kernel.topk_sim_cuda(q, table, k)
    rs, ri = topk_sim_ref(q, table, k)
    torch.testing.assert_close(ks, rs, atol=1e-6, rtol=0)
    assert torch.equal(ki, ri)
    best = q[:, :9].argmax(dim=1)
    assert torch.equal(ki, best[:, None] + 9 * torch.arange(k, device=cuda_device)[None, :])


def test_topk_sim_kernel_rejects_bad_inputs(cuda_device):
    q = torch.zeros((2, 8), device=cuda_device)
    t = torch.zeros((300, 8), device=cuda_device)
    for bad in (
        lambda: topk_kernel.topk_sim_cuda(q.double(), t.double(), 2),  # dtype
        lambda: topk_kernel.topk_sim_cuda(q, t[:, :4], 2),  # D mismatch
        lambda: topk_kernel.topk_sim_cuda(q, t.T, 2),  # not contiguous
        lambda: topk_kernel.topk_sim_cuda(q, t, 0),  # k below 1
        lambda: topk_kernel.topk_sim_cuda(q, t, 129, route="split"),  # k above split's limit
        lambda: topk_kernel.topk_sim_cuda(q, t, 2, route="sort"),  # no such route
        lambda: topk_kernel.topk_sim_cuda(q, t[:3], 4),  # k > T
    ):
        with pytest.raises(ValueError):
            bad()
    empty_s, empty_i = topk_kernel.topk_sim_cuda(q[:0], t, 2)
    assert empty_s.shape == (0, 2) and empty_i.shape == (0, 2)


# ------------------------------------------------------------ flash attention
FLASH_SHAPES = [  # bh, bhkv, sq, skv, hd, causal, window, q_offset
    (2, 2, 128, 128, 64, True, 0, 0),
    (3, 3, 200, 200, 64, True, 0, 0),
    (2, 2, 256, 256, 128, True, 64, 0),
    (1, 1, 1, 300, 64, True, 0, 299),
    (2, 2, 128, 128, 80, False, 0, 0),
    (1, 1, 96, 160, 64, True, 0, 64),
    (8, 4, 77, 77, 64, True, 16, 0),  # grouped-query attention, ragged tiles
    (25, 5, 2048, 2048, 64, True, 1024, 0),  # hymba-1.5b prefill, one layer
    (2, 2, 77, 200, 64, False, 0, 0),  # non-causal, Sq != Skv, neither a multiple of 128
    (4, 2, 77, 200, 64, True, 0, 123),  # a chunked prefill's last 77 rows over 200 keys
    (2, 2, 300, 300, 80, True, 100, 0),  # hd 80 (padded to 128) with a window
    (3, 1, 130, 260, 128, True, 70, 130),  # hd 128, window, two boxes a row
    (2, 2, 64, 100, 32, True, 0, 36),  # hd under one 64-column box
    # llama-3.2-vision-90b's cross-attention: a 2,048-token prompt, then a
    # 4-slot decode tick, over 1,600 image tokens (not a multiple of 128)
    (64, 8, 2048, 1600, 128, False, 0, 0),
    (256, 32, 1, 1600, 128, False, 0, 0),
]


def _within_bf16_scale(got, want):
    """bf16 flash output against its plain version at the output's scale:
    max|d| within two bf16 ulps of max|plain| (both round to bf16, so they
    differ by an element's ulp) and ||d|| within 1e-2 of ||plain|| (one
    rounding is ~3e-3). Output a few per cent off throughout, as from a
    tail tile dropped or left unmasked, fails at any scale."""
    d, want = got.float() - want.float(), want.float()
    top = float(want.abs().max())
    ulps2 = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
    return float(d.abs().max()) <= ulps2 and float(d.norm() / want.norm()) <= 1e-2


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("bh,bhkv,sq,skv,hd,causal,window,q_offset", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain(cuda_device, dtype, atol, bh, bhkv, sq, skv, hd,
                                              causal, window, q_offset):
    rng = np.random.default_rng(bh * 7919 + sq + hd)
    q, k, v = (torch.from_numpy(rng.normal(size=(n, s, hd)).astype(np.float32))
               .to(cuda_device, dtype) for n, s in ((bh, sq), (bhkv, skv), (bhkv, skv)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    route = "wgmma" if dtype == torch.bfloat16 else "fma"  # every hd here is a multiple of 8
    before, before_route = flash_kernel.launches, flash_kernel.launches_by_route[route]
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_kernel.launches == before + 1
    assert flash_kernel.launches_by_route[route] == before_route + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    want = attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    if dtype == torch.bfloat16:
        assert _within_bf16_scale(got, want)


@pytest.mark.parametrize("bh,bhkv,sq", [(64, 8, 2048), (256, 32, 1)])
def test_flash_bf16_check_fails_a_kernel_without_the_tail_tile(cuda_device, bh, bhkv, sq):
    """At the VLM's cross-attention shapes (1,600 keys: 12 whole tiles and
    a 64-key tail) the bf16 check passes the kernel and fails it over the
    first 1,536 keys, or with the tail tile's 64 padding keys read as
    zeros, both against the plain version over all 1,600 keys; at unit
    scale and at the small values of a model's image tokens."""
    rng = np.random.default_rng(bh + sq)
    q, k, v = (torch.from_numpy(rng.normal(size=(n, s, 128)).astype(np.float32))
               .to(cuda_device, torch.bfloat16) for n, s in ((bh, sq), (bhkv, 1600), (bhkv, 1600)))
    pad = torch.zeros(bhkv, 64, 128, device=cuda_device, dtype=torch.bfloat16)
    for scale in (1.0, 0.05):
        vs = (v.float() * scale).to(torch.bfloat16)
        want = attention_ref(q, k, vs, causal=False)
        assert _within_bf16_scale(flash_attention(q, k, vs, causal=False), want)
        dropped = flash_attention(q, k[:, :1536].contiguous(), vs[:, :1536].contiguous(),
                                  causal=False)
        unmasked = flash_attention(q, torch.cat([k, pad], 1), torch.cat([vs, pad], 1),
                                   causal=False)
        assert not _within_bf16_scale(dropped, want)
        assert not _within_bf16_scale(unmasked, want)


@pytest.mark.parametrize("case", ["hd36", "misaligned", "forced"])
def test_flash_attention_fma_route_takes_bf16(cuda_device, case):
    """bf16 the tensor-core kernel cannot take (hd % 8 != 0, a base off a
    16-byte boundary) runs on the FMA kernel, as does bf16 whose caller asks
    for it; each within bf16's 3e-2 of the plain version."""
    rng = np.random.default_rng(36)
    hd = 36 if case == "hd36" else 64

    def make(n, s):
        x = torch.from_numpy(rng.normal(size=(n * s * hd + 1,)).astype(np.float32))
        x = x.to(cuda_device, torch.bfloat16)
        return (x[1:] if case == "misaligned" else x[:-1]).view(n, s, hd)

    q, k, v = make(4, 150), make(2, 150), make(2, 150)
    kw = dict(causal=True, window=64, q_offset=0)
    assert flash_kernel.flash_route(q.dtype, hd, q, k, v) == (
        "wgmma" if case == "forced" else "fma")
    before = dict(flash_kernel.launches_by_route)
    got = flash_kernel.flash_attention_cuda(q, k, v, route="fma" if case == "forced" else None,
                                            **kw)
    torch.cuda.synchronize()
    assert flash_kernel.launches_by_route == {**before, "fma": before["fma"] + 1}
    torch.testing.assert_close(got.float(), attention_ref(q, k, v, **kw).float(),
                               atol=3e-2, rtol=0)


# ------------------------------------------------------------------ rope heads
ROPE_SHAPES = [  # b, h, hkv, hd: granite-3-8b's and hymba-1.5b's layer 0
    (1, 32, 8, 128), (1, 25, 5, 64)]


def _rope_inputs(seed, b, s, h, hkv, hd, dtype, device):
    """q, k, v [B, S, heads, hd] as the projections return them (contiguous,
    values of a bf16 model's scale) and prefill's expanded positions."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, s, n, hd, generator=g).to(device, dtype) for n in (h, hkv, hkv))
    return q, k, v, torch.arange(s, device=device)[None].expand(b, s)


@pytest.mark.parametrize("s", [1, 37, 512, 4096])
@pytest.mark.parametrize("b,h,hkv,hd", ROPE_SHAPES)
def test_rope_heads_kernel_matches_plain(cuda_device, b, h, hkv, hd, s):
    """The kernel against `rope_heads_ref` on the card, bf16, at both cells'
    layer-0 shapes: every element equal (the kernel keeps the plain
    version's float32 arithmetic and rounds once, at the store, as it
    does), one launch a call."""
    q, k, v, pos = _rope_inputs(s + hd, b, s, h, hkv, hd, torch.bfloat16, cuda_device)
    before = rope_kernel.launches
    got = rope_heads(q, k, v, pos, 1e4)
    torch.cuda.synchronize()
    assert rope_kernel.launches == before + 1
    want = rope_heads_ref(q, k, v, pos, 1e4)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16 and g.is_contiguous()
    off = [int((g != w).sum()) for g, w in zip(got, want)]
    assert off == [0, 0, 0], f"elements off the plain version (q, k, v): {off}"


@pytest.mark.parametrize("case", ["float32", "strided", "offset"])
def test_rope_heads_kernel_other_inputs(cuda_device, case):
    """float32 (16 bytes are 4 values), q, k and v as column slices of one
    fused projection (row strides of its width), positions from offsets
    that differ a batch row; every element equal to the plain version's."""
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    hd = 64
    b, s, h, hkv = 2, 300, 8, 2
    q, k, v, pos = _rope_inputs(7, b, s, h, hkv, hd, dtype, cuda_device)
    if case == "strided":
        fused = torch.cat([q, k, v], dim=2)
        q, k, v = fused[:, :, :h], fused[:, :, h:h + hkv], fused[:, :, h + hkv:]
        assert not q.is_contiguous()
    if case == "offset":
        pos = torch.arange(s, device=cuda_device)[None] + torch.tensor(
            [[0], [5000]], device=cuda_device)
    got = rope_kernel.rope_heads_cuda(q, k, v, pos, 5e5)
    want = rope_heads_ref(q, k, v, pos, 5e5)
    off = [int((g != w).sum()) for g, w in zip(got, want)]
    assert off == [0, 0, 0], f"elements off the plain version (q, k, v): {off}"


def test_rope_heads_kernel_rejects_what_it_cannot_take(cuda_device):
    q, k, v, pos = _rope_inputs(0, 1, 16, 4, 2, 64, torch.bfloat16, cuda_device)
    odd = [t[..., :63] for t in (q, k, v)]
    hd36 = [t[..., :36] for t in (q, k, v)]  # a half of 18 values: not whole 16-byte units
    shifted = torch.zeros(q.numel() + 1, dtype=q.dtype, device=cuda_device)[1:].view(q.shape)
    for bad in (
        lambda: rope_kernel.rope_heads_cuda(*odd, pos, 1e4),  # odd hd
        lambda: rope_kernel.rope_heads_cuda(*hd36, pos, 1e4),  # hd 36
        lambda: rope_kernel.rope_heads_cuda(shifted, k, v, pos, 1e4),  # rows off 16 bytes
        lambda: rope_kernel.rope_heads_cuda(q.transpose(2, 3), k, v, pos, 1e4),  # last dim
        lambda: rope_kernel.rope_heads_cuda(q, k[..., ::2], v[..., ::2], pos, 1e4),  # strided hd
        lambda: rope_kernel.rope_heads_cuda(q.half(), k.half(), v.half(), pos, 1e4),  # dtype
        lambda: rope_kernel.rope_heads_cuda(q, k.float(), v, pos, 1e4),  # mixed dtypes
        lambda: rope_kernel.rope_heads_cuda(q, k, v, pos.int(), 1e4),  # int32 positions
        lambda: rope_kernel.rope_heads_cuda(q, k, v, pos[:, :8], 1e4),  # positions' shape
        lambda: rope_kernel.rope_heads_cuda(*(torch.zeros(1, 4, 2, 130, device=cuda_device,
                                                          dtype=torch.bfloat16),) * 3,
                                            pos[:, :4], 1e4),  # hd above flash's 128
        lambda: rope_kernel.rope_heads_cuda(q.cpu(), k, v, pos, 1e4),
    ):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize("arch", ["granite-3-8b", "hymba-1.5b"])
def test_attn_block_kernel_path_equals_plain_on_the_card(cuda_device, arch):
    """`attn_block` at the configuration's reduced shapes, float32, on its
    kernel path (rope_heads, flash on the fma route) against its plain path:
    output and decode cache within the flash tests' float32 2e-5; then one
    bf16 prefill launches rope_heads once an attention layer."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers, model as M
    from repro_torch.models.config import reduced

    cfg = reduced(get_config(arch), sliding_window=16 if arch == "hymba-1.5b" else 0)
    params = M.init(cfg, torch.Generator(cuda_device).manual_seed(0), cuda_device)
    p = M._layer(params["layers"], 0)["attn"]
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    pos = torch.arange(40, device=cuda_device)[None].expand(2, 40)
    before = rope_kernel.launches
    with torch.no_grad():
        out, cache = layers.attn_block(p, x, cfg, pos, return_cache=True, max_cache_len=48)
    torch.cuda.synchronize()
    assert rope_kernel.launches == before + 1
    want, want_cache = layers.attn_block(p, x, cfg, pos, return_cache=True, max_cache_len=48,
                                         use_kernel=False)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=0)
    for got_t, want_t in zip(cache, want_cache):
        torch.testing.assert_close(got_t, want_t, atol=2e-5, rtol=0)
    bf16 = reduced(get_config(arch), dtype="bfloat16",
                   sliding_window=16 if arch == "hymba-1.5b" else 0)
    bparams = M.init(bf16, torch.Generator(cuda_device).manual_seed(0), cuda_device)
    toks = torch.randint(0, bf16.vocab_size, (1, 40), device=cuda_device)
    before = rope_kernel.launches
    with torch.no_grad():
        M.prefill(bf16, bparams, {"tokens": toks})
    torch.cuda.synchronize()
    assert rope_kernel.launches == before + bf16.n_layers


# ----------------------------------------------------------------- ssd scan
SSD_SHAPES = [  # b, s, h, p, g, n, chunk
    (2, 256, 4, 64, 1, 128, 64),
    (1, 512, 8, 64, 2, 64, 128),
    (2, 128, 2, 32, 1, 16, 32),
    (1, 96, 3, 80, 3, 8, 32),  # ragged last tile, P not a multiple of 16
    (1, 2048, 50, 64, 1, 16, 256),  # hymba-1.5b prefill, one layer
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
def test_ssd_scan_kernel_matches_plain(cuda_device, dtype, b, s, h, p, g, n, chunk):
    """y within 1e-3 (plus one bfloat16 ulp, 2**-7 relative, when y is
    bfloat16: both versions round the same float32 value once); the final
    state (float32) within 1e-3."""
    rng = np.random.default_rng(s + h + n)
    x = torch.from_numpy(rng.normal(size=(b, s, h, p)).astype(np.float32)).to(cuda_device, dtype)
    dt = torch.from_numpy((0.1 + 0.5 * rng.random((b, s, h))).astype(np.float32)).to(cuda_device)
    a_log = torch.from_numpy((rng.normal(size=(h,)) * 0.5).astype(np.float32)).to(cuda_device)
    bm, cm = (torch.from_numpy((rng.normal(size=(b, s, g, n)) * 0.3).astype(np.float32))
              .to(cuda_device, dtype) for _ in range(2))
    before = ssd_kernel.launches
    y, st = ssd_scan(x, dt, a_log, bm, cm, chunk)
    torch.cuda.synchronize()
    assert ssd_kernel.launches == before + len(ssd_kernel.PHASES)  # one launch a phase
    ry, rst = ssd_scan_ref(x, dt, a_log, bm, cm, chunk)
    assert y.dtype == dtype and st.dtype == torch.float32
    rtol = 2**-7 if dtype == torch.bfloat16 else 0
    torch.testing.assert_close(y.float(), ry.float(), atol=1e-3, rtol=rtol)
    torch.testing.assert_close(st, rst, atol=1e-3, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [(2, 384, 8, 64, 2, 16, 128),
                                               (1, 2048, 50, 64, 1, 16, 256),
                                               (1, 200, 6, 32, 3, 24, 40),
                                               (1, 100, 4, 36, 2, 6, 20)])
def test_ssd_scan_kernel_reads_xbc_slices(cuda_device, dtype, b, s, h, p, g, n, chunk):
    """x, B and C as ssm_block passes them: column slices of one xBC tensor,
    in its dtype and row stride, with several tiles a sequence (a ragged
    last one at S = 200 and 100) and G < H, read 16 bytes at a time except
    at P = 36, N = 6 (rows of other widths); held to the tolerances above."""
    rng = np.random.default_rng(s + g)
    xbc = rng.normal(size=(b, s, h * p + 2 * g * n)).astype(np.float32)
    xbc[..., h * p:] *= 0.3
    xbc = torch.from_numpy(xbc).to(cuda_device, dtype)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bm = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
    cm = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    assert not (x.is_contiguous() or bm.is_contiguous() or cm.is_contiguous())
    dt = torch.from_numpy((0.1 + 0.5 * rng.random((b, s, h))).astype(np.float32)).to(cuda_device)
    a_log = torch.from_numpy((rng.normal(size=(h,)) * 0.5).astype(np.float32)).to(cuda_device)
    before = ssd_kernel.launches
    y, st = ssd_kernel.ssd_scan_cuda(x, dt, a_log, bm, cm, chunk)
    assert ssd_kernel.launches == before + len(ssd_kernel.PHASES)
    ry, rst = ssd_scan_ref(x, dt, a_log, bm, cm, chunk)
    rtol = 2**-7 if dtype == torch.bfloat16 else 0
    torch.testing.assert_close(y.float(), ry.float(), atol=1e-3, rtol=rtol)
    torch.testing.assert_close(st, rst, atol=1e-3, rtol=0)


def test_new_kernels_reject_bad_inputs(cuda_device):
    q = torch.zeros((4, 8, 64), device=cuda_device)
    for bad in (
        lambda: flash_kernel.flash_attention_cuda(q.double(), q.double(), q.double()),
        lambda: flash_kernel.flash_attention_cuda(q, q[:3], q[:3]),  # 4 rows over 3
        lambda: flash_kernel.flash_attention_cuda(q, q.transpose(1, 2), q),  # shapes
        lambda: flash_kernel.flash_attention_cuda(torch.zeros((1, 8, 129), device=cuda_device),
                                                  torch.zeros((1, 8, 129), device=cuda_device),
                                                  torch.zeros((1, 8, 129), device=cuda_device)),
        lambda: flash_kernel.flash_attention_cuda(q, q, q, route="wgmma"),  # float32
        lambda: flash_kernel.flash_attention_cuda(q, q, q, route="tf32"),  # no such kernel
    ):
        with pytest.raises(ValueError):
            bad()
    x = torch.zeros((1, 64, 2, 8), device=cuda_device)
    dt = torch.zeros((1, 64, 2), device=cuda_device)
    a_log = torch.zeros((2,), device=cuda_device)
    bm = torch.zeros((1, 64, 1, 4), device=cuda_device)
    for bad in (
        lambda: ssd_kernel.ssd_scan_cuda(x, dt, a_log, bm, bm, 48),  # 64 % 48
        lambda: ssd_kernel.ssd_scan_cuda(x, dt, a_log, bm[:, :, :, :0], bm[:, :, :, :0], 16),
        lambda: ssd_kernel.ssd_scan_cuda(x, dt[:, :, :1], a_log, bm, bm, 16),
        lambda: ssd_kernel.ssd_scan_cuda(x.cpu(), dt, a_log, bm, bm, 16),
    ):
        with pytest.raises(ValueError):
            bad()


def _random_router_world(cuda_device, n_t, n_q=64, seed=0, **router_kw):
    """A fused-backend router on the card over `n_t` random tools, and
    `n_q` queries: (router, db, encoder, queries)."""
    from repro_torch.embedding.bag_encoder import BagEncoder
    from repro_torch.router.gateway import SemanticRouter
    from repro_torch.router.tooldb import ToolRecord, ToolsDatabase

    rng = np.random.default_rng(seed)
    vocab = SimpleNamespace(word_vecs=rng.normal(size=(4000, 384)).astype(np.float32))
    enc = BagEncoder(vocab, device=cuda_device)
    desc = [rng.integers(0, 4000, 12) for _ in range(n_t)]
    queries = [rng.integers(0, 4000, 8) for _ in range(n_q)]
    db = ToolsDatabase([ToolRecord(i, f"t{i}", desc[i], 0) for i in range(n_t)],
                       enc.encode(desc), history_limit=2)
    router_kw.setdefault("metrics", False)
    router = SemanticRouter(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                            backend="fused", device=cuda_device, **router_kw)
    return router, db, enc, queries


@pytest.mark.parametrize("n_t", [2413, 25_000])
def test_fused_router_under_concurrent_swaps(cuda_device, n_t):
    """A thread swaps between the table and a jittered copy every 2 ms
    while the main thread serves batches of 64 through the fused backend:
    the index is rebuilt on the swapping thread, and every result must be
    the dense top-5 of the table its `table_version` names (float64
    similarities; near-ties within 1e-5 may reorder)."""
    import threading
    import time

    router, db, enc, queries = _random_router_world(cuda_device, n_t)
    base = db.embeddings.copy()
    jitter = base + np.random.default_rng(1).normal(scale=1e-3, size=base.shape).astype(
        np.float32)
    jitter /= np.linalg.norm(jitter, axis=1, keepdims=True)
    tables = {0: base}
    lock, stop = threading.Lock(), threading.Event()

    def churn():
        i = 0
        while not stop.is_set():
            new = (jitter, base)[i % 2]
            with lock:
                tables[db.swap_table(new)] = new
            i += 1
            time.sleep(0.002)

    t = threading.Thread(target=churn, daemon=True)
    t.start()
    q_emb = enc.encode(queries).astype(np.float64)
    try:
        seen = set()
        for _ in range(32):
            results = router.route_batch(queries)
            versions = {r.table_version for r in results}
            assert len(versions) == 1
            v = versions.pop()
            seen.add(v)
            with lock:
                sims = q_emb @ tables[v].astype(np.float64).T
            for j, r in enumerate(results):
                order = np.argsort(-sims[j], kind="stable")[:5]
                _assert_same_up_to_near_ties(r.tools, r.scores, order.tolist(),
                                             sims[j][order].tolist())
    finally:
        stop.set()
        t.join()
    assert len(seen) > 1 and router.index.last_path() == "index:fused"
    assert router.index.stats["build_failures"] == 0
    router.close()


def test_route_cache_over_the_fused_backend(cuda_device):
    """A cached fused router and a bare one serve the same Zipf stream of
    exact repeats with content-identical swaps between batches: every hit
    equals the bare router's result, nothing stale is served, and the hit
    rate is high once the hot set is seen."""
    from repro_torch.cache import SemanticRouteCache
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.traffic import TrafficConfig, ZipfTrafficGenerator, drive

    registry = MetricsRegistry()
    cached, db, _, queries = _random_router_world(
        cuda_device, 25_000, cache=SemanticRouteCache(metrics=registry), metrics=registry)
    bare, db_bare, _, _ = _random_router_world(cuda_device, 25_000)
    cfg = TrafficConfig(zipf_s=1.1, pool_size=64, query_len=24, batch_size=32,
                        paraphrase_p=0.0, seed=3)
    pool = [np.tile(q, 3) for q in queries]
    batches = list(ZipfTrafficGenerator(cfg, pool=pool).stream(40))

    def swapper(d):
        def swap(i):
            if i and i % 10 == 0:
                v, live = d.snapshot()
                d.swap_table(live.copy(), expect_current=v)
        return swap

    rep = drive(cached, batches, on_batch=swapper(db), record=True)
    ref = drive(bare, batches, on_batch=swapper(db_bare), record=True)
    assert rep.stale_serves == 0 and rep.hit_rate > 0.5
    assert registry.counter("route_cache_stale_served_total").value() == 0
    for got, want in zip(rep.results, ref.results):
        for a, b in zip(got, want):
            assert a.tools == b.tools and a.table_version == b.table_version
    assert cached.index.last_path() == "index:fused"
    cached.close()
    bare.close()


def test_controller_refines_on_the_card(cuda_device):
    """`RefinementController(device=card)` runs the port's refine_with_gate
    on the card from the store's numpy window and swaps the host copy of the
    refined table: the same decision and table (within 1e-5) as the same
    step on the CPU."""
    from repro_torch.control import ControllerConfig, OutcomeStore, RefinementController
    from repro_torch.router.gateway import OutcomeEvent
    from repro_torch.router.tooldb import ToolRecord, ToolsDatabase

    router, db, enc, queries = _random_router_world(cuda_device, 300, n_q=400)
    rng = np.random.default_rng(2)
    truth = rng.integers(0, 300, size=len(queries))
    results = router.route_batch(queries)
    events = []
    for qi, (q, r) in enumerate(zip(queries, results)):
        tools = list(r.tools) + [int(truth[qi])]
        events += [OutcomeEvent(q, t, int(t == truth[qi]), 0.0) for t in tools]
    outcomes = []
    for where in (cuda_device, "cpu"):
        d = ToolsDatabase([ToolRecord(i, f"t{i}", np.arange(2), 0) for i in range(300)],
                          db.embeddings.copy())
        store = OutcomeStore(n_tools=300)
        ctl = RefinementController(d, store, enc.encode, device=where,
                                   config=ControllerConfig(min_events=1, min_queries=10))
        store.ingest(events)
        rep = ctl.step()
        assert rep.triggered and rep.accepted is not None
        outcomes.append((rep.accepted, rep.swapped, d.embeddings.copy()))
    (acc_a, sw_a, t_a), (acc_b, sw_b, t_b) = outcomes
    assert (acc_a, sw_a) == (acc_b, sw_b)
    np.testing.assert_allclose(t_a, t_b, atol=1e-5, rtol=0)
    router.close()


@functools.lru_cache(maxsize=None)
def _scaled_toolbench(n_tools):
    """(ToolBench-like bench, its encoder, the table scaled to n_tools, the
    encoded queries), on the CPU."""
    from repro_torch.data.benchmarks import make_toolbench_like
    from repro_torch.embedding.bag_encoder import BagEncoder

    bench = make_toolbench_like(seed=0)
    enc = BagEncoder(bench.vocab, device="cpu")
    table = scale_tool_corpus(enc.encode(bench.desc_tokens), n_tools, seed=0)
    return bench, enc, table, enc.encode(bench.query_tokens)


def test_ivf_recall_against_fused_on_the_card(cuda_device):
    """IVF built and queried on the card: Recall@5 >= 0.98 against the
    fused backend's exact result, the same k-means iterations and recall
    (within 0.005) as the same build on the CPU, and exact similarities."""
    from repro_torch.index import FusedBackend, IVFBackend

    _, _, table, queries = _scaled_toolbench(30_000)
    exact = FusedBackend(table, 0, device=cuda_device).topk(queries, 5)[1]
    card = IVFBackend(table, 0, device=cuda_device)
    host = IVFBackend(table, 0, device="cpu")
    assert card.centroids.device.type == cuda_device.type and card._codes.dtype == torch.int8
    assert card.kmeans_iters_run == host.kmeans_iters_run
    recall = {}
    for name, ivf in (("card", card), ("host", host)):
        scores, idx = ivf.topk(queries, 5)
        recall[name] = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(exact, idx)])
        want = np.einsum("qkd,qd->qk", table[idx].astype(np.float64), queries.astype(np.float64))
        np.testing.assert_allclose(scores, want, atol=1e-5, rtol=0)
    assert recall["card"] >= 0.98 and abs(recall["card"] - recall["host"]) <= 0.005, recall
    empty = card.topk(queries[:0], 5)
    assert empty[0].shape == (0, 5) and empty[1].dtype == np.int64


def _learning_world(device):
    """A MetaTool-like world served by a fused router on `device`, its
    outcome store, a stage guard, and a learning controller whose plan
    always admits the adapter."""
    from repro_torch.control import OutcomeStore
    from repro_torch.core.deployment import DeploymentPlan
    from repro_torch.data.benchmarks import make_metatool_like
    from repro_torch.embedding.bag_encoder import BagEncoder
    from repro_torch.learn import LearnConfig, LearningController, StageGuard, StageGuardConfig
    from repro_torch.router.gateway import SemanticRouter
    from repro_torch.router.tooldb import ToolRecord, ToolsDatabase

    bench = make_metatool_like(seed=0, n_queries=1200)
    enc = BagEncoder(bench.vocab, device="cpu")
    db = ToolsDatabase([ToolRecord(i, f"t{i}", bench.desc_tokens[i], 0)
                        for i in range(bench.n_tools)], enc.encode(bench.desc_tokens))
    store = OutcomeStore(n_tools=bench.n_tools)
    router = SemanticRouter(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                            outcome_sink=store.append, backend="fused", device=device)
    guard = StageGuard(router, StageGuardConfig(min_samples=32))

    def plan(n_tools, n_examples):
        return DeploymentPlan(refine=True, mlp_reranker=False, contrastive_adapter=True,
                              density=n_examples / n_tools, reason="adapter forced (test)")

    learner = LearningController(db, store, router, enc.encode, guard=guard, plan_fn=plan,
                                 config=LearnConfig(min_new_events=500, min_queries=20))
    return SimpleNamespace(bench=bench, router=router, guard=guard, learner=learner)


def _serve_labelled(w, idx, observe=False):
    for lo in range(0, len(idx), 64):
        chunk = idx[lo:lo + 64]
        results = w.router.route_batch([w.bench.query_tokens[i] for i in chunk])
        for qi, r in zip(chunk, results):
            for t in r.tools:
                w.router.record_outcome(w.bench.query_tokens[qi], t,
                                        int(t in w.bench.relevant[qi]))
            if observe:
                w.guard.observe(r.stage_version, r.tools, w.bench.relevant[qi])


def _heldout(w):
    from repro_torch.metrics.retrieval import ndcg_at_k

    idx = w.bench.test_idx[:200]
    results = w.router.route_batch([w.bench.query_tokens[i] for i in idx])
    return float(np.mean([ndcg_at_k(r.tools, w.bench.relevant[i], 5)
                          for i, r in zip(idx, results)]))


def test_learning_step_promotes_on_the_card(cuda_device):
    """One LearningController step trains the adapter on the card, gates it
    on the card and promotes it: the served params live on the card and the
    held-out NDCG@5 rises."""
    w = _learning_world(cuda_device)
    assert w.learner.device == cuda_device
    before = _heldout(w)
    _serve_labelled(w, w.bench.train_idx)
    rep = w.learner.step()
    d = rep.decisions["adapter"]
    assert d.action == "promoted" and d.ndcg_candidate > d.ndcg_current, d
    _, stages = w.router.stage_set()
    assert all(v.device.type == cuda_device.type for v in stages.adapter_params.values())
    assert _heldout(w) > before
    w.router.close()


def test_stage_demotion_restores_exactly_on_the_card(cuda_device):
    """A corrupted adapter set out of band is demoted by the StageGuard and
    the restored StageSet serves exactly what the good one served."""
    import dataclasses

    w = _learning_world(cuda_device)
    _serve_labelled(w, w.bench.train_idx)
    assert w.learner.step().decisions["adapter"].action == "promoted"
    good = _heldout(w)
    _serve_labelled(w, w.bench.test_idx[:200], observe=True)
    sv, live = w.router.stage_set()
    rng = np.random.default_rng(0)
    bad = {k: torch.from_numpy(rng.normal(scale=0.5, size=tuple(v.shape)).astype(np.float32))
           .to(cuda_device) for k, v in live.adapter_params.items()}
    w.router.set_stages(dataclasses.replace(live, adapter_params=bad), expect_version=sv)
    assert _heldout(w) < good
    for idx in np.array_split(w.bench.test_idx, 3):
        _serve_labelled(w, idx, observe=True)
        if w.learner.step().guard.action == "demoted":
            break
    assert w.guard.demotions and w.router.stage_set()[1].adapter_artifact == live.adapter_artifact
    assert _heldout(w) == good
    w.router.close()


def test_launcher_profiler_counts_a_route_first_launch_once(cuda_device, monkeypatch):
    """`repro_torch.launch.serve` on the card behind the fused backend: a
    JitProfiler baselined before the run counts the library load (where the
    run made it) and each route's first launch once (the launcher's warm-up
    makes them, before its own profiler's baseline), and an identical second
    run adds nothing. The record of launched routes starts empty here, so
    the routes count whatever earlier tests launched."""
    import contextlib
    import io

    from repro_torch.launch import serve
    from repro_torch.obs import JitProfiler, MetricsRegistry

    monkeypatch.setattr(topk_kernel, "launched_routes", set())
    # 20 requests in batches of 16 and 4 over 20,000 tools: wgmma, then split
    argv = ["--smoke", "--backend", "fused", "--n-tools", "40", "--n-queries", "120",
            "--num-tools", "20000", "--requests", "20", "--route-batch", "16",
            "--max-new-tokens", "2"]
    prof = JitProfiler(registry=MetricsRegistry())
    loads = topk_kernel.LIBRARY.loads
    prof.collect()
    launches = topk_kernel.launches
    with contextlib.redirect_stdout(io.StringIO()):
        serve.main(argv)
    prof.collect()
    # the warm-up: buckets 1-16 at k = 5 and at the re-ranker's 25
    want = {topk_kernel.PROBE.route(n, 20000, 384, k) for n in (1, 2, 4, 8, 16) for k in (5, 25)}
    assert want == {"wgmma", "split"} and topk_kernel.launched_routes == want
    # two launches a call on both routes: ten warm-up calls, two batches
    assert topk_kernel.launches - launches == 2 * (10 + 2)
    first = prof.snapshot()["jits"]["topk_sim"]
    assert first["compiles_total"] == topk_kernel.LIBRARY.loads - loads + len(want)
    assert first["cache_size"] == topk_kernel.LIBRARY.loads + len(want)
    with contextlib.redirect_stdout(io.StringIO()):
        serve.main(argv)
    prof.collect()
    assert prof.snapshot()["jits"]["topk_sim"] == first
    assert topk_kernel.launches - launches == 2 * 2 * (10 + 2)


def test_launcher_in_a_fresh_process_counts_no_retrace(cuda_device, tmp_path):
    """`python -m repro_torch.launch.serve` in a process of its own on the
    card, behind the fused backend, with the ring ticking (--metrics-port 0)
    and the flight recorder armed: no route has launched before the
    launcher's warm-up, which comes before its profiler's baseline, so the
    ring, judging the probe through serving, counts no retrace: health ok
    and no dump. Serving lasts past two ring ticks after the first batch."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.launch import serve
    from repro_torch.obs import list_dumps

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    dumps = tmp_path / "dumps"
    # 400 requests in 25 batches over 20,000 tools: wgmma at 16 queries
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--backend", "fused",
         "--n-tools", "40", "--n-queries", "2400", "--num-tools", "20000", "--requests", "400",
         "--route-batch", "16", "--max-new-tokens", "8", "--metrics-port", "0",
         "--dump-dir", str(dumps)],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = serve.printed_results(proc.stdout)
    assert got["serve_s"] >= 2.0, proc.stdout
    assert got["health"] == "ok", proc.stdout
    assert list_dumps(str(dumps)) == []


# ------------------------------------------------ trainers: one seed, one model
def _trainer_data():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(1500, 7)).astype(np.float32)
    labels = (feats[:, 0] + 0.5 * rng.normal(size=1500) > 0).astype(np.float32)

    def unit(x):
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    tools = unit(rng.normal(size=(60, 384)))
    rel = np.zeros((300, 60), np.float32)
    rel[np.arange(300), rng.integers(0, 60, 300)] = 1.0
    queries = unit(rel @ tools + 0.8 * rng.normal(size=(300, 384)))
    return feats, labels, queries, tools, rel


def _max_apart(a, b):
    return max(float((a[name].cpu() - w.cpu()).abs().max()) for name, w in b.items())


def test_trainers_draw_the_same_model_on_card_and_cpu(cuda_device):
    """The re-ranker's and the adapter's init, permutations and dropout
    masks come from a CPU generator: one seed trains the same params on
    the card as on the CPU (float32 sums apart: within 1e-4), though
    training moves them far past 1e-4 and another seed lands far away.
    The adapter runs at lr 1e-4 for 20 epochs, where nothing flips sign
    (at lr 1e-3 see the next test)."""
    from repro_torch.core.adapter import (AdapterConfig, init_adapter, mine_triplets,
                                          train_adapter)
    from repro_torch.core.reranker import RerankerConfig, init_mlp, train_reranker

    feats, labels, queries, tools, rel = _trainer_data()
    cfg = RerankerConfig(epochs=8, batch_size=256, seed=3)
    got = {dev: train_reranker(feats, labels, cfg, device=dev)
           for dev in (cuda_device, "cpu")}
    for name, w in got["cpu"][0].items():
        torch.testing.assert_close(got[cuda_device][0][name].cpu(), w, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[cuda_device][1], got["cpu"][1], atol=1e-4)
    assert _max_apart(got["cpu"][0], init_mlp(torch.Generator().manual_seed(3))) > 1e-2
    other = train_reranker(feats, labels, RerankerConfig(epochs=8, batch_size=256, seed=4),
                           device="cpu")[0]
    assert _max_apart(other, got["cpu"][0]) > 1e-2

    triplets = mine_triplets(queries[:240], tools, rel[:240], n_hard=4, seed=0)

    def adapter(seed, dev):
        acfg = AdapterConfig(batch_size=64, seed=seed, lr=1e-4, epochs=20)
        return train_adapter(queries[:240], tools, triplets, queries[240:], rel[240:],
                             config=acfg, device=dev)

    adapted = {dev: adapter(5, dev) for dev in (cuda_device, "cpu")}
    for name, w in adapted["cpu"][0].items():
        torch.testing.assert_close(adapted[cuda_device][0][name].cpu(), w, atol=1e-4, rtol=0)
    assert adapted[cuda_device][1]["val_ndcg"] == pytest.approx(adapted["cpu"][1]["val_ndcg"],
                                                                abs=1e-4)
    assert _max_apart(adapted["cpu"][0], init_adapter(torch.Generator().manual_seed(5))) > 1e-3
    assert _max_apart(adapter(6, "cpu")[0], adapted["cpu"][0]) > 1e-2


def test_adapter_card_cpu_gap_at_lr_1e3_is_float_rounding(cuda_device):
    """At an adapter lr of 1e-3 a few of w1's entries end about 1e-3 apart
    card to CPU: Adam's normalised step turns a near-zero gradient's
    rounding noise into a whole step of either sign. The control has the
    same draws on the CPU alone, with the inputs one float32 ulp apart: its
    update differs from the CPU run's in the same few entries. The card's
    update is held within 10x that control's distance, and a run with other
    draws (seed 6) is farther than the update itself. Distances are
    ||update - CPU update|| / ||CPU update||, the update being params less
    the init."""
    from repro_torch.core.adapter import (AdapterConfig, init_adapter, mine_triplets,
                                          train_adapter)

    _, _, queries, tools, rel = _trainer_data()
    triplets = mine_triplets(queries[:240], tools, rel[:240], n_hard=4, seed=0)
    nudged = np.nextafter(queries, np.float32(np.inf)).astype(np.float32)

    def adapter(qs, seed, dev):
        acfg = AdapterConfig(batch_size=64, seed=seed, lr=1e-3)
        return train_adapter(qs[:240], tools, triplets, qs[240:], rel[240:], config=acfg,
                             device=dev)[0]

    init = init_adapter(torch.Generator().manual_seed(5))
    cpu = adapter(queries, 5, "cpu")
    norm = sum(float(((cpu[n] - init[n]) ** 2).sum()) for n in cpu) ** 0.5

    def distance(p):
        return sum(float(((p[n].cpu() - cpu[n]) ** 2).sum()) for n in cpu) ** 0.5 / norm

    card, control, other = (distance(adapter(queries, 5, cuda_device)),
                            distance(adapter(nudged, 5, "cpu")), distance(adapter(queries, 6, "cpu")))
    print(f"adapter lr 1e-3: update moved {_max_apart(cpu, init):.3g} at most; distance to "
          f"the CPU run: card {card:.3g}, CPU with inputs one ulp apart {control:.3g}, "
          f"seed 6 {other:.3g}")
    assert 0.0 < control and card <= 10 * control and other > 1.0


# ------------------------------------- the pool's MoE, VLM and codebook models
@pytest.mark.parametrize("arch", ["dbrx-132b", "llama-3.2-vision-90b", "musicgen-medium"])
def test_pool_family_with_kernels_equals_plain_on_the_card(cuda_device, arch):
    """Reduced model, float32: prefill + 4 decode steps with the kernels
    (rope_heads and flash on the fma route; the VLM's cross layers with
    causal=False in prefill and in every decode step) against the same with
    the plain versions, every cache entry too."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers, model as M
    from repro_torch.models.config import reduced

    cfg = reduced(get_config(arch))
    params = M.open_cross_gates(cfg, M.attention_at_d_model_fan_in(
        cfg, M.init(cfg, torch.Generator(cuda_device).manual_seed(0), cuda_device)))
    rng = np.random.default_rng(0)
    shape = (2, 40) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(cuda_device)
    img = torch.from_numpy(rng.normal(size=(2, cfg.n_image_tokens, cfg.d_model))
                           .astype(np.float32)).to(cuda_device)

    def run():
        batch = {"tokens": toks[:, :36]}
        if cfg.cross_attn_every:
            batch["image_embeds"] = img
        logits, cache = M.prefill(cfg, params, batch, max_cache_len=48)
        outs = [logits]
        for pos in range(36, 40):
            logits, cache = M.decode_step(cfg, params, cache,
                                          {"token": toks[:, pos:pos + 1], "pos": pos})
            outs.append(logits)
        return outs + [cache[key] for key in sorted(cache)]

    before = flash_kernel.launches
    with_kernels = run()
    torch.cuda.synchronize()
    n_cross = cfg.n_layers // cfg.cross_attn_every if cfg.cross_attn_every else 0
    assert flash_kernel.launches - before == cfg.n_layers + 4 * n_cross
    plain = layers.flash_attention, layers.rope_heads
    # attn_block passes use_kernel=None itself: override it
    layers.flash_attention = lambda *a, **kw: flash_attention(*a, **{**kw, "use_kernel": False})
    layers.rope_heads = lambda *a, **kw: rope_heads(*a, **{**kw, "use_kernel": False})
    try:
        with_plain = run()
    finally:
        layers.flash_attention, layers.rope_heads = plain
    for a, b in zip(with_kernels, with_plain):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)


# ------------------------------------------------------------ the training path
@pytest.mark.parametrize("arch", sorted(scenarios.GRAD_CASES))
def test_loss_grads_on_the_card_equal_the_cpus(cuda_device, arch):
    """`loss_fn`'s gradients of a reduced float32 model on the card against
    the same model on the CPU, leaf by leaf: ||g_card - g_cpu|| within
    1e-4 of ||g_cpu|| (1e-3 with an SSD scan on the path). Training takes
    the plain attention and scan, so no kernel launches."""
    from repro_torch import scenarios

    overrides, tol = scenarios.GRAD_CASES[arch]
    before = flash_kernel.launches, ssd_kernel.launches
    gaps = scenarios.grad_gaps(arch, cuda_device, overrides)
    torch.cuda.synchronize()
    assert (flash_kernel.launches, ssd_kernel.launches) == before
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= tol, (worst, gaps[worst])


def test_forward_with_grad_requiring_params_raises_on_the_card(cuda_device):
    """The kernels have no backward: on the card `forward` picks them, and
    a param that requires grad raises instead of losing its gradient. Under
    no_grad (serving) the kernels run as before; `use_kernel=False`
    differentiates."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.config import reduced

    cfg = reduced(get_config("hymba-1.5b"), sliding_window=16)
    params = tree_map(lambda t: t.to(cuda_device).requires_grad_(),
                      M.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))).to(cuda_device)}
    # the attention block's first kernel op refuses first
    with pytest.raises(ValueError, match="rope_heads: the kernel has no backward"):
        M.forward(cfg, params, batch)
    before = flash_kernel.launches, ssd_kernel.launches
    with torch.no_grad():
        served, _ = M.forward(cfg, params, batch)
    torch.cuda.synchronize()
    assert flash_kernel.launches == before[0] + cfg.n_layers
    assert ssd_kernel.launches == before[1] + 3 * cfg.n_layers
    trained, _ = M.forward(cfg, params, batch, use_kernel=False)
    assert trained.grad_fn is not None
    torch.testing.assert_close(served, trained.detach(), atol=1e-3, rtol=1e-3)


@pytest.fixture
def nccl_mesh(cuda_device):
    """A world-size-1 NCCL process group in this process and its (1, 1)
    ("data", "model") mesh; destroyed after the test."""
    import socket

    import torch.distributed as dist

    from repro_torch.common import meshctx

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    try:
        yield meshctx.make_mesh((1, 1), ("data", "model"), cuda_device)
    finally:
        dist.destroy_process_group()


def test_shard_map_moe_on_nccl_world_one_equals_gspmd(cuda_device, nccl_mesh):
    """At one rank the expert-parallel dispatch holds every expert and its
    all-reduce copies: the logits and the aux loss equal moe_block's."""
    import dataclasses

    from repro_torch.common import meshctx
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.config import reduced
    from repro_torch.models.moe_shard_map import shard_expert_params

    cfg = reduced(get_config("dbrx-132b"))
    params = M.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64))).to(cuda_device)
    with torch.no_grad():
        ref, ref_aux = M.forward(cfg, params, {"tokens": tokens})
        with meshctx.use_mesh(nccl_mesh):
            got, aux = M.forward(dataclasses.replace(cfg, moe_impl="shard_map"),
                                 shard_expert_params(cfg, params, nccl_mesh), {"tokens": tokens})
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(aux, ref_aux, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("arch", ["musicgen-medium", "hymba-1.5b"])
def test_seq_sharded_decode_on_nccl_world_one_equals_baseline(cuda_device, nccl_mesh, arch):
    """decode_attn="seq_shard" under a (1, 1) mesh: the flash-decoding
    combine over one rank's W slots gives the baseline decode's logits
    (reference tolerance 2e-3) and cache."""
    import dataclasses

    from repro_torch.common import meshctx, sharding
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.config import reduced
    from repro_torch.models.decode_shard_map import shard_decode_cache

    cfg = reduced(get_config(arch))
    params = M.init(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    b, s = 2, 32
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, shape))
    toks = toks.to(cuda_device)
    with torch.no_grad():
        _, cache = M.prefill(cfg, params, {"tokens": toks[:, :s - 1]}, max_cache_len=s)
        seq = dataclasses.replace(cfg, decode_attn="seq_shard")
        with meshctx.use_mesh(nccl_mesh), sharding.set_policy("tp_kvs"):
            local = shard_decode_cache(seq, cache, nccl_mesh)
            got, local = M.decode_step(seq, params, local, {"token": toks[:, s - 1:], "pos": s - 1})
        ref, cache = M.decode_step(cfg, params, cache, {"token": toks[:, s - 1:], "pos": s - 1})
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=0)
    torch.testing.assert_close(local["k"], cache["k"], atol=1e-3, rtol=0)
