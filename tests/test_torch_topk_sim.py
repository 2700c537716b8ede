"""Parity of the port's fused similarity + top-K op with the JAX reference.

The same numpy inputs (made from a seed) go through the JAX oracle
(`repro.kernels.topk_sim.ref.topk_sim_ref`), the Pallas kernel in
interpret mode, and the port's plain version and public op on CPU tensors.
Indices must be exactly equal (ties to the lowest index), scores within
atol=1e-5, the tolerance `tests/test_kernels.py` uses for top-K (float32,
different summation orders). The CUDA kernel itself is held against the
plain version on the card in `tests/test_torch_cuda.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.topk_sim.kernel import topk_sim_pallas
from repro.kernels.topk_sim.ref import topk_sim_ref as jax_topk_sim_ref
from repro_torch.core.retrieval import NEG_INF, stable_topk
from repro_torch.kernels.topk_sim import kernel as cuda_kernel
from repro_torch.kernels.topk_sim.ops import topk_sim
from repro_torch.kernels.topk_sim.ref import topk_sim_ref


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def _rand(rng, q, t, d):
    qe = _unit(rng.normal(size=(q, d))).astype(np.float32)
    te = _unit(rng.normal(size=(t, d))).astype(np.float32)
    return qe, te


def _all_paths(qe, te, k, pallas=True):
    """{name: (scores, idx)} as numpy for every implementation."""
    out = {
        "jax_ref": jax_topk_sim_ref(jnp.asarray(qe), jnp.asarray(te), k),
        "torch_ref": topk_sim_ref(torch.from_numpy(qe), torch.from_numpy(te), k),
        "torch_op": topk_sim(torch.from_numpy(qe), torch.from_numpy(te), k),
    }
    if pallas:
        out["pallas"] = topk_sim_pallas(jnp.asarray(qe), jnp.asarray(te), k, interpret=True)
    return {n: (np.asarray(s), np.asarray(i)) for n, (s, i) in out.items()}


def _assert_agree(paths, atol=1e-5):
    rs, ri = paths["jax_ref"]
    for name, (s, i) in paths.items():
        np.testing.assert_allclose(s, rs, atol=atol, err_msg=name)
        np.testing.assert_array_equal(i, ri, err_msg=name)


@pytest.mark.parametrize(
    "q,t,d,k",
    [(7, 199, 384, 5), (1, 50, 384, 10), (128, 2413, 384, 25), (33, 513, 256, 3)],
)
def test_topk_sim_shapes_match_jax(q, t, d, k):
    qe, te = _rand(np.random.default_rng(q * 1000 + t), q, t, d)
    _assert_agree(_all_paths(qe, te, k))


def test_topk_sim_tie_handling_matches_jax():
    """One-hot table rows tiled 70 times: every copy of a query's best row
    ties bitwise, so lowest-index-first order is the only right answer."""
    d = 128
    base = np.zeros((9, d), np.float32)
    base[np.arange(9), np.arange(9)] = 1.0
    te = np.tile(base, (70, 1))
    qe = _unit(np.random.default_rng(1).normal(size=(4, d))).astype(np.float32)
    paths = _all_paths(qe, te, 8)
    _assert_agree(paths, atol=1e-6)
    best = np.argmax(qe[:, :9], axis=1)
    expected = best[:, None] + 9 * np.arange(8)[None, :]
    np.testing.assert_array_equal(paths["torch_op"][1], expected)


@pytest.mark.parametrize("t,k", [(513, 10), (37, 20), (512, 5)])
def test_topk_sim_padded_tail_matches_jax(t, k):
    """The Pallas kernel pads T to a 512-row tile; no padded row may
    surface, and the port (which pads nothing) must agree with it."""
    qe, te = _rand(np.random.default_rng(t), 6, t, 384)
    paths = _all_paths(qe, te, k)
    _assert_agree(paths)
    s, i = paths["torch_op"]
    assert ((i >= 0) & (i < t)).all()
    assert (s > NEG_INF / 2).all()


@given(st.integers(1, 40), st.integers(30, 200), st.integers(1, 8), st.integers(0, 99))
@settings(max_examples=15, deadline=None)
def test_topk_sim_property_matches_jax(q, t, k, seed):
    qe, te = _rand(np.random.default_rng(seed), q, t, 64)
    paths = _all_paths(qe, te, k, pallas=False)
    _assert_agree(paths)
    s, i = paths["torch_op"]
    assert (np.diff(s, axis=1) <= 0).all()
    assert ((i >= 0) & (i < t)).all()


def test_topk_sim_op_rejects_bad_inputs():
    q = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        topk_sim(q, torch.zeros((4, 8)), 5)  # k > T, as lax.top_k refuses
    with pytest.raises(ValueError):
        topk_sim(q, torch.zeros((4, 8), device="meta"), 2)  # mixed devices
    with pytest.raises(ValueError):
        cuda_kernel.topk_sim_cuda(q, torch.zeros((4, 8)), 2)  # CPU tensors


@pytest.mark.parametrize("k,want", [(1, 1), (2, 2), (129, 256), (130, 256), (4096, 4096),
                                    (4097, 8192), (100_000, 131_072)])
def test_select_sort_len_is_the_next_power_of_two(k, want):
    """The select route's bitonic sort runs over k rounded up to a power of
    two, in shared memory up to SEL_SMEM_KEYS keys, in a scratch above."""
    assert cuda_kernel.select_sort_len(k) == want


@pytest.mark.parametrize("d", [1, 130, 384, 1025, 1536, 4096])
def test_select_plan_covers_and_fits(d):
    """The select route's plan: pass 1's tiles cover every row and query,
    a thread a 4 x 4 micro-tile and at least one warp a block, the grid at
    least one block an SM wherever some tile reaches that; pass 2's cluster
    of 1-16 blocks holds every key in shared memory unless the slices
    outgrow it; both passes within 227 KB of shared memory."""
    n_sms = 132
    for n_q, n_t in [(1, 1), (1, 2413), (8, 2413), (64, 2413), (33, 100_003), (1, 100_003),
                     (8, 100_003), (64, 100_000), (500, 7000), (3, 1_000_003)]:
        for k in (129, 130, 4096, 4097):
            if k > n_t:
                continue
            plan = cuda_kernel.select_plan(n_q, n_t, d, k, n_sms)
            assert (plan.bq, plan.br) in cuda_kernel.SEL_TILES
            assert 32 <= plan.bq * plan.br // 16 <= 256
            assert plan.bq <= max(8, cuda_kernel.pow2_bucket(n_q))
            gx, gy = plan.grid
            assert (gx - 1) * plan.br < n_t <= gx * plan.br
            assert (gy - 1) * plan.bq < n_q <= gy * plan.bq
            reach = max(-(-n_t // br) * -(-n_q // bq) for bq, br in cuda_kernel.SEL_TILES
                        if bq <= max(8, cuda_kernel.pow2_bucket(n_q)))
            assert gx * gy >= min(n_sms, reach)
            assert 1 <= plan.stages <= min(cuda_kernel.SEL_MAX_STAGES, -(-d // cuda_kernel.SEL_DC))
            assert 2 * plan.scores_smem <= 227 * 1024  # two blocks an SM
            assert plan.cs in (1, 2, 4, 8, 16)
            per = -(-n_t // plan.cs)
            assert 1 <= plan.cap <= per
            assert plan.threads == (1024 if per >= cuda_kernel.SEL_BIG_SLICE else 512)
            if plan.cap < per:  # streams only what the cluster's shared memory cannot hold
                assert plan.cs == cuda_kernel.SEL_MAX_CS
            if plan.cs > 1:  # a cluster spreads a query only while the grid stays in one wave
                assert n_q * plan.cs <= n_sms or plan.cap < -(-n_t // (plan.cs // 2))
            assert plan.scores_smem <= 227 * 1024 and plan.topk_smem <= 227 * 1024
    # the re-ranker's shape fills a wave of the card in pass 1 (not 19 x 8 blocks of 4 warps)
    plan = cuda_kernel.select_plan(64, 2413, 384, 130, n_sms)
    assert plan.grid[0] * plan.grid[1] >= n_sms and plan.cs == 1


def _score_keys(s):
    """topk_sim.cu's `score_key`: a score's order-preserving 32 bits, -0.0
    folded into +0.0."""
    u = np.ascontiguousarray(s, np.float32).view(np.uint32).copy()
    u[(u << np.uint32(1)) == 0] = 0
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def _select_model(s, k):
    """The select route's pass 2 on one row of scores, in numpy: four 8-bit
    radix passes over the 32 score bits find the k-th largest score (a pass
    that leaves as many matching keys as are still wanted ends the search);
    every key above it goes in and, of the keys equal to it, the lowest
    rows; the survivors sorted by score, then row."""
    keys = _score_keys(s)
    prefix, mask, remaining = 0, 0, k
    for shift in (24, 16, 8, 0):
        hist = np.bincount((keys[(keys & mask) == prefix] >> shift) & 255, minlength=256)
        from_top = np.cumsum(hist[::-1])
        b = 255 - int(np.argmax(from_top >= remaining))
        remaining -= int(from_top[255 - b] - hist[b])
        prefix, mask = prefix | b << shift, mask | 255 << shift
        if remaining == hist[b]:
            break
    equal = np.flatnonzero((keys & mask) == prefix)
    taken = np.concatenate([np.flatnonzero(keys > (prefix | (~mask & 0xFFFFFFFF))),
                            equal[:remaining]])
    idx = taken[np.lexsort((taken, ~keys[taken]))]
    return s[idx], idx


@pytest.mark.parametrize("case", ["repeated", "signed_zero", "all_equal", "ulp_apart"])
def test_select_tie_rule_matches_lax_top_k(case):
    """The select route's tie rule (a 32-bit score radix select, then the
    lowest rows among the keys equal to the threshold) gives lax.top_k's
    order on tie-heavy rows. The kernel folds -0.0 into +0.0 as a float
    compare does, and lax.top_k on the CPU orders +0.0 above -0.0; so with
    signed zeros the rows agree with lax.top_k's over the row with -0.0 made
    +0.0, with its values as floats, and with the port's plain version (a
    stable sort). The kernel's FMA chains start at +0.0 and never yield -0.0."""
    rng = np.random.default_rng(24)
    n = 5000
    if case == "repeated":  # five distinct scores
        rows = (rng.integers(-2, 3, size=(4, n)) / 4).astype(np.float32)
    elif case == "signed_zero":
        rows = rng.choice(np.array([-0.0, 0.0, 0.0, -0.0, 0.5, -0.5], np.float32), size=(4, n))
    elif case == "all_equal":
        rows = np.stack([np.full(n, v, np.float32) for v in (0.0, 0.25, -1.0)])
    else:  # scores a few ulps apart: the threshold sits in the low byte
        ulp = np.spacing(np.float32(0.5))
        rows = (np.float32(0.5) + rng.integers(0, 4, size=(4, n)) * ulp).astype(np.float32)
    canon = np.where(rows == 0, np.float32(0.0), rows)  # -0.0 made +0.0
    for k in (1, 130, 300, 4097, n):
        ref_s, _ = jax.lax.top_k(jnp.asarray(rows), k)
        _, ref_i = jax.lax.top_k(jnp.asarray(canon), k)
        plain_s, plain_i = stable_topk(torch.from_numpy(rows), k)
        for r, row in enumerate(rows):
            s, i = _select_model(row, k)
            np.testing.assert_array_equal(i, np.asarray(ref_i[r]), err_msg=f"{case} k={k}")
            np.testing.assert_array_equal(i, plain_i[r].numpy())
            np.testing.assert_array_equal(s, np.asarray(ref_s[r]))  # -0.0 == +0.0
            np.testing.assert_array_equal(s, plain_s[r].numpy())
    if case == "all_equal":
        np.testing.assert_array_equal(_select_model(rows[0], 300)[1], np.arange(300))


def test_split_plan_covers_the_table():
    """Pass 1's slices tile the table exactly, every slice non-empty, and
    pass 2's candidate count stays within what it merges in shared memory."""
    for n_q, n_t, k in [(1, 2413, 5), (8, 2413, 25), (64, 100_000, 25),
                        (128, 100_000, 5), (33, 100_003, 25), (4, 630, 8),
                        (3, 5, 5), (1, 100_000, 128)]:
        qb, n_split, rows = cuda_kernel.split_plan(n_q, n_t, k, n_sms=132)
        assert qb == (8 if n_q <= 8 else 32)
        assert rows % cuda_kernel.TB == 0
        assert (n_split - 1) * rows < n_t <= n_split * rows
        assert n_split * k <= cuda_kernel.MAX_CAND


@pytest.mark.parametrize("n_q,n_t,d,k,offset,want", [
    (8, 2413, 384, 25, 0, "cluster"),  # the pool's admission shape
    (64, 2413, 384, 25, 0, "cluster"),  # the re-ranker's batch
    (1, 300, 384, 128, 0, "cluster"),
    (8, cuda_kernel.CLUSTER_MAX_T, 384, 25, 0, "cluster"),  # the reach, inclusive
    (8, cuda_kernel.CLUSTER_MAX_T + 1, 384, 25, 0, "split"),  # below WGMMA_MIN_Q
    (16, cuda_kernel.CLUSTER_MAX_T + 1, 384, 20, 0, "wgmma"),  # Q * k = 320, the reach
    (16, cuda_kernel.CLUSTER_MAX_T + 1, 384, 25, 0, "split"),  # Q * k = 400: the wgmma route lost
    (64, 100_000, 384, 5, 0, "wgmma"),  # the serving table, batch 64
    (8, 100_000, 384, 5, 0, "split"),  # batch 8: below WGMMA_MIN_Q, the measured crossover
    (cuda_kernel.WGMMA_MIN_Q, 100_000, 384, 5, 0, "wgmma"),
    (16, 100_003, 384, cuda_kernel.WGMMA_MAX_K, 0, "split"),  # Q * k = 512, past the crossover
    (64, 100_000, 384, 25, 0, "split"),  # Q * k past the measured crossover
    (33, 100_003, 384, cuda_kernel.WGMMA_MAX_K, 0, "split"),
    (8, 2413, 130, 25, 0, "split"),  # rows are not whole 16-byte units
    (8, 2413, 384, 25, 1, "split"),  # a table base off a 16-byte boundary
    (64, 2413, 1024, 128, 0, "split"),  # no two-stage ring fits shared memory
    (64, 100_000, 130, 5, 0, "split"),  # no TMA row of whole 16-byte units
    (64, 100_000, 384, 5, 1, "split"),
    (64, 100_000, 384, cuda_kernel.WGMMA_MAX_K + 1, 0, "split"),  # k above the filter's
    (65, 100_000, 384, 5, 0, "split"),  # more queries than one block holds
    (16, 100_000, 16, 5, 0, "split"),  # D under one 32-column box
    (8, 2413, 384, 129, 0, "select"),  # k past MAX_K: only the select route takes it
    (64, 2413, 384, 130, 0, "select"),  # the re-ranker's C = 5k at k = 26
    (64, 7000, 384, 7000, 1, "select"),  # k = T, misaligned
    (8, 2413, 1025, 5, 0, "select"),  # D past MAX_D
    (33, 7000, 1536, 25, 0, "select"),
])
def test_topk_route_picks_by_shape_and_alignment(n_q, n_t, d, k, offset, want):
    """`topk_route` is decided before launch from shape and alignment alone
    (pure Python: it runs here), and agrees with the shared-memory sizing."""
    flat = torch.zeros(n_t * d + 4)
    table = flat[offset:offset + n_t * d].view(n_t, d)
    queries = torch.zeros((n_q, d))
    assert cuda_kernel.topk_route(n_q, n_t, d, k, table, queries) == want
    qb = cuda_kernel.cluster_qb(n_q)
    stages = cuda_kernel.cluster_stages(qb, d, k)
    fits = stages >= 2 and cuda_kernel.cluster_smem_bytes(qb, d, k, stages) <= 227 * 1024
    if want == "cluster":
        assert fits and d % 4 == 0
    assert cuda_kernel.cluster_qb(n_q) == (8 if n_q <= 8 else cuda_kernel.CLUSTER_QB)
    if want == "wgmma":
        n, _, _, stages = cuda_kernel.wgmma_plan(n_q, n_t, d, k, n_sms=132)
        assert n_t > cuda_kernel.CLUSTER_MAX_T and d % 4 == 0 and n >= n_q
        assert n_q >= cuda_kernel.WGMMA_MIN_Q and n_q * k <= cuda_kernel.WGMMA_MAX_QK
        assert stages >= 4 and cuda_kernel.wgmma_smem_bytes(n, d, k, stages) <= 227 * 1024
    assert cuda_kernel.can_take(want, queries, table, k)
    # the select route takes whatever the wrapper accepts, and only it takes k > MAX_K
    # or D > MAX_D
    assert cuda_kernel.can_take("select", queries, table, k)
    assert (want == "select") == (k > cuda_kernel.MAX_K or d > cuda_kernel.MAX_D)
    assert (want == "select") != cuda_kernel.can_take("split", queries, table, k)


@pytest.mark.parametrize("n_t", [cuda_kernel.CLUSTER_MAX_T + 1, 16_384, 100_000, 100_003])
def test_wgmma_plan_covers_the_table(n_t):
    """The wgmma route's slices are whole 64-row tiles that tile the table
    exactly, about one block per SM, n_split * k within what pass 2 merges,
    and a ring of at least four boxes within 227 KB of shared memory for
    every Q <= 64 and k <= WGMMA_MAX_K at D = 384."""
    for n_q in range(1, cuda_kernel.WGMMA_MAX_Q + 1):
        for k in range(1, cuda_kernel.WGMMA_MAX_K + 1):
            n, n_split, rows, stages = cuda_kernel.wgmma_plan(n_q, n_t, 384, k, n_sms=132)
            assert n in (8, 16, 32, 64) and n_q <= n <= max(2 * n_q - 2, 8)
            assert rows % cuda_kernel.WROWS == 0
            assert (n_split - 1) * rows < n_t <= n_split * rows
            assert n_split <= 132 and n_split * k <= cuda_kernel.MAX_CAND
            assert cuda_kernel.WMIN_STAGES <= stages <= cuda_kernel.WMAX_STAGES
            assert cuda_kernel.wgmma_smem_bytes(n, 384, k, stages) <= 227 * 1024
            assert (cuda_kernel.wgmma_smem_bytes(n, 384, k, stages + 1) > 227 * 1024
                    or stages == cuda_kernel.WMAX_STAGES)


def _tf32(x):
    """float32 read as TF32 by the tensor cores: the low 13 mantissa bits dropped."""
    return (np.ascontiguousarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _fma_chain(q, t):
    """Each row pair's float32 FMA chain over d = 0..D-1, the split route's
    order (a float64 product is exact, then one rounding to float32)."""
    s = np.zeros(q.shape[0], np.float32)
    for j in range(q.shape[1]):
        s = (q[:, j].astype(np.float64) * t[:, j] + s).astype(np.float32)
    return s


def _tensor_core(q, t):
    """A tensor-core-like score: the exact products of the TF32 operands,
    summed in float32 in blocks of eight, the blocks added in order."""
    prod = _tf32(q).astype(np.float64) * _tf32(t)
    blocks = prod.reshape(q.shape[0], -1, 8).sum(axis=2).astype(np.float32)
    s = np.zeros(q.shape[0], np.float32)
    for j in range(blocks.shape[1]):
        s = s + blocks[:, j]
    return s


@pytest.mark.parametrize("case", ["gaussian", "unit", "wide_range", "worst_truncation"])
@pytest.mark.parametrize("d", [32, 384, 1024])
def test_wgmma_margin_bounds_the_tf32_error(case, d):
    """|TF32 tensor-core score - float32 FMA chain| <= coef |q| |t| +
    abs_coef (|q| + |t| + 1) on random inputs in numpy, and with every
    operand's 13 dropped bits set (the largest truncation) and t = q, where
    the bound is nearly reached: the margin is a bound, not a tuned tolerance."""
    rng = np.random.default_rng(d)
    n = 512
    if case == "worst_truncation":
        mant = np.uint32(0x3F800000 | 0x1FFF)  # 1 + (2^13 - 1) 2^-23
        one = np.array([mant], np.uint32).view(np.float32)[0]
        sign = np.where(rng.random((n, d)) < 0.5, -1, 1).astype(np.float32)
        # t = q: every product |q_d|^2 > 0, so sum|qt| = |q| |t| (Cauchy-Schwarz's equality)
        q = one * np.exp2(rng.integers(-3, 3, (n, d))).astype(np.float32) * sign
        t = q.copy()
    elif case == "wide_range":
        q = (rng.normal(size=(n, d)) * np.exp(rng.normal(size=(n, d)) * 4)).astype(np.float32)
        t = (rng.normal(size=(n, d)) * np.exp(rng.normal(size=(n, d)) * 4)).astype(np.float32)
    else:
        q = rng.normal(size=(n, d)).astype(np.float32)
        t = rng.normal(size=(n, d)).astype(np.float32)
        if case == "unit":
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            t /= np.linalg.norm(t, axis=1, keepdims=True)
    coef, abs_coef = cuda_kernel.margin_coefs(d)
    qn = np.linalg.norm(q.astype(np.float64), axis=1)
    tn = np.linalg.norm(t.astype(np.float64), axis=1)
    bound = coef * qn * tn + abs_coef * (qn + tn + 1)
    err = np.abs(_tensor_core(q, t).astype(np.float64) - _fma_chain(q, t))
    ratio = float((err / bound).max())
    assert ratio <= 1.0, ratio
    if case == "worst_truncation":  # the bound's TF32 term, 2^-9 |q| |t|, is reached
        assert float((err / (qn * tn)).max()) > 0.99 * 2.0**-9, ratio
