"""Parity of the port's fused similarity + top-K op with the JAX reference.

The same numpy inputs (made from a seed) go through the JAX oracle
(`repro.kernels.topk_sim.ref.topk_sim_ref`), the Pallas kernel in
interpret mode, and the port's plain version and public op on CPU tensors.
Indices must be exactly equal (ties to the lowest index), scores within
atol=1e-5, the tolerance `tests/test_kernels.py` uses for top-K (float32,
different summation orders). The CUDA kernel itself is held against the
plain version on the card in `tests/test_torch_cuda.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.topk_sim.kernel import topk_sim_pallas
from repro.kernels.topk_sim.ref import topk_sim_ref as jax_topk_sim_ref
from repro_torch.core.retrieval import NEG_INF
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
