"""OATS-S1 in the port against the JAX package: outcome logs, the Alg. 1
refinement, the validation gate and the batched retrieval metrics.

The same numpy inputs (made from a seed) go through `repro` and
`repro_torch` on the CPU. Outcome masks and retrieved indices must be
exactly equal, with and without candidate masks (where the `-1e30` slots
tie and the port's stable top-K must take them lowest index first, as
`lax.top_k` does); every refined table within atol=1e-5 (the JAX tests'
tolerance); gate metrics within 1e-6 and the same gate decision.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.outcomes import collect_outcomes as jax_collect_outcomes
from repro.core.outcomes import masks_from_stream as jax_masks_from_stream
from repro.core.refine import RefineConfig as JaxRefineConfig
from repro.core.refine import refine_embeddings as jax_refine_embeddings
from repro.core.refine import refine_with_gate as jax_refine_with_gate
from repro.metrics import retrieval as jax_metrics
from repro_torch.core.outcomes import collect_outcomes, masks_from_stream
from repro_torch.core.refine import RefineConfig, refine_embeddings, refine_with_gate
from repro_torch.metrics import retrieval as metrics

TOL = dict(atol=1e-5, rtol=0)


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def _random_world(seed, q=40, t=12, d=32):
    rng = np.random.default_rng(seed)
    qe = _unit(rng.normal(size=(q, d))).astype(np.float32)
    te = _unit(rng.normal(size=(t, d))).astype(np.float32)
    rel = np.zeros((q, t), np.float32)
    rel[np.arange(q), rng.integers(0, t, q)] = 1.0
    return qe, te, rel


def _candidate_mask(rel, seed, density=0.4, short_rows=0):
    """A mask that always admits the relevant tools; the first `short_rows`
    rows admit only them (fewer candidates than k)."""
    rng = np.random.default_rng(seed)
    mask = ((rng.random(rel.shape) < density) | (rel > 0)).astype(np.float32)
    mask[:short_rows] = rel[:short_rows]
    return mask


def _both(*arrays):
    """(jnp arrays, torch tensors) of the same numpy arrays (None stays)."""
    return ([None if a is None else jnp.asarray(a) for a in arrays],
            [None if a is None else torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


# ------------------------------------------------------------- outcome logs
@pytest.mark.parametrize("positives", ["ground_truth", "retrieved"])
@pytest.mark.parametrize("masked", ["none", "mask", "short"])
def test_collect_outcomes_matches_jax(masked, positives):
    qe, te, rel = _random_world(1, q=50, t=20)
    mask = None if masked == "none" else _candidate_mask(
        rel, 2, short_rows=10 if masked == "short" else 0)
    (jq, jt, jr, jm), (tq, tt, tr, tm) = _both(qe, te, rel, mask)
    a = jax_collect_outcomes(jq, jt, jr, jm, k=5, positives=positives)
    b = collect_outcomes(tq, tt, tr, tm, k=5, positives=positives)
    np.testing.assert_array_equal(b.retrieved.numpy(), np.asarray(a.retrieved))
    np.testing.assert_array_equal(b.pos_mask.numpy(), np.asarray(a.pos_mask))
    np.testing.assert_array_equal(b.neg_mask.numpy(), np.asarray(a.neg_mask))
    np.testing.assert_array_equal(b.pos_counts.numpy(), np.asarray(a.pos_counts))
    np.testing.assert_array_equal(b.neg_counts.numpy(), np.asarray(a.neg_counts))
    if masked == "short":
        # one candidate, k = 5: four -1e30 slots, taken lowest index first
        retrieved = b.retrieved.numpy()
        for j in range(10):
            others = [t for t in range(20) if mask[j, t] == 0][:4]
            assert sorted(retrieved[j, 1:].tolist()) == others
        assert b.neg_mask.numpy()[:10].sum() == 40


def test_collect_outcomes_with_fewer_tools_than_k():
    qe, te, rel = _random_world(3, q=6, t=3)
    (jq, jt, jr, _), (tq, tt, tr, _) = _both(qe, te, rel, None)
    a = jax_collect_outcomes(jq, jt, jr, k=5)
    b = collect_outcomes(tq, tt, tr, k=5)
    assert b.retrieved.shape == (6, 3)
    np.testing.assert_array_equal(b.retrieved.numpy(), np.asarray(a.retrieved))
    np.testing.assert_array_equal(b.neg_mask.numpy(), np.asarray(a.neg_mask))


def test_outcome_partition_semantics():
    qe, te, rel = _random_world(0)
    logs = collect_outcomes(*(torch.from_numpy(x) for x in (qe, te, rel)), k=5)
    pos, neg = logs.pos_mask.numpy(), logs.neg_mask.numpy()
    assert (pos == rel).all()
    assert (neg * rel).sum() == 0
    retrieved = logs.retrieved.numpy()
    for j in range(neg.shape[0]):
        for t_id in np.flatnonzero(neg[j]):
            assert t_id in retrieved[j]


@pytest.mark.parametrize("n_events", [0, 1, 300])
def test_masks_from_stream_matches_jax(n_events):
    rng = np.random.default_rng(n_events)
    qi = rng.integers(0, 30, n_events)
    ti = rng.integers(0, 9, n_events)
    out = rng.integers(0, 2, n_events)
    a = jax_masks_from_stream(qi, ti, out, 30, 9)
    b = masks_from_stream(qi, ti, out, 30, 9)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)
        assert y.dtype == x.dtype
    assert (b[0] * b[1]).sum() == 0


# --------------------------------------------------------------- refinement
@pytest.mark.parametrize("keep_history", [True, False])
@pytest.mark.parametrize("positives", ["ground_truth", "retrieved"])
@pytest.mark.parametrize("masked", [False, True])
def test_refine_embeddings_matches_jax(keep_history, positives, masked):
    qe, te, rel = _random_world(4, q=80, t=24, d=48)
    mask = _candidate_mask(rel, 5, short_rows=6) if masked else None
    (jq, jt, jr, jm), (tq, tt, tr, tm) = _both(qe, te, rel, mask)
    kw = dict(positives=positives, keep_history=keep_history)
    a = np.asarray(jax_refine_embeddings(jt, jq, jr, jm, **kw))
    b = refine_embeddings(tt, tq, tr, tm, **kw)
    assert b.shape == a.shape == ((4, 24, 48) if keep_history else (24, 48))
    if keep_history:
        for n in range(4):  # every iteration's table
            np.testing.assert_allclose(b[n].numpy(), a[n], **TOL)
        np.testing.assert_array_equal(b[0].numpy(), te)
    else:
        np.testing.assert_allclose(b.numpy(), a, **TOL)


def test_refine_embeddings_momentum_and_iterations_match_jax():
    qe, te, rel = _random_world(6, q=60, t=15)
    (jq, jt, jr, _), (tq, tt, tr, _) = _both(qe, te, rel, None)
    for kw in (dict(iterations=1), dict(iterations=5, momentum=0.0),
               dict(alpha=0.6, beta=0.0, momentum=0.9), dict(k=1)):
        a = np.asarray(jax_refine_embeddings(jt, jq, jr, **kw))
        b = refine_embeddings(tt, tq, tr, **kw).numpy()
        np.testing.assert_allclose(b, a, **TOL, err_msg=str(kw))


@given(st.integers(0, 500))
@settings(max_examples=20, deadline=None)
def test_refined_embeddings_stay_unit_norm(seed):
    qe, te, rel = _random_world(seed)
    hist = refine_embeddings(*(torch.from_numpy(x) for x in (te, qe, rel)))
    norms = np.linalg.norm(hist[-1].numpy(), axis=-1)
    assert np.allclose(norms, 1.0, atol=1e-5)


def test_refinement_moves_toward_positive_centroid():
    """A tool with a tight positive cluster must move toward it (Eq. 7)."""
    rng = np.random.default_rng(3)
    d = 32
    target = _unit(rng.normal(size=d))
    qe = _unit(target + 0.2 * _unit(rng.normal(size=(12, d)))).astype(np.float32)
    te = _unit(rng.normal(size=(2, d))).astype(np.float32)
    rel = np.zeros((12, 2), np.float32)
    rel[:, 0] = 1.0
    hist = refine_embeddings(*(torch.from_numpy(x) for x in (te, qe, rel)))
    before = float(qe.mean(0) @ te[0])
    after = float(qe.mean(0) @ hist[-1].numpy()[0])
    assert after > before


# --------------------------------------------------------------------- gate
def _gate_pair(te, q_tr, r_tr, q_va, r_va, cfg, m_tr=None, m_va=None):
    (jt, jqt, jrt, jqv, jrv, jmt, jmv), (tt, tqt, trt, tqv, trv, tmt, tmv) = _both(
        te, q_tr, r_tr, q_va, r_va, m_tr, m_va)
    a = jax_refine_with_gate(jt, jqt, jrt, jqv, jrv, JaxRefineConfig(**cfg), jmt, jmv)
    b = refine_with_gate(tt, tqt, trt, tqv, trv, RefineConfig(**cfg), tmt, tmv)
    assert bool(b.accepted) == bool(a.accepted)
    np.testing.assert_allclose(float(b.recall_before), float(a.recall_before), atol=1e-6)
    np.testing.assert_allclose(float(b.recall_after), float(a.recall_after), atol=1e-6)
    np.testing.assert_allclose(b.embeddings.numpy(), np.asarray(a.embeddings), **TOL)
    assert (b.history is None) == (a.history is None)
    if b.history is not None:
        np.testing.assert_allclose(b.history.numpy(), np.asarray(a.history), **TOL)
    return a, b


@pytest.mark.parametrize("keep_history", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("gate_metric", ["recall", "ndcg"])
def test_refine_with_gate_matches_jax(gate_metric, masked, keep_history):
    qe, te, rel = _random_world(8, q=90, t=20)
    mask = _candidate_mask(rel, 9) if masked else None
    tr, va = slice(0, 70), slice(70, 90)
    _gate_pair(te, qe[tr], rel[tr], qe[va], rel[va],
               dict(gate_metric=gate_metric, keep_history=keep_history),
               None if mask is None else mask[tr], None if mask is None else mask[va])


@pytest.mark.parametrize("seed", range(5))
def test_validation_gate_never_degrades(seed):
    """Gate invariant (§4.1 step 5): deployed table >= static on val recall."""
    qe, te, rel = _random_world(seed, q=60)
    tr, va = slice(0, 45), slice(45, 60)
    _, res = _gate_pair(te, qe[tr], rel[tr], qe[va], rel[va], {})
    assert float(res.recall_after) >= float(res.recall_before) or not bool(res.accepted)
    if not bool(res.accepted):
        assert np.allclose(res.embeddings.numpy(), te, atol=1e-6)


def test_gate_rejects_adversarial_refinement():
    """Train labels decorrelated from queries: the gate rejects, or at least
    does not deploy a worse table; both packages decide alike."""
    qe, te, rel = _random_world(7, q=80)
    rel_shuffled = rel.copy()
    np.random.default_rng(0).shuffle(rel_shuffled, axis=0)
    _, res = _gate_pair(te, qe[:60], rel_shuffled[:60], qe[60:], rel[60:], {})
    if bool(res.accepted):
        assert float(res.recall_after) >= float(res.recall_before)


@pytest.mark.parametrize("case,gate_metric", [("k_is_T", "recall"), ("no_relevant", "recall"),
                                              ("no_relevant", "ndcg")])
def test_gate_accepts_an_exact_tie(case, gate_metric):
    """The held-out metric ties exactly, before and after: with k = T every
    tool is retrieved (Recall@K is 1 on both tables), and held-out queries
    with no relevant tool score 0 on both. `>=` accepts the refined table
    in both packages."""
    qe, te, rel = _random_world(11, q=40, t=5)
    val_rel = rel[30:] if case == "k_is_T" else np.zeros_like(rel[30:])
    a, b = _gate_pair(te, qe[:30], rel[:30], qe[30:], val_rel,
                      dict(k=5, gate_metric=gate_metric))
    assert float(b.recall_before) == float(b.recall_after)
    assert float(b.recall_after) == (1.0 if case == "k_is_T" else 0.0)
    assert bool(b.accepted) and bool(a.accepted)
    assert not np.allclose(b.embeddings.numpy(), te, atol=1e-6)


# ------------------------------------------------------------------ metrics
def _rankings(seed, q=30, t=15, k=5, empty_rows=4):
    rng = np.random.default_rng(seed)
    rel = (rng.random((q, t)) < 0.15).astype(np.float32)
    rel[:empty_rows] = 0.0  # queries with no relevant tool: left out of the mean
    rk = np.stack([rng.permutation(t)[:k] for _ in range(q)]).astype(np.int32)
    return rk, rel


@pytest.mark.parametrize("k", [1, 3, 5, 15])
def test_batched_metrics_match_jax(k):
    rk, rel = _rankings(k, k=k)
    for name in ("batched_recall_at_k", "batched_ndcg_at_k"):
        a = float(getattr(jax_metrics, name)(jnp.asarray(rk), jnp.asarray(rel)))
        b = getattr(metrics, name)(torch.from_numpy(rk), torch.from_numpy(rel))
        assert b.dtype == torch.float32 and b.dim() == 0
        np.testing.assert_allclose(float(b), a, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("name", ["batched_recall_at_k", "batched_ndcg_at_k"])
def test_batched_metrics_do_not_depend_on_query_order(name):
    """The mean is summed exactly, so any order of the queries (a device's
    reduction order) gives the same float32 bits, and an exact tie between
    two rankings with the same per-query values in other places stays one."""
    rk, rel = _rankings(3, q=500, t=40, k=5)
    fn = getattr(metrics, name)
    base = fn(torch.from_numpy(rk), torch.from_numpy(rel))
    for seed in range(5):
        perm = np.random.default_rng(seed).permutation(len(rk))
        again = fn(torch.from_numpy(rk[perm]), torch.from_numpy(rel[perm]))
        assert torch.equal(again, base)


def test_per_query_metrics_are_the_reference():
    rk, rel = _rankings(0, k=10)
    for j in range(rk.shape[0]):
        relevant = np.flatnonzero(rel[j])
        assert metrics.evaluate_ranking(rk[j], relevant) == jax_metrics.evaluate_ranking(
            rk[j], relevant)
        assert metrics.mrr(rk[j], relevant) == jax_metrics.mrr(rk[j], relevant)
    assert metrics.precision_at_k([1, 2], [1], 0) == 0.0
