"""The port's online control plane against the JAX package's.

The same table, the same queries and the same outcome stream go through
both packages' `OutcomeStore`, `RefinementController` and `TableGuard`,
each serving through its own `SemanticRouter` on the CPU: the §7.2 loop
(route windows of train queries, record every routed tool's outcome,
`step()`), then the injected bad table of `examples/live_loop.py`'s act 2,
which the guard must roll back. Every `ControllerReport` field must be
equal (`recall_before`/`recall_after` within 1e-6), the refined tables
within 1e-5, the guard's actions and the bus's event kinds equal and in
the same order, and the store's refinement batch equal exactly.

The rest mirrors `tests/test_control.py` as port cases: the store's ring,
masks and persistence, the controller's triggers and gate, the guard's
rollback and its compare-and-swap, the daemon loop, and `route_batch`
under concurrent swaps (on the dense and on the fused backend).

The loop lives in `repro_torch.scenarios`, which `chip_smoke.py` runs on
the card. Run as a script, this file measures the trajectory `chip_smoke.py`
holds the card to (`LOOP_TRAJECTORY`): the JAX package's loop at
`benchmarks/control_bench.py`'s full settings, and the port's on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_control.py
"""
import dataclasses
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.control as jax_control
from repro.embedding.bag_encoder import BagEncoder as JaxBagEncoder
from repro.index import ToolIndexManager as JaxToolIndexManager
from repro.obs import EventBus as JaxEventBus
from repro.obs import QualityMonitor as JaxQualityMonitor
from repro.router.gateway import OutcomeEvent as JaxOutcomeEvent
from repro.router.gateway import SemanticRouter as JaxRouter
from repro.router.tooldb import ToolRecord as JaxToolRecord
from repro.router.tooldb import ToolsDatabase as JaxToolsDatabase
from repro_torch import scenarios
from repro_torch.control import (
    ControllerConfig,
    GuardConfig,
    OutcomeStore,
    RefinementController,
    TableGuard,
)
from repro_torch.core.outcomes import masks_from_stream
from repro_torch.core.refine import RefineConfig, RefineResult
from repro_torch.embedding.bag_encoder import BagEncoder
from repro_torch.obs import EventBus, HealthMonitor
from repro_torch.router.gateway import OutcomeEvent, SemanticRouter
from repro_torch.router.tooldb import ConflictError, ToolRecord, ToolsDatabase

CPU = "cpu"
REPORT_FIELDS = ("triggered", "reason", "n_events", "n_new_events", "n_queries",
                 "accepted", "swapped", "table_version")


JAX = SimpleNamespace(
    control=jax_control, Router=JaxRouter, DB=JaxToolsDatabase, Record=JaxToolRecord,
    Bus=JaxEventBus, Quality=JaxQualityMonitor, Index=JaxToolIndexManager,
    encoder=JaxBagEncoder, device_kw={},
)
PORT = scenarios.port_pkg(CPU)


# ------------------------------------------------------------- the loop
# `repro_torch.scenarios` holds the jax-free loop (world, windows,
# held-out NDCG@5, the loop, act 2); each package goes through it as a
# namespace
def _assert_reports_equal(ja, ta):
    assert len(ja) == len(ta)
    for a, b in zip(ja, ta):
        for f in REPORT_FIELDS:
            assert getattr(a, f) == getattr(b, f), (f, getattr(a, f), getattr(b, f))
        for f in ("recall_before", "recall_after"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None)
            if x is not None:
                assert abs(x - y) <= 1e-6, (f, x, y)
        assert (a.guard is None) == (b.guard is None)
        if a.guard is not None:
            assert a.guard.action == b.guard.action
        assert (a.plan is None) == (b.plan is None)
        if a.plan is not None:
            assert dataclasses.asdict(a.plan) == dataclasses.asdict(b.plan)


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_loop_makes_the_jax_decisions(small_bench, backend):
    table = JaxBagEncoder(small_bench.vocab).encode(small_bench.desc_tokens)
    cfg = dict(min_events=150, min_queries=20, min_samples=16)
    jw = scenarios.loop_world(JAX, small_bench, table, **cfg)
    tw = scenarios.loop_world(PORT, small_bench, table, backend, **cfg)
    js, jr, jt = scenarios.run_loop(jw, small_bench, n_windows=3, n_eval=100)
    ts, tr, tt = scenarios.run_loop(tw, small_bench, n_windows=3, n_eval=100)
    _assert_reports_equal(jr, tr)
    assert sum(r.swapped for r in tr) >= 1
    for a, b in zip(js, ts, strict=True):
        assert a[:3] == b[:3]  # events, table_version, swapped
        assert abs(a[3] - b[3]) <= 1e-6  # NDCG@5
    for a, b in zip(jt, tt):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
    # act 2: the same guard actions, the same rollback, the same bus story
    assert scenarios.inject_and_roll_back(jw, small_bench, 100) == (
        scenarios.inject_and_roll_back(tw, small_bench, 100))
    assert tw.guard.rollbacks and tw.db.table_version == jw.db.table_version
    np.testing.assert_allclose(tw.db.embeddings, jw.db.embeddings, atol=1e-5, rtol=0)
    assert [(e.kind, e.plane) for e in jw.bus.events()] == [
        (e.kind, e.plane) for e in tw.bus.events()]
    kinds = [e.kind for e in tw.bus.events()]
    assert kinds.index("quality_drift") < kinds.index("rollback")
    scenarios.close_world(tw)


def test_store_batch_and_fingerprint_match_jax():
    """Same stream into both stores (ring overflow included): counters,
    fingerprint and the refinement batch's arrays are equal exactly."""
    rng = np.random.default_rng(3)
    n_tools = 17
    jax_store = jax_control.OutcomeStore(n_tools=n_tools, capacity=300)
    store = OutcomeStore(n_tools=n_tools, capacity=300)
    pool = [rng.integers(0, 50, size=rng.integers(1, 9)) for _ in range(60)]
    for i in range(400):
        toks = pool[rng.integers(len(pool))]
        tool, out, ts = int(rng.integers(n_tools)), int(rng.integers(2)), float(i)
        jax_store.append(JaxOutcomeEvent(toks, tool, out, ts))
        store.append(OutcomeEvent(toks, tool, out, ts))
        if i % 97 == 0:
            assert store.window_fingerprint() == jax_store.window_fingerprint()
    assert (len(store), store.total_ingested, store.dropped) == (
        len(jax_store), jax_store.total_ingested, jax_store.dropped)
    for a, b in zip(store.tool_counts(), jax_store.tool_counts()):
        np.testing.assert_array_equal(a, b)
    w = rng.normal(size=(50, 8)).astype(np.float32)

    def embed(toks):
        return np.stack([w[t].mean(axis=0) for t in toks])

    a, b = store.build_refinement_batch(embed), jax_store.build_refinement_batch(embed)
    assert (a.n_queries, a.n_events, a.fingerprint) == (b.n_queries, b.n_events, b.fingerprint)
    for x, y in zip(a.query_tokens, b.query_tokens):
        np.testing.assert_array_equal(x, y)
    for f in ("query_emb", "pos_mask", "neg_mask"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and isinstance(x, np.ndarray)
        np.testing.assert_array_equal(x, y)
    assert store.clear() == jax_store.clear()
    assert store.window_fingerprint() == jax_store.window_fingerprint()


def test_guard_action_sequence_matches_jax(small_bench):
    """Both guards judge the same observations across announced and
    out-of-band swaps and rollbacks: the same actions, in order."""
    table = JaxBagEncoder(small_bench.vocab).encode(small_bench.desc_tokens)
    worlds = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        db = pkg.DB([pkg.Record(i, f"t{i}", np.arange(2), 0) for i in range(len(table))],
                    table.copy(), history_limit=2)
        worlds[name] = (db, pkg.control.TableGuard(
            db, pkg.control.GuardConfig(min_samples=6, window=8, tolerance=0.02)))
    rng = np.random.default_rng(5)
    actions = {name: [] for name in worlds}
    for step in range(24):
        ranked = [int(x) for x in rng.permutation(len(table))[:5]]
        rel = [int(x) for x in rng.choice(len(table), size=2, replace=False)]
        for name, (db, guard) in worlds.items():
            for _ in range(3):
                guard.observe(db.table_version, ranked if step % 5 else ranked[::-1], rel)
            if step % 7 == 3:
                old = db.table_version
                new = db.swap_table(np.roll(table, step, axis=0))
                if step % 2:
                    guard.note_swap(old, new)
            actions[name].append(guard.check().action)
    assert actions["jax"] == actions["port"]
    assert len(set(actions["port"])) >= 2


# ------------------------------------------------ mirrored: OutcomeStore
def _event(tokens, tool_id, outcome, ts=0.0):
    return OutcomeEvent(query_tokens=np.asarray(tokens, dtype=np.int64), tool_id=tool_id,
                        outcome=outcome, timestamp=ts)


def _db_and_encoder(bench, **kw):
    enc = BagEncoder(bench.vocab, device=CPU)
    records = [ToolRecord(i, f"tool_{i}", bench.desc_tokens[i], int(bench.tool_category[i]))
               for i in range(bench.n_tools)]
    return ToolsDatabase(records, enc.encode(bench.desc_tokens), **kw), enc


def test_store_ring_eviction_keeps_counters_consistent():
    store = OutcomeStore(n_tools=4, capacity=3)
    for i, (tool, out) in enumerate([(0, 1), (1, 0), (2, 1), (3, 1)]):
        store.append(_event([i], tool, out))
    assert len(store) == 3 and store.total_ingested == 4 and store.dropped == 1
    pos, neg = store.tool_counts()
    np.testing.assert_array_equal(pos, [0, 0, 1, 1])
    np.testing.assert_array_equal(neg, [0, 1, 0, 0])


def test_store_dedupes_queries_and_builds_masks():
    store = OutcomeStore(n_tools=3, capacity=100)
    q_a, q_b = [1, 2, 3], [4, 5]
    store.ingest([_event(q_a, 0, 1), _event(q_a, 1, 0), _event(q_b, 2, 1), _event(q_a, 1, 1)])
    batch = store.build_refinement_batch(lambda toks: np.ones((len(toks), 8), np.float32))
    assert batch.n_queries == 2 and batch.n_events == 4
    np.testing.assert_array_equal(batch.pos_mask, [[1, 1, 0], [0, 0, 1]])
    assert batch.neg_mask.sum() == 0  # the lone negative was vetoed
    assert (batch.pos_mask * batch.neg_mask).sum() == 0


def test_masks_from_stream_pos_vetoes_neg():
    pos, neg = masks_from_stream(query_ids=[0, 0, 1], tool_ids=[2, 2, 0], outcomes=[0, 1, 0],
                                 n_queries=2, n_tools=3)
    assert pos[0, 2] == 1 and neg[0, 2] == 0
    assert neg[1, 0] == 1 and pos[1, 0] == 0


def test_store_persistence_roundtrip(tmp_path):
    store = OutcomeStore(n_tools=5, capacity=4)
    for i in range(6):  # overflow: 2 evictions
        store.append(_event([i, i + 1], i % 5, i % 2, ts=float(i)))
    path = str(tmp_path / "store")
    store.save(path, step=3)
    restored = OutcomeStore.restore(path)
    assert restored.n_tools == 5 and restored.capacity == 4
    assert len(restored) == len(store) == 4
    assert restored.total_ingested == 6 and restored.dropped == 2
    for a, b in zip(store.snapshot_events(), restored.snapshot_events()):
        np.testing.assert_array_equal(a.query_tokens, b.query_tokens)
        assert (a.tool_id, a.outcome, a.timestamp) == (b.tool_id, b.outcome, b.timestamp)
    np.testing.assert_array_equal(np.stack(store.tool_counts()),
                                  np.stack(restored.tool_counts()))


# ------------------------------------------------------ mirrored: ToolsDB
def test_versioned_rollback_history():
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(6, 8)).astype(np.float32)
    db = ToolsDatabase([ToolRecord(i, f"t{i}", np.arange(2), 0) for i in range(6)], emb,
                       history_limit=2)
    tables = {0: db.embeddings.copy()}
    for v in range(1, 4):
        tables[v] = np.roll(emb, v, axis=0)
        db.swap_table(tables[v])
    assert db.retained_versions() == [1, 2]
    with pytest.raises(RuntimeError):
        db.rollback(to_version=0)
    v = db.rollback(to_version=1)
    assert v == 4 and db.table_version == 4
    np.testing.assert_array_equal(db.embeddings, tables[1])
    assert db.retained_versions() == []
    with pytest.raises(RuntimeError):
        db.rollback()


def test_default_rollback_targets_most_recent():
    emb = np.eye(4, dtype=np.float32)
    db = ToolsDatabase([ToolRecord(i, f"t{i}", np.arange(1), 0) for i in range(4)], emb)
    db.swap_table(np.roll(emb, 1, axis=0))
    db.swap_table(np.roll(emb, 2, axis=0))
    db.rollback()
    np.testing.assert_array_equal(db.embeddings, np.roll(emb, 1, axis=0))
    assert db.retained_versions() == [0]
    db.rollback()
    np.testing.assert_array_equal(db.embeddings, emb)


# ---------------------------------------------------- mirrored: controller
def _stub_refine(accepted, delta=0.0):
    """A refine_fn stand-in with a deterministic gate decision; it checks
    that the controller hands it tensors on the controller's device."""

    def fn(table, tq, tr, vq, vr, config):
        assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
                   for x in (table, tq, tr, vq, vr))
        return RefineResult(
            embeddings=table + delta,
            accepted=torch.tensor(accepted),
            recall_before=torch.tensor(0.5),
            recall_after=torch.tensor(0.5 + (0.1 if accepted else -0.1)),
            history=None,
        )

    return fn


def _controller_world(bench, refine_fn, *, min_events=50, guard=None, clock=None,
                      max_interval_s=300.0, backend="dense"):
    db, enc = _db_and_encoder(bench)
    store = OutcomeStore(n_tools=len(db), capacity=10_000)
    router = SemanticRouter(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                            outcome_sink=store.append, backend=backend, metrics=False,
                            device=CPU)
    cfg = ControllerConfig(min_events=min_events, max_interval_s=max_interval_s, min_queries=5,
                           refine=RefineConfig(keep_history=False))
    kw = {} if clock is None else {"clock": clock}
    ctl = RefinementController(db, store, enc.encode, routers=[router], config=cfg,
                               guard=guard, refine_fn=refine_fn, **kw)
    return db, store, router, ctl


def _serve(router, bench, idx):
    for qi in idx:
        res = router.route(bench.query_tokens[qi])
        for t in res.tools:
            router.record_outcome(bench.query_tokens[qi], t, int(t in bench.relevant[qi]))


def test_controller_runs_on_its_routers_device(small_bench):
    db, store, router, ctl = _controller_world(small_bench, _stub_refine(True))
    assert ctl.device == router.device == torch.device(CPU)
    db2, enc = _db_and_encoder(small_bench)
    explicit = RefinementController(db2, OutcomeStore(n_tools=len(db2)), enc.encode,
                                    device=CPU)
    assert explicit.device == torch.device(CPU)


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_controller_event_count_trigger(small_bench, backend):
    db, store, router, ctl = _controller_world(small_bench, _stub_refine(True),
                                               min_events=100, backend=backend)
    _serve(router, small_bench, small_bench.train_idx[:10])  # 50 events < 100
    rep = ctl.step()
    assert not rep.triggered and not rep.swapped
    assert db.table_version == 0
    _serve(router, small_bench, small_bench.train_idx[10:30])  # now 150 total
    rep = ctl.step()
    assert rep.triggered and rep.swapped and rep.accepted
    assert db.table_version == 1
    assert "swapped v0 -> v1" in rep.reason
    assert db.embeddings.dtype == np.float32
    rep = ctl.step()  # watermark consumed: no new events -> no re-trigger
    assert not rep.triggered


def test_controller_staleness_trigger(small_bench):
    t = [0.0]
    db, store, router, ctl = _controller_world(small_bench, _stub_refine(True),
                                               min_events=10_000, clock=lambda: t[0],
                                               max_interval_s=60.0)
    _serve(router, small_bench, small_bench.train_idx[:10])
    assert not ctl.step().triggered
    t[0] = 61.0  # stale + at least one new event -> trigger
    rep = ctl.step()
    assert rep.triggered and rep.swapped
    t[0] = 130.0  # stale again but no new events -> idle router stays idle
    assert not ctl.step().triggered


def test_controller_skips_gate_without_positive_queries(small_bench):
    db, enc = _db_and_encoder(small_bench)
    store = OutcomeStore(n_tools=len(db))
    ctl = RefinementController(db, store, enc.encode,
                               config=ControllerConfig(min_events=1, min_queries=1),
                               refine_fn=_stub_refine(True), device=CPU)
    store.ingest([_event([i, i + 1], i % len(db), 0) for i in range(30)])
    rep = ctl.step()
    assert rep.triggered and not rep.swapped
    assert "positive queries" in rep.reason
    assert db.table_version == 0


def test_controller_gate_reject_leaves_table_untouched(small_bench):
    db, store, router, ctl = _controller_world(small_bench, _stub_refine(False), min_events=50)
    before = db.embeddings.copy()
    _serve(router, small_bench, small_bench.train_idx[:30])
    rep = ctl.step()
    assert rep.triggered and rep.accepted is False and not rep.swapped
    assert "gate rejected" in rep.reason
    assert db.table_version == 0
    np.testing.assert_array_equal(db.embeddings, before)


def test_controller_swap_refused_when_table_moved(small_bench):
    """Compare-and-swap: a deploy landing mid-refinement makes the
    controller stand down instead of clobbering a table the gate never saw."""
    db, store, router, ctl = _controller_world(small_bench, None, min_events=50)
    inner = _stub_refine(True, delta=0.0)

    def racing(*args):
        db.swap_table(np.roll(db.embeddings, 1, axis=0))  # lands mid-refinement
        return inner(*args)

    ctl.refine_fn = racing
    _serve(router, small_bench, small_bench.train_idx[:30])
    rep = ctl.step()
    assert rep.accepted and not rep.swapped and "swap refused" in rep.reason
    assert db.table_version == 1


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_controller_real_refinement_improves_recall(small_bench, backend):
    """With the port's real refine_with_gate: streamed outcomes -> swap ->
    held-out recall through the live router does not degrade."""
    db, enc = _db_and_encoder(small_bench)
    store = OutcomeStore(n_tools=len(db), capacity=50_000)
    router = SemanticRouter(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                            outcome_sink=store.append, backend=backend, device=CPU)
    ctl = RefinementController(db, store, enc.encode, routers=[router],
                               config=ControllerConfig(min_events=100, min_queries=20))

    def recall(idx):
        results = router.route_batch([small_bench.query_tokens[qi] for qi in idx])
        return np.mean([small_bench.relevant[qi][0] in r.tools for qi, r in zip(idx, results)])

    test_idx = small_bench.test_idx[:60]
    before = recall(test_idx)
    _serve(router, small_bench, small_bench.train_idx)
    rep = ctl.step()
    assert rep.triggered
    assert recall(test_idx) >= before - 0.02  # gate guarantee (split-noise tolerance)
    if rep.swapped:
        assert db.table_version == 1
    router.close()


# --------------------------------------------------------- mirrored: guard
def test_guard_rollback_restores_prior_version(small_bench):
    db, _ = _db_and_encoder(small_bench)
    guard = TableGuard(db, GuardConfig(k=5, min_samples=8, tolerance=0.02))
    good = db.embeddings.copy()
    for _ in range(10):
        guard.observe(0, [1, 2, 3, 4, 5], [1])
    assert guard.check().action == "no_baseline"
    db.swap_table(np.roll(good, 3, axis=0))  # out-of-band: no note_swap
    for _ in range(10):
        guard.observe(1, [7, 8, 9, 10, 11], [1])
    rep = guard.check()
    assert rep.action == "rolled_back"
    assert rep.table_version == 1 and rep.restored_version == 2
    assert rep.baseline is not None and rep.ndcg < rep.baseline
    np.testing.assert_array_equal(db.embeddings, good)
    for _ in range(10):
        guard.observe(2, [7, 8, 9, 10, 11], [1])
    assert guard.check().action == "no_baseline"


def test_guard_regression_without_history_is_distinct(small_bench):
    db, _ = _db_and_encoder(small_bench, history_limit=1)
    guard = TableGuard(db, GuardConfig(min_samples=4, tolerance=0.02))
    for _ in range(5):
        guard.observe(0, [1, 2, 3, 4, 5], [1])
    db.swap_table(np.roll(db.embeddings, 3, axis=0))
    db.rollback()
    guard.note_swap(0, 2)
    for _ in range(5):
        guard.observe(2, [7, 8, 9, 10, 11], [1])
    rep = guard.check()
    assert rep.action == "regressed_unrestorable"
    assert rep.baseline is not None and rep.ndcg < rep.baseline
    assert db.table_version == 2


def test_guard_rollback_refused_when_table_moved(small_bench):
    db, _ = _db_and_encoder(small_bench)
    with pytest.raises(ConflictError):
        db.swap_table(np.roll(db.embeddings, 1, axis=0))
        db.rollback(expect_current=0)
    guard = TableGuard(db, GuardConfig(min_samples=4, tolerance=0.02))
    for _ in range(5):
        guard.observe(0, [1, 2, 3], [1])
    guard.note_swap(0, 1)
    for _ in range(5):
        guard.observe(1, [7, 8, 9], [1])
    real_rollback = db.rollback

    def racing_rollback(*a, **kw):
        db.swap_table(np.roll(db.embeddings, 2, axis=0))
        return real_rollback(*a, **kw)

    db.rollback = racing_rollback
    try:
        rep = guard.check()
    finally:
        db.rollback = real_rollback
    assert rep.action == "stale"
    assert not guard.rollbacks


def test_controller_cooldown_after_guard_rollback(small_bench):
    db, enc = _db_and_encoder(small_bench)
    guard = TableGuard(db, GuardConfig(min_samples=4, tolerance=0.02))
    store = OutcomeStore(n_tools=len(db))
    ctl = RefinementController(db, store, enc.encode,
                               config=ControllerConfig(min_events=1, min_queries=1),
                               guard=guard, refine_fn=_stub_refine(True), device=CPU)
    for _ in range(5):
        guard.observe(0, [0, 1, 2, 3, 4], [0])
    db.swap_table(np.roll(db.embeddings, 1, axis=0))
    for _ in range(5):
        guard.observe(1, [7, 8, 9, 10, 11], [0])
    store.ingest([_event([1, 2], 0, 1) for _ in range(10)])
    rep = ctl.step()
    assert rep.guard.action == "rolled_back"
    assert not rep.triggered and "cooldown" in rep.reason
    assert db.table_version == 2
    assert len(store) == 0
    assert not ctl.step().triggered


# -------------------------------------------------------- daemon + threads
def _wait_for(cond, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


def test_daemon_loop_swaps_while_serving_and_records_errors(small_bench):
    """`start()` runs real refinements on the daemon thread while the main
    thread serves; a failing step is recorded (and published) once, and the
    next good step clears it."""
    bus = EventBus()
    db, enc = _db_and_encoder(small_bench)
    bus.watch_db(db)
    store = OutcomeStore(n_tools=len(db))
    router = SemanticRouter(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                            outcome_sink=store.append, backend="fused", metrics=False,
                            bus=bus, device=CPU)
    ctl = RefinementController(db, store, enc.encode, routers=[router],
                               config=ControllerConfig(min_events=60, min_queries=10),
                               bus=bus)
    monitor = HealthMonitor(routers=[router], controllers=[ctl], indexes=[router.index],
                            stores=[store], bus=bus)
    ctl.start(interval_s=0.01)
    try:
        deadline = time.monotonic() + 30
        i = 0
        while db.table_version == 0 and time.monotonic() < deadline:
            idx = small_bench.train_idx[(i * 8) % len(small_bench.train_idx):][:8]
            for qi, r in zip(idx, router.route_batch([small_bench.query_tokens[q] for q in idx])):
                for t in r.tools:
                    router.record_outcome(small_bench.query_tokens[qi], t,
                                          int(t in small_bench.relevant[qi]))
            i += 1
        assert db.table_version >= 1, [r.reason for r in ctl.reports[-3:]]
        boom = RuntimeError("injected step failure")

        def fail(*args):
            raise boom

        ctl.refine_fn = fail
        _serve(router, small_bench, small_bench.train_idx[:20])
        assert _wait_for(lambda: bus.last("loop_error") is not None)
        assert repr(boom) in bus.last("loop_error").details["error"]
        ctl.refine_fn = _stub_refine(False)
        assert _wait_for(lambda: bus.last("loop_recovered") is not None)
        assert _wait_for(lambda: ctl.last_loop_error is None)
    finally:
        ctl.stop()
    assert ctl.last_loop_error is None
    assert bus.counts()["loop_error"] == 1 and bus.counts()["loop_recovered"] == 1
    assert any("step failed" in r.reason for r in ctl.reports)
    assert monitor.snapshot()["status"] == "ok"
    router.close()


@pytest.mark.slow
@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_route_batch_concurrent_with_swaps(small_bench, backend):
    """Every RouteResult must be internally consistent with ONE table that
    actually served: its table_version's table reproduces its scores."""
    db, enc = _db_and_encoder(small_bench, history_limit=3)
    router = SemanticRouter(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                            backend=backend, device=CPU)
    base = db.embeddings.copy()
    tables = {0: base}
    version_lock = threading.Lock()
    stop = threading.Event()

    def churn():
        i = 0
        while not stop.is_set():
            new = np.roll(base, (i % 5) + 1, axis=0)
            with version_lock:
                v = db.swap_table(new)
                tables[v] = new
            i += 1
            time.sleep(0.001)

    t = threading.Thread(target=churn, daemon=True)
    t.start()
    try:
        queries = [small_bench.query_tokens[qi] for qi in small_bench.test_idx[:16]]
        q_emb = enc.encode(queries)
        for _ in range(30):
            results = router.route_batch(queries)
            versions = {r.table_version for r in results}
            assert len(versions) == 1  # one snapshot per batch
            v = versions.pop()
            with version_lock:
                table = tables[v]
            sims = q_emb @ table.T
            for j, r in enumerate(results):
                expected = np.sort(sims[j])[::-1][: len(r.scores)]
                np.testing.assert_allclose(np.asarray(r.scores), expected, atol=1e-4,
                                           err_msg=f"scores inconsistent with table v{v}")
    finally:
        stop.set()
        t.join()
    router.close()


@pytest.mark.slow
def test_record_outcome_concurrent_with_drain():
    db = ToolsDatabase([ToolRecord(i, f"t{i}", np.arange(1), 0) for i in range(4)],
                       np.eye(4, dtype=np.float32))
    router = SemanticRouter(db, embed_fn=lambda t: np.ones(4, np.float32),
                            outcome_capacity=100_000, device=CPU)
    n_writers, n_each = 4, 2000
    drained = []
    stop = threading.Event()

    def writer(w):
        for i in range(n_each):
            router.record_outcome(np.asarray([w, i]), w, 1)

    def drainer():
        while not stop.is_set():
            drained.extend(router.drain_outcomes())
        drained.extend(router.drain_outcomes())

    d = threading.Thread(target=drainer)
    ws = [threading.Thread(target=writer, args=(w,)) for w in range(n_writers)]
    d.start()
    for w in ws:
        w.start()
    for w in ws:
        w.join()
    stop.set()
    d.join()
    assert router.outcomes_dropped == 0
    assert len(drained) == n_writers * n_each


# ------------------------------------------------------------ measurement
def _measure_trajectory() -> None:
    """Print the §7.2 loop at `benchmarks/control_bench.py`'s full settings
    (MetaTool-like, seed 0, 2,400 queries, 6 windows, min_events 1,000,
    min_queries 30, guard min_samples 32, NDCG@5 over 400 test queries) in
    the JAX package and in the port on the CPU, as `chip_smoke.py`'s
    LOOP_TRAJECTORY, then act 2's guard actions."""
    from repro.data.benchmarks import make_metatool_like

    bench = make_metatool_like(seed=0, n_queries=scenarios.LOOP_QUERIES)
    table = JaxBagEncoder(bench.vocab).encode(bench.desc_tokens)
    for name, pkg in (("jax", JAX), ("port cpu", PORT)):
        w = scenarios.loop_world(pkg, bench, table)
        t0 = time.perf_counter()
        series, reports, _ = scenarios.run_loop(w, bench)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
        print("LOOP_TRAJECTORY = (" + ", ".join(
            f"({events}, {version}, {swapped}, {ndcg:.6f})"
            for events, version, swapped, ndcg in series) + ")", flush=True)
        for r in reports:
            print(f"  {r.reason} | gate {r.recall_before} -> {r.recall_after}", flush=True)
        actions = scenarios.inject_and_roll_back(w, bench)
        print(f"  act 2 guard actions {actions}; bus "
              + str([e.kind for e in w.bus.events() if e.plane != "index"]), flush=True)


if __name__ == "__main__":
    sys.exit(_measure_trajectory())
