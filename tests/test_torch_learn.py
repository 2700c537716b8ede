"""The port's learning plane against the JAX package's.

Parity first. Inputs are made once in numpy from a seed and given to both
packages, each serving through its own `SemanticRouter` on the CPU:

  * `build_train_window`: the same `train_idx`, `val_idx`, masks and
    fingerprint, exactly; triplet mining over it and the featurizer's
    checkpoint tree, exactly;
  * `stage_ndcg` on one StageSet (the JAX params carried across with
    `repro_torch.convert`): within 1e-6;
  * `ArtifactRegistry`: versions, rollback, and a registry saved by one
    package restored by the other, exactly;
  * `StageGuard`: the same reports and demotions on one labelled stream;
  * `LearningController`: both handed one fixed-artifact trainer (the same
    numpy params for each) make equal reports — actions, `ndcg_current`
    and `ndcg_candidate` within 1e-6, `stage_version` and `active` — over
    the suppression, trigger, gate, promotion, table-moved and demotion
    scenarios of `tests/test_learn.py`;
  * the §7.3 density sweep (`repro_torch.scenarios.density_sweep`, which the card
    runs at `benchmarks/learn_bench.py`'s full settings) at
    small_bench size: refine-only within 1e-4 of the JAX package's, and
    +adapter / +reranker NDCG@5 inside the JAX package's band over trainer
    seeds 0-4 (`jax.random` and `torch.Generator` draw different numbers,
    so trained params agree only statistically).

The rest mirrors `tests/test_learn.py` as port cases (`device="cpu"`).

Run as a script, this file measures the bands: small_bench's
(`SWEEP_BANDS` below) and those at the full settings
(`repro_torch.scenarios.LEARN_BANDS`), on the JAX package over trainer
seeds 0-4 and 5-9, and the five-seed means of trainers that ignore their
labels (`label_blind`), which the bands must keep out:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_learn.py
"""
import dataclasses
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.control as jax_control
import repro.learn as jax_learn
from repro.core import adapter as jax_adapter
from repro.core.deployment import DeploymentPlan as JaxPlan
from repro.core.deployment import recommend_stages as jax_recommend_stages
from repro.core.features import OutcomeFeaturizer as JaxFeaturizer
from repro.embedding.bag_encoder import BagEncoder as JaxBagEncoder
from repro.obs import EventBus as JaxEventBus
from repro.router.gateway import SemanticRouter as JaxRouter
from repro.router.stages import StageSet as JaxStageSet
from repro.router.tooldb import ToolRecord as JaxToolRecord
from repro.router.tooldb import ToolsDatabase as JaxToolsDatabase
from repro_torch import convert, scenarios
from repro_torch.control import OutcomeStore
from repro_torch.core import adapter as adapter_lib
from repro_torch.core import reranker as reranker_lib
from repro_torch.core.deployment import DeploymentPlan
from repro_torch.core.features import OutcomeFeaturizer
from repro_torch.embedding.bag_encoder import BagEncoder
from repro_torch.learn import (
    AdapterTrainer,
    ArtifactRegistry,
    LearnConfig,
    LearningController,
    RerankerTrainer,
    StageGuard,
    StageGuardConfig,
    TrainedStage,
    build_train_window,
    featurizer_from_tree,
    featurizer_to_tree,
    stage_ndcg,
)
from repro_torch.router.gateway import OutcomeEvent, SemanticRouter, StageSet
from repro_torch.router.tooldb import ConflictError, ToolRecord, ToolsDatabase

CPU = "cpu"


PORT = scenarios.port_pkg(CPU)


def _jax_refine(table, q_tr, pos_tr, q_val, pos_val):
    import jax.numpy as jnp

    from repro.core.refine import RefineConfig, refine_with_gate

    res = refine_with_gate(jnp.asarray(table), jnp.asarray(q_tr), jnp.asarray(pos_tr),
                           jnp.asarray(q_val), jnp.asarray(pos_val),
                           RefineConfig(keep_history=False, gate_metric="ndcg"))
    return np.asarray(res.embeddings)


def _jax_params(tree):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in tree.items()}


JAX = SimpleNamespace(
    control=jax_control, learn=jax_learn, Router=JaxRouter, DB=JaxToolsDatabase,
    Record=JaxToolRecord, StageSet=JaxStageSet, Bus=JaxEventBus, encoder=JaxBagEncoder,
    device_kw={}, plan=jax_recommend_stages, refine=_jax_refine, params=_jax_params,
)

# the bands for the port's +adapter / +reranker NDCG@5 averaged over trainer
# seeds 0-4 on small_bench (`density_sweep(..., SWEEP_FRACTIONS,
# SWEEP_TEST)`), from the JAX package's five-seed means over seeds 0-4 and
# 5-9 (`measure_bands`); measured by running this file
SWEEP_FRACTIONS, SWEEP_TEST = (0.3, 1.0), 100
SWEEP_BANDS = ({"plus_adapter": (0.9052, 0.9055), "plus_rerank": (0.0249, 0.747)},
               {"plus_adapter": (0.9139, 0.923), "plus_rerank": (0.2506, 1.0)})


# ------------------------------------------------------------------ helpers
def _world(pkg, bench, *, plan_fn, min_new_events=50, guard=None, backend="dense",
           trainer=None, **cfg_kw):
    """One package's serving plane + learning controller over `bench`."""
    enc, db, store, router = scenarios.learn_db(pkg, bench, backend=backend)
    if guard is not None:
        guard = pkg.learn.StageGuard(router, guard)
    learner = pkg.learn.LearningController(
        db, store, router, enc.encode, guard=guard,
        config=pkg.learn.LearnConfig(min_new_events=min_new_events, min_queries=10, **cfg_kw),
        plan_fn=plan_fn, **pkg.device_kw)
    if trainer is not None:
        learner.trainers["adapter"] = trainer
    return SimpleNamespace(enc=enc, db=db, store=store, router=router, learner=learner,
                           guard=guard)


_serve = scenarios.serve_and_log


def _forced_plan(plan_cls, refine=True, rerank=False, adapter=False):
    def plan_fn(n_tools, n_examples):
        return plan_cls(refine=refine, mlp_reranker=rerank, contrastive_adapter=adapter,
                        density=n_examples / max(n_tools, 1), reason="forced (test)")

    return plan_fn


def _adapter_tree(seed=0, w2_scale=0.0):
    """Numpy adapter params: He-normal w1, and w2 zero (the identity) or
    random (a real query transform)."""
    rng = np.random.default_rng(seed)
    return {
        "w1": (rng.standard_normal((384, 256)) * np.sqrt(2 / 384)).astype(np.float32),
        "b1": np.zeros(256, np.float32),
        "w2": (w2_scale * rng.standard_normal((256, 384))).astype(np.float32),
        "b2": np.zeros(384, np.float32),
    }


class _FixedTrainer:
    """Returns the same numpy adapter params to whichever package calls it;
    optionally swaps the table mid-training (a concurrent refinement)."""

    stage = "adapter"

    def __init__(self, tree, db=None):
        self.tree, self.db, self.calls = tree, db, 0

    def train(self, window, live_stages=None):
        self.calls += 1
        if self.db is not None:
            self.db.swap_table(self.db.embeddings.copy())
        return SimpleNamespace(
            stage="adapter", params={k: v.copy() for k, v in self.tree.items()}, aux={},
            info={},
            apply_to=lambda current, artifact_version=None, **kw: dataclasses.replace(
                current, adapter_params=_on(self.tree, kw.get("device")),
                adapter_artifact=artifact_version))


def _on(tree, device):
    if device is None:  # the JAX package
        return _jax_params(tree)
    return convert.params_from_jax(tree, device)


def _report_key(report):
    return (report.stage_version, report.active, report.reason,
            None if report.guard is None else report.guard.action,
            None if report.guard is None else report.guard.restored_version)


def _assert_reports_equal(ja, ta):
    assert _report_key(ja) == _report_key(ta)
    assert sorted(ja.decisions) == sorted(ta.decisions)
    for stage, a in ja.decisions.items():
        b = ta.decisions[stage]
        assert (a.action, a.artifact_version, a.stage_version) == (
            b.action, b.artifact_version, b.stage_version), (stage, a, b)
        for f in ("ndcg_current", "ndcg_candidate"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None)
            if x is not None:
                assert abs(x - y) <= 1e-6, (stage, f, x, y)


# -------------------------------------------------------------- parity
def test_train_window_mining_and_featurizer_match_jax(small_bench):
    """One outcome stream into both packages: the frozen window is equal
    exactly, and so are the triplets mined over it and the featurizer's
    checkpoint tree."""
    plan = _forced_plan(JaxPlan)
    jw = _world(JAX, small_bench, plan_fn=plan)
    tw = _world(PORT, small_bench, plan_fn=_forced_plan(DeploymentPlan))
    assert build_train_window(tw.db, tw.store, tw.enc.encode) is None  # empty window
    for w in (jw, tw):
        _serve(w.router, small_bench, small_bench.train_idx[:160])
    ja = jax_learn.build_train_window(jw.db, jw.store, jw.enc.encode, min_queries=10, seed=3)
    ta = build_train_window(tw.db, tw.store, tw.enc.encode, min_queries=10, seed=3)
    assert ta.fingerprint == ja.fingerprint and ta.table_version == ja.table_version
    for f in ("train_idx", "val_idx", "pos_mask", "neg_mask", "tool_category", "table",
              "query_emb"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f), err_msg=f)
    for x, y in zip(ta.query_tokens, ja.query_tokens):
        np.testing.assert_array_equal(x, y)
    args = (ta.query_emb[ta.train_idx], ta.table, ta.pos_mask[ta.train_idx])
    for x, y in zip(adapter_lib.mine_triplets(*args, n_hard=4, seed=0),
                    jax_adapter.mine_triplets(*args, n_hard=4, seed=0)):
        np.testing.assert_array_equal(x, y)
    tr = ta.train_idx
    retrieved = np.argsort(-(ta.query_emb[tr] @ ta.table.T), axis=1, kind="stable")[:, :5]
    fit = (ta.query_emb[tr], ta.tokens(tr), ta.pos_mask[tr], retrieved, ta.tool_category)
    jtree = jax_learn.featurizer_to_tree(JaxFeaturizer.fit(*fit, seed=0))
    ttree = featurizer_to_tree(OutcomeFeaturizer.fit(*fit, seed=0))
    assert sorted(jtree) == sorted(ttree)
    for k in jtree:
        assert ttree[k].dtype == jtree[k].dtype
        np.testing.assert_array_equal(ttree[k], jtree[k])


@pytest.mark.parametrize("stages", ["none", "adapter", "rerank", "both"])
def test_stage_ndcg_matches_jax(small_bench, stages):
    """The held-out gate metric on one StageSet, the JAX params carried
    across: within 1e-6 (rankings equal but for exact float ties)."""
    enc = JaxBagEncoder(small_bench.vocab)
    table = enc.encode(small_bench.desc_tokens)
    idx = small_bench.test_idx[:120]
    q = enc.encode([small_bench.query_tokens[i] for i in idx])
    tokens = [small_bench.query_tokens[i] for i in idx]
    rel = small_bench.relevance_matrix()[idx].astype(np.float32)
    adapter = _adapter_tree(1, w2_scale=0.05) if stages in ("adapter", "both") else None
    mlp = feat = None
    if stages in ("rerank", "both"):
        tr = small_bench.train_idx[:200]
        qt = enc.encode([small_bench.query_tokens[i] for i in tr])
        retrieved = np.argsort(-(qt @ table.T), axis=1, kind="stable")[:, :5]
        feat = JaxFeaturizer.fit(qt, [small_bench.query_tokens[i] for i in tr],
                                 small_bench.relevance_matrix()[tr], retrieved,
                                 small_bench.tool_category)
        rng = np.random.default_rng(2)
        mlp = {}
        for li, (din, dout) in enumerate(zip(reranker_lib.LAYERS[:-1], reranker_lib.LAYERS[1:])):
            mlp[f"w{li}"] = (rng.standard_normal((din, dout)) * np.sqrt(2 / din)).astype(np.float32)
            mlp[f"b{li}"] = (0.1 * rng.standard_normal(dout)).astype(np.float32)
    jstages = JaxStageSet(adapter_params=None if adapter is None else _jax_params(adapter),
                          mlp_params=None if mlp is None else _jax_params(mlp), featurizer=feat)
    tstages = convert.stages_from_jax(adapter, mlp, None if feat is None else featurizer_from_tree(
        jax_learn.featurizer_to_tree(feat)), device=CPU)
    want = jax_learn.stage_ndcg(table, q, tokens, rel, jstages)
    got = stage_ndcg(table, q, tokens, rel, tstages, device=CPU)
    assert abs(got - want) <= 1e-6, (got, want)
    assert 0.0 < got <= 1.0


def test_registry_round_trips_across_packages(tmp_path, small_bench):
    """Versions and rollback agree, and a registry saved by either package
    restores in the other with its params, aux and lineage exact."""
    enc = JaxBagEncoder(small_bench.vocab)
    tr = small_bench.train_idx[:40]
    qe = enc.encode([small_bench.query_tokens[i] for i in tr])
    table = enc.encode(small_bench.desc_tokens)
    feat = JaxFeaturizer.fit(qe, [small_bench.query_tokens[i] for i in tr],
                             small_bench.relevance_matrix()[tr],
                             np.argsort(-(qe @ table.T), axis=1, kind="stable")[:, :5],
                             small_bench.tool_category)
    regs = {"jax": jax_learn.ArtifactRegistry(history_limit=3),
            "port": ArtifactRegistry(history_limit=3)}
    for reg in regs.values():
        for i in range(4):
            reg.register("adapter", _adapter_tree(i, 0.1), table_version=i, fingerprint=f"fp{i}",
                         metrics={"ndcg_candidate": 0.5 + i / 10})
        reg.register("rerank", {"w0": np.ones((7, 4), np.float32)}, table_version=3,
                     fingerprint="abcd", aux=jax_learn.featurizer_to_tree(feat))
        reg.rollback("adapter")
    assert regs["jax"].versions("adapter") == regs["port"].versions("adapter") == [2, 3]
    for src, dst, restore in (("jax", "port", ArtifactRegistry.restore),
                              ("port", "jax", jax_learn.ArtifactRegistry.restore)):
        path = str(tmp_path / src)
        regs[src].save(path)
        back = restore(path)
        for stage in ("adapter", "rerank"):
            assert back.versions(stage) == regs[dst].versions(stage)
            for v in back.versions(stage):
                a, b = back.get(stage, v), regs[dst].get(stage, v)
                assert (a.table_version, a.fingerprint, a.metrics) == (
                    b.table_version, b.fingerprint, b.metrics)
                for tree_a, tree_b in ((a.params, b.params), (a.aux, b.aux)):
                    assert sorted(tree_a) == sorted(tree_b)
                    for k in tree_a:
                        np.testing.assert_array_equal(np.asarray(tree_a[k]),
                                                      np.asarray(tree_b[k]))
        assert back.register("adapter", {"w": np.zeros(1)}, table_version=9,
                             fingerprint="x").version == 5


def test_stage_guard_reports_match_jax(small_bench):
    """Both guards judge one labelled stream across announced and
    out-of-band promotions: the same reports, in order, and the same
    demotions."""
    table = JaxBagEncoder(small_bench.vocab).encode(small_bench.desc_tokens)
    worlds = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        db = pkg.DB([pkg.Record(i, f"t{i}", np.arange(2), 0) for i in range(len(table))],
                    table.copy())
        router = pkg.Router(db, embed_fn=lambda t: table[0], k=5, stage_history_limit=2,
                            **pkg.device_kw)
        worlds[name] = (router, pkg.learn.StageGuard(
            router, pkg.learn.StageGuardConfig(min_samples=6, window=8, tolerance=0.02)), pkg)
    rng = np.random.default_rng(7)
    reports = {name: [] for name in worlds}
    for step in range(30):
        ranked = [int(x) for x in rng.permutation(len(table))[:5]]
        rel = [int(x) for x in rng.choice(len(table), size=2, replace=False)]
        for name, (router, guard, pkg) in worlds.items():
            for _ in range(3):
                guard.observe(router.stage_version, ranked if step % 4 else ranked[::-1], rel)
            if step % 6 == 2:
                old = router.stage_version
                new = router.set_stages(pkg.StageSet(), expect_version=old)
                if step % 4:
                    guard.note_promotion(old, new)
            r = guard.check()
            reports[name].append((r.action, r.stage_version, r.n_samples, r.restored_version,
                                  None if r.ndcg is None else round(r.ndcg, 9),
                                  None if r.baseline is None else round(r.baseline, 9)))
    assert reports["jax"] == reports["port"]
    assert len({r[0] for r in reports["port"]}) >= 2
    assert len(worlds["jax"][1].demotions) == len(worlds["port"][1].demotions)


SCENARIOS = {
    # name: (plan kwargs, min_new_events, min_gain, events served, trainer)
    "suppressed": (dict(), 50, 0.0, 40, "identity"),
    "below_trigger": (dict(adapter=True), 10_000, 0.0, 20, "identity"),
    "gate_rejected": (dict(adapter=True), 50, 0.0, 60, "identity"),
    "promoted": (dict(adapter=True), 50, -1.0, 160, "transform"),
    "table_moved": (dict(adapter=True), 50, -1.0, 60, "swapping"),
    "demoted": (dict(adapter=True), 50, -1.0, 40, "identity"),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_controller_decisions_match_jax_on_fixed_artifacts(small_bench, scenario):
    """Both controllers get one fixed-artifact trainer (the same numpy
    params for each), so gating and promotion are tested apart from
    training: every report is equal, NDCG@5 within 1e-6."""
    plan_kw, min_new, min_gain, n_served, kind = SCENARIOS[scenario]
    tree = _adapter_tree(3, w2_scale=0.0 if kind != "transform" else 0.05)
    guard_cfg = {"jax": jax_learn.StageGuardConfig(min_samples=16),
                 "port": StageGuardConfig(min_samples=16)}
    worlds = {}
    for name, pkg, plan_cls in (("jax", JAX, JaxPlan), ("port", PORT, DeploymentPlan)):
        w = _world(pkg, small_bench, plan_fn=_forced_plan(plan_cls, **plan_kw),
                   min_new_events=min_new, min_gain=min_gain,
                   guard=guard_cfg[name] if scenario == "demoted" else None)
        w.learner.trainers["adapter"] = _FixedTrainer(
            tree, db=w.db if kind == "swapping" else None)
        worlds[name] = w
    reports = {name: [] for name in worlds}
    for name, w in worlds.items():
        observe = None
        if w.guard is not None:
            observe = lambda res, rel, g=w.guard: g.observe(res.stage_version, res.tools, rel)
        _serve(w.router, small_bench, small_bench.train_idx[:n_served], observe)
        reports[name].append(w.learner.step())
        if scenario == "demoted":
            v = reports[name][-1].stage_version
            for _ in range(16):
                w.guard.observe(v, [0, 1, 2, 3, 4], [59])
        reports[name].append(w.learner.step())
    for a, b in zip(reports["jax"], reports["port"], strict=True):
        _assert_reports_equal(a, b)
    actions = [r.decisions.get("adapter") for r in reports["port"]]
    first = actions[0].action
    assert first == {"suppressed": "suppressed", "below_trigger": "below_trigger",
                     "gate_rejected": "gate_rejected", "promoted": "promoted",
                     "table_moved": "table_moved", "demoted": "promoted"}[scenario]
    if scenario == "demoted":
        assert reports["port"][1].guard.action == "demoted"
        assert worlds["port"].learner.registry.latest("adapter") is None


def density_bands_ok(points, bands):
    """Each trained stage's NDCG@5, the mean over the trainer seeds, inside
    its band at each point."""
    for p, band in zip(points, bands, strict=True):
        for stage, (lo, hi) in band.items():
            mean = float(np.mean(p["ndcg_by_seed"][stage]))
            assert lo <= mean <= hi, (p["events"], stage, p["ndcg_by_seed"][stage], (lo, hi))


def test_density_sweep_inside_the_jax_band(small_bench):
    """The §7.3 sweep at small_bench size through both packages: the same
    windows, plans and refine-only NDCG@5 (within 1e-4), and the mean of
    the port's NDCG@5 over trainer seeds 0-4 inside the JAX package's band
    (`measure_bands`). The re-ranker's draws here are bimodal in both
    packages (0.00-0.89: whether it collapses depends on the seed, sd
    0.23-0.25), so its band is wide; the test at the full settings below
    is the one that tells a trained re-ranker from one that ignores its
    labels."""
    jax_pts = scenarios.density_sweep(JAX, small_bench, SWEEP_FRACTIONS, SWEEP_TEST)
    pts = scenarios.density_sweep(PORT, small_bench, SWEEP_FRACTIONS, SWEEP_TEST,
                                   trainer_seeds=range(5))
    for a, b in zip(jax_pts, pts, strict=True):
        assert (a["events"], a["plan"], a["n_val"]) == (b["events"], b["plan"], b["n_val"])
        assert abs(a["ndcg_at_5"]["refine_only"] - b["ndcg_at_5"]["refine_only"]) <= 1e-4
        assert not b["promotion_regressed"]
    density_bands_ok(pts, SWEEP_BANDS)


def test_density_sweep_at_full_settings_inside_the_jax_band():
    """The sweep's middle point at `benchmarks/learn_bench.py`'s full
    settings (11.67 events per tool), which the card runs too: refine-only
    within 1e-4 of the JAX package's and the port's five-seed means inside
    `scenarios.LEARN_BANDS`. Trainers that learn from shuffled labels
    (`label_blind`) score +adapter 0.8741 and +reranker 0.2615 here, out of
    those bands."""
    from repro.data.benchmarks import make_metatool_like

    bench = make_metatool_like(seed=0, n_tools=scenarios.LEARN_TOOLS,
                               n_queries=scenarios.LEARN_QUERIES)
    frac = scenarios.LEARN_FRACTIONS[1]
    (pt,) = scenarios.density_sweep(PORT, bench, (frac,), scenarios.LEARN_TEST,
                                    trainer_seeds=range(5))
    assert pt["events"] == 7000  # 1,400 queries, five outcomes each
    assert abs(pt["ndcg_at_5"]["refine_only"] - scenarios.LEARN_REFINE_ONLY[1]) <= 1e-4
    assert not pt["promotion_regressed"]
    density_bands_ok([pt], scenarios.LEARN_BANDS[1:2])


def test_stages_acts_on_the_cpu():
    """`scenarios.stages_acts`, `examples/live_loop.py --stages`' three
    acts as the card runs them, through the port on the CPU at the
    example's settings: suppressed, promoted with a lift, demoted and
    restored exactly (`stages_acts` asserts each)."""
    from repro_torch.data.benchmarks import make_metatool_like

    bench = make_metatool_like(seed=0, n_tools=scenarios.LEARN_TOOLS,
                               n_queries=scenarios.LEARN_QUERIES)
    summary, w = scenarios.stages_acts(PORT, bench)
    assert [st["decisions"] for st in summary["steps"][:2]] == [
        {"adapter": "suppressed", "rerank": "suppressed"},
        {"adapter": "promoted", "rerank": "suppressed"}]
    assert summary["guard_actions"][-1] == "demoted"
    assert summary["ndcg_restored"] == summary["ndcg_dense"] > summary["ndcg_sparse"]
    assert w.registry.latest("adapter").version == summary["act2"]["artifact"]
    w.router.close()


# ------------------------------------------------ mirrored: ArtifactRegistry
def test_registry_versions_bounded_latest_and_discard():
    reg = ArtifactRegistry(history_limit=3)
    for i in range(5):
        art = reg.register("adapter", {"w": np.full((2, 2), i, np.float32)},
                           table_version=i, fingerprint=f"fp{i}")
        assert art.version == i + 1
    assert reg.versions("adapter") == [3, 4, 5]  # bounded: oldest evicted
    assert reg.latest("adapter").version == 5
    with pytest.raises(KeyError):
        reg.get("adapter", 1)
    reg.discard("adapter", 5)
    assert reg.latest("adapter").version == 4
    reg.discard("adapter", 99)  # idempotent on unknown versions


def test_registry_rollback_drops_newer_versions():
    reg = ArtifactRegistry()
    for _ in range(3):
        reg.register("rerank", {"w": np.zeros(1)}, table_version=0, fingerprint="f")
    art = reg.rollback("rerank")
    assert art.version == 2 and reg.versions("rerank") == [1, 2]
    art = reg.rollback("rerank", to_version=1)
    assert art.version == 1 and reg.versions("rerank") == [1]
    with pytest.raises(RuntimeError):
        reg.rollback("rerank")  # nothing older retained


def test_registry_persistence_roundtrip(tmp_path, small_bench):
    enc = BagEncoder(small_bench.vocab, device=CPU)
    tr = small_bench.train_idx[:40]
    qe = enc.encode([small_bench.query_tokens[i] for i in tr])
    rel = small_bench.relevance_matrix()[tr]
    table = enc.encode(small_bench.desc_tokens)
    retrieved = np.argsort(-(qe @ table.T), axis=1)[:, :5]
    feat = OutcomeFeaturizer.fit(qe, [small_bench.query_tokens[i] for i in tr], rel, retrieved,
                                 small_bench.tool_category)
    reg = ArtifactRegistry()
    params = adapter_lib.init_adapter(torch.Generator().manual_seed(0))
    reg.register("adapter", {k: v.numpy() for k, v in params.items()},
                 table_version=3, fingerprint="abcd", metrics={"ndcg_candidate": 0.9})
    reg.register("rerank", {"w0": np.ones((7, 4), np.float32)},
                 table_version=3, fingerprint="abcd", aux=featurizer_to_tree(feat))
    reg.save(str(tmp_path))
    back = ArtifactRegistry.restore(str(tmp_path))
    art = back.latest("adapter")
    assert art.table_version == 3 and art.fingerprint == "abcd"
    assert art.metrics["ndcg_candidate"] == pytest.approx(0.9)
    np.testing.assert_allclose(art.params["w1"], params["w1"].numpy())
    feat_back = featurizer_from_tree(back.latest("rerank").aux)
    np.testing.assert_allclose(feat_back.success_rate, feat.success_rate)
    assert feat_back.mean_query_len == pytest.approx(feat.mean_query_len)
    # registered versions keep counting from where the saved registry stopped
    assert back.register("adapter", {"w": np.zeros(1)}, table_version=4,
                         fingerprint="x").version == 2


# ------------------------------------------- mirrored: StageSet CAS on the router
def _db_and_encoder(bench, **kw):
    enc = BagEncoder(bench.vocab, device=CPU)
    records = [ToolRecord(i, f"tool_{i}", bench.desc_tokens[i], int(bench.tool_category[i]))
               for i in range(bench.n_tools)]
    return ToolsDatabase(records, enc.encode(bench.desc_tokens), **kw), enc


def _adapter_params(seed, w2_scale=0.3):
    return convert.params_from_jax(_adapter_tree(seed, w2_scale), CPU)


def test_stage_cas_and_bounded_history(small_bench):
    db, enc = _db_and_encoder(small_bench)
    router = SemanticRouter(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                            stage_history_limit=2, device=CPU)
    params = _adapter_params(0, 0.0)
    v1 = router.set_stages(StageSet(adapter_params=params), expect_version=0)
    assert v1 == 1 and router.stage_set()[1].has_adapter
    with pytest.raises(ConflictError):
        router.set_stages(StageSet(), expect_version=0)  # stale expectation
    v2 = router.set_stages(StageSet(), expect_version=v1)
    v3 = router.set_stages(StageSet(adapter_params=params), expect_version=v2)
    assert router.retained_stage_versions() == [v1, v2]  # bounded at 2
    # rollback refuses when the judged version is no longer live
    with pytest.raises(ConflictError):
        router.rollback_stages(expect_current=v2)
    v4 = router.rollback_stages(expect_current=v3)
    assert v4 == 4 and not router.stage_set()[1].has_adapter
    # the condemned v3 was not retained; v1 remains a target
    assert router.retained_stage_versions() == [v1]


def test_route_scores_match_reported_stage_version(small_bench):
    """RouteResult.scores are the exact similarities of the adapted query
    against the reported table_version."""
    db, enc = _db_and_encoder(small_bench)
    router = SemanticRouter(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                            device=CPU)
    params = _adapter_params(1)  # non-identity: adapted scores differ from raw ones
    router.set_stages(StageSet(adapter_params=params), expect_version=0)
    q_tokens = small_bench.query_tokens[small_bench.test_idx[0]]
    res = router.route(q_tokens)
    assert res.stage_version == 1
    qe = enc.encode_one(q_tokens)[None]
    q_adapted = StageSet(adapter_params=params).adapt_queries(qe)[0]
    expect = np.sort(db.embeddings @ q_adapted)[::-1][:5]
    np.testing.assert_allclose(res.scores, expect, atol=1e-5)
    raw_top = np.sort(db.embeddings @ qe[0])[::-1][:5]
    assert not np.allclose(expect, raw_top, atol=1e-5)


def test_adapter_stage_composes_with_backends(small_bench):
    """The adapter transforms queries BEFORE the index backend scores, so
    dense and fused (exact paths) agree on the adapted ranking."""
    db, enc = _db_and_encoder(small_bench)
    stages = StageSet(adapter_params=_adapter_params(2))
    queries = [small_bench.query_tokens[i] for i in small_bench.test_idx[:8]]
    results = {}
    for backend in ("dense", "fused"):
        router = SemanticRouter(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                                backend=backend, stages=stages, device=CPU)
        assert router.index.wait_ready()
        results[backend] = router.route_batch(queries)
        router.close()
    for rd, rp in zip(results["dense"], results["fused"]):
        assert rd.tools == rp.tools
        np.testing.assert_allclose(rd.scores, rp.scores, atol=1e-5)


# -------------------------------------------- mirrored: LearningController
class _CountingTrainer:
    """Stub trainer: returns an identity adapter, counts invocations."""

    stage = "adapter"

    def __init__(self):
        self.calls = 0

    def train(self, window, live_stages=None):
        self.calls += 1
        params = adapter_lib.init_adapter(torch.Generator().manual_seed(0))
        return TrainedStage(stage="adapter", params={k: v.numpy() for k, v in params.items()},
                            aux={}, info={})


def _learn_world(bench, *, plan_fn, min_new_events=50, guard=None, **cfg_kw):
    w = _world(PORT, bench, plan_fn=plan_fn, min_new_events=min_new_events, **cfg_kw)
    w.learner.guard = guard
    return w.db, w.enc, w.store, w.router, w.learner


def _plan(**kw):
    return _forced_plan(DeploymentPlan, **kw)


def test_learning_controller_runs_on_its_routers_device(small_bench):
    db, enc, store, router, learner = _learn_world(small_bench, plan_fn=_plan())
    assert learner.device == router.device == torch.device(CPU)
    assert learner.trainers["adapter"].device == learner.trainers["rerank"].device == router.device


def test_plan_suppression_never_trains(small_bench):
    db, enc, store, router, learner = _learn_world(small_bench, plan_fn=_plan())
    counting = _CountingTrainer()
    learner.trainers["adapter"] = counting
    _serve(router, small_bench, small_bench.train_idx[:40])
    report = learner.step()
    assert report.decisions["adapter"].action == "suppressed"
    assert report.decisions["rerank"].action == "suppressed"
    assert counting.calls == 0, "a plan-vetoed stage must never even train"
    assert report.active == frozenset()


def test_below_trigger_skips_training(small_bench):
    db, enc, store, router, learner = _learn_world(
        small_bench, plan_fn=_plan(adapter=True), min_new_events=10_000)
    counting = _CountingTrainer()
    learner.trainers["adapter"] = counting
    _serve(router, small_bench, small_bench.train_idx[:20])
    report = learner.step()
    assert report.decisions["adapter"].action == "below_trigger"
    assert counting.calls == 0


def test_gate_rejects_non_improvement(small_bench):
    """An identity adapter ties the live config's NDCG; min_gain=0 promotion
    requires strict improvement, so the tie must be rejected."""
    db, enc, store, router, learner = _learn_world(small_bench, plan_fn=_plan(adapter=True))
    learner.trainers["adapter"] = _CountingTrainer()
    _serve(router, small_bench, small_bench.train_idx[:60])
    d = learner.step().decisions["adapter"]
    assert d.action == "gate_rejected"
    assert d.ndcg_candidate == pytest.approx(d.ndcg_current, abs=1e-6)
    assert learner.registry.latest("adapter") is None
    assert router.stage_version == 0
    # the trigger watermark was consumed: no retrain until fresh evidence
    assert learner.step().decisions["adapter"].action == "below_trigger"


def test_real_adapter_promotion_lifts_heldout_ndcg(small_bench):
    """Real training end to end on a forced-dense plan: the adapter clears
    the held-out gate, activates via CAS on the router's device, and
    registers its artifact stamped with (table_version, fingerprint)."""
    db, enc, store, router, learner = _learn_world(small_bench, plan_fn=_plan(adapter=True))
    _serve(router, small_bench, small_bench.train_idx)
    fp = store.window_fingerprint()
    report = learner.step()
    d = report.decisions["adapter"]
    assert d.action == "promoted", d
    assert d.ndcg_candidate > d.ndcg_current
    assert report.active == frozenset({"adapter"})
    art = learner.registry.latest("adapter")
    assert art is not None and art.version == d.artifact_version
    assert art.table_version == db.table_version and art.fingerprint == fp
    assert all(isinstance(v, np.ndarray) for v in art.params.values())
    _, stages = router.stage_set()
    assert stages.adapter_artifact == art.version
    assert all(v.device == router.device for v in stages.adapter_params.values())


def test_sparse_window_rerank_is_gate_rejected(small_bench):
    """Even with the density plan bypassed, the held-out gate stops the
    re-ranker trained on a sparse window (§7.3's negative result)."""
    db, enc, store, router, learner = _learn_world(small_bench, plan_fn=_plan(rerank=True))
    _serve(router, small_bench, small_bench.train_idx[:120])
    d = learner.step().decisions["rerank"]
    assert d.action in ("gate_rejected", "train_failed"), d
    assert not router.stage_set()[1].has_reranker


def test_table_swap_mid_training_stands_down(small_bench):
    db, enc, store, router, learner = _learn_world(
        small_bench, plan_fn=_plan(adapter=True), min_gain=-1.0)

    class SwappingTrainer(_CountingTrainer):
        def train(self, window, live_stages=None):
            db.swap_table(db.embeddings.copy(), expect_current=db.table_version)
            return super().train(window, live_stages)

    learner.trainers["adapter"] = SwappingTrainer()
    _serve(router, small_bench, small_bench.train_idx[:60])
    d = learner.step().decisions["adapter"]
    assert d.action == "table_moved", d
    assert learner.registry.latest("adapter") is None
    assert router.stage_version == 0


def test_activation_conflict_discards_artifact(small_bench):
    class RacingRouter(SemanticRouter):
        def set_stages(self, stages, expect_version=None):
            raise ConflictError("lost the race (test)")

    db, enc = _db_and_encoder(small_bench)
    store = OutcomeStore(n_tools=len(db), capacity=50_000)
    router = RacingRouter(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                          outcome_sink=store.append, device=CPU)
    learner = LearningController(
        db, store, router, enc.encode,
        config=LearnConfig(min_new_events=50, min_queries=10, min_gain=-1.0),
        plan_fn=_plan(adapter=True))
    learner.trainers["adapter"] = _CountingTrainer()
    _serve(router, small_bench, small_bench.train_idx[:60])
    d = learner.step().decisions["adapter"]
    assert d.action == "activation_conflict"
    # the never-deployed artifact must not linger as latest
    assert learner.registry.latest("adapter") is None


# -------------------------------------------------------- mirrored: StageGuard
def test_stage_guard_demotes_regressing_promotion(small_bench):
    guard_cfg = StageGuardConfig(min_samples=16, tolerance=0.02)
    db, enc, store, router, learner = _learn_world(
        small_bench, plan_fn=_plan(adapter=True), min_gain=-1.0)
    guard = StageGuard(router, guard_cfg)
    learner.guard = guard
    learner.trainers["adapter"] = _CountingTrainer()

    def observe(res, rel):
        guard.observe(res.stage_version, res.tools, rel)

    # build a rolling window on stage v0 so the promotion gets a baseline
    _serve(router, small_bench, small_bench.train_idx[:40], observe)
    report = learner.step()
    assert report.decisions["adapter"].action == "promoted"
    promoted_v = report.stage_version
    assert guard.check().action in ("insufficient_data", "no_baseline", "healthy")
    for _ in range(guard_cfg.min_samples):
        guard.observe(promoted_v, [0, 1, 2, 3, 4], [59])  # never relevant
    report = learner.step()
    assert report.guard.action == "demoted"
    assert report.guard.restored_version == router.stage_version
    assert not router.stage_set()[1].has_adapter  # back to the v0 stage set
    assert report.reason.startswith("cooldown after stage demotion")
    assert len(store) == 0  # the condemned-era window was purged
    assert learner.registry.latest("adapter") is None  # registry followed
    assert learner.step().decisions["adapter"].action == "below_trigger"


def test_stage_guard_handles_out_of_band_promotion(small_bench):
    """An unannounced set_stages still gets a baseline frozen from its
    predecessor and is demotable."""
    db, enc = _db_and_encoder(small_bench)
    router = SemanticRouter(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                            device=CPU)
    guard = StageGuard(router, StageGuardConfig(min_samples=8, tolerance=0.02))
    for _ in range(8):
        guard.observe(0, [0, 1, 2, 3, 4], [0])  # perfect NDCG on v0
    router.set_stages(StageSet(adapter_params=_adapter_params(0, 0.0)),
                      expect_version=0)  # no note_promotion
    for _ in range(8):
        guard.observe(1, [0, 1, 2, 3, 4], [59])  # regressing labels on v1
    report = guard.check()
    assert report.action == "demoted" and report.baseline == pytest.approx(1.0)
    assert guard.demotions and router.stage_version == 2


# ---------------------------------------------------- mirrored: window plumbing
def test_window_fingerprint_tracks_window_content():
    store = OutcomeStore(n_tools=4, capacity=100)
    fp0 = store.window_fingerprint()
    store.append(OutcomeEvent(np.array([1, 2]), 1, 1, 0.0))
    fp1 = store.window_fingerprint()
    assert fp1 != fp0
    assert store.window_fingerprint() == fp1  # stable when nothing changes
    store.clear()
    assert store.window_fingerprint() not in (fp0, fp1)  # watermark moved on


def test_build_train_window_splits_on_positive_rows(small_bench):
    db, enc = _db_and_encoder(small_bench)
    store = OutcomeStore(n_tools=len(db), capacity=50_000)
    router = SemanticRouter(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                            outcome_sink=store.append, device=CPU)
    assert build_train_window(db, store, enc.encode) is None  # empty window
    _serve(router, small_bench, small_bench.train_idx[:80])
    window = build_train_window(db, store, enc.encode, min_queries=10)
    assert window is not None
    assert len(np.intersect1d(window.train_idx, window.val_idx)) == 0
    # every held-out gate row carries at least one logged success
    assert (window.pos_mask[window.val_idx].sum(axis=1) > 0).all()
    assert window.table_version == db.table_version
    assert window.fingerprint == store.window_fingerprint()


def test_trainers_return_host_params_and_apply_on_the_device(small_bench):
    """Both trainers train on their device and hand back numpy params;
    `apply_to` puts them on the device it is given."""
    db, enc = _db_and_encoder(small_bench)
    store = OutcomeStore(n_tools=len(db), capacity=50_000)
    router = SemanticRouter(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                            outcome_sink=store.append, device=CPU)
    _serve(router, small_bench, small_bench.train_idx)
    window = build_train_window(db, store, enc.encode, min_queries=10)
    for trainer in (AdapterTrainer(device=CPU), RerankerTrainer(device=CPU)):
        trained = trainer.train(window)
        assert all(isinstance(v, np.ndarray) for v in trained.params.values())
        stages = trained.apply_to(StageSet(), artifact_version=7, device=CPU)
        params = stages.adapter_params if trainer.stage == "adapter" else stages.mlp_params
        assert all(v.device == torch.device(CPU) for v in params.values())
        assert stages.active == {trainer.stage}
        ndcg = stage_ndcg(window.table, window.query_emb[window.val_idx],
                          window.tokens(window.val_idx), window.pos_mask[window.val_idx],
                          stages, device=CPU)
        assert 0.0 < ndcg <= 1.0


# ------------------------------------------------------------ daemon loop
def test_daemon_loop_promotes_while_serving_and_records_errors(small_bench):
    """`start()` trains and promotes on the daemon thread while the main
    thread serves; a failing step is recorded (and published) once, the
    next good step clears it, and the health surface reads ok after."""
    import time

    from repro_torch.obs import EventBus, HealthMonitor

    bus = EventBus()
    db, enc = _db_and_encoder(small_bench)
    store = OutcomeStore(n_tools=len(db), capacity=50_000)
    router = SemanticRouter(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                            outcome_sink=store.append, backend="fused", bus=bus, device=CPU)
    learner = LearningController(db, store, router, enc.encode, bus=bus,
                                 config=LearnConfig(min_new_events=100, min_queries=10,
                                                    min_gain=-1.0),
                                 plan_fn=_plan(adapter=True))
    learner.trainers["adapter"] = _CountingTrainer()
    monitor = HealthMonitor(routers=[router], controllers=[learner], indexes=[router.index],
                            stores=[store], bus=bus)

    def wait_for(cond, timeout=30.0):
        deadline = time.monotonic() + timeout
        while not cond() and time.monotonic() < deadline:
            _serve(router, small_bench, small_bench.train_idx[:40])
            time.sleep(0.01)
        return cond()

    learner.start(interval_s=0.01)
    try:
        assert wait_for(lambda: router.stage_version >= 1), [r.reason for r in learner.reports]
        boom = RuntimeError("injected trainer failure")

        class Failing(_CountingTrainer):
            def train(self, window, live_stages=None):
                raise boom

        learner.trainers["adapter"] = Failing()
        assert wait_for(lambda: bus.last("loop_error") is not None)
        assert repr(boom) in bus.last("loop_error").details["error"]
        assert learner.last_loop_error is boom or learner.last_loop_error is None
        learner.trainers["adapter"] = _CountingTrainer()
        assert wait_for(lambda: bus.last("loop_recovered") is not None)
        assert wait_for(lambda: learner.last_loop_error is None)
    finally:
        learner.stop()
    assert learner._thread is None
    assert bus.counts()["loop_error"] == 1 and bus.counts()["loop_recovered"] == 1
    assert any(r.reason.startswith("step failed") for r in learner.reports)
    assert bus.counts()["promotion"] >= 1
    assert monitor.snapshot()["status"] == "ok"
    router.close()


# -------------------------------------------------- mirrored: threaded churn
def test_route_batch_concurrent_with_stage_churn(small_bench):
    """Scores stay self-consistent with the reported (table_version,
    stage_version) while a churn thread promotes and demotes stage sets
    under live batched serving."""
    db, enc = _db_and_encoder(small_bench)
    router = SemanticRouter(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                            stage_history_limit=4, device=CPU)
    adapter_sets = {True: StageSet(adapter_params=_adapter_params(3)), False: StageSet()}
    stop = threading.Event()
    n_churn = [0]

    def churn():
        # only this thread promotes, so version v carries the adapter iff v
        # is odd (v0 = no adapter)
        while not stop.is_set():
            router.set_stages(adapter_sets[n_churn[0] % 2 == 0],
                              expect_version=router.stage_version)
            n_churn[0] += 1

    queries = [small_bench.query_tokens[i] for i in small_bench.test_idx[:16]]
    q_emb = enc.encode(queries)
    q_adapted = adapter_sets[True].adapt_queries(q_emb)
    table = db.embeddings  # no table churn: isolate the stages
    t = threading.Thread(target=churn, daemon=True)
    t.start()
    try:
        for _ in range(30):
            for j, res in enumerate(router.route_batch(queries)):
                assert res.table_version == 0
                q = q_adapted[j] if res.stage_version % 2 == 1 else q_emb[j]
                expect = np.sort(table @ q)[::-1][: len(res.scores)]
                np.testing.assert_allclose(res.scores, expect, atol=1e-4)
    finally:
        stop.set()
        t.join()
    assert n_churn[0] > 0


# ------------------------------------------------------ measuring the bands
SIGMAS = 3  # standard errors of a five-seed mean added on each side
MIN_HALF = 1e-4  # where every draw is equal: refine-only's tolerance


def label_blind(pkg, seed=0):
    """`pkg` with trainers that learn from their window's outcome labels
    shuffled across its train rows and, apart, across its val rows: a
    trainer that ignores its labels. The bands must keep its NDCG@5 out
    where a trained stage has something to learn."""
    L = pkg.learn

    def blind(window):
        rng = np.random.default_rng(seed)
        pos, neg = window.pos_mask.copy(), window.neg_mask.copy()
        for rows in (window.train_idx, window.val_idx):
            perm = rows[rng.permutation(len(rows))]
            pos[rows], neg[rows] = window.pos_mask[perm], window.neg_mask[perm]
        return dataclasses.replace(window, pos_mask=pos, neg_mask=neg)

    class Adapter(L.AdapterTrainer):
        def train(self, window, live_stages=None):
            return super().train(blind(window), live_stages)

    class Reranker(L.RerankerTrainer):
        def train(self, window, live_stages=None):
            return super().train(blind(window), live_stages)

    learn = SimpleNamespace(**{**{n: getattr(L, n) for n in L.__all__},
                               "AdapterTrainer": Adapter, "RerankerTrainer": Reranker})
    return SimpleNamespace(**{**vars(pkg), "learn": learn})


def seed_means(points):
    return [{stage: float(np.mean(v)) for stage, v in p["ndcg_by_seed"].items()}
            for p in points]


def measure_bands(bench, fractions, n_test):
    """The JAX package's sweep over trainer seeds 0-4 and, apart, 5-9. Per
    point and stage: the two five-seed means (m_a, m_b), the standard
    deviation s of the ten single draws, and the band [min(m_a, m_b) - h,
    max(m_a, m_b) + h], h = max(SIGMAS * s / sqrt(5), MIN_HALF), rounded
    outwards and clipped to [0, 1], that the port's five-seed mean must
    fall in."""
    a = scenarios.density_sweep(JAX, bench, fractions, n_test, trainer_seeds=range(5))
    b = scenarios.density_sweep(JAX, bench, fractions, n_test, trainer_seeds=range(5, 10))
    readings, bands = [], []
    for pa, pb in zip(a, b, strict=True):
        reading, band = {}, {}
        for stage, va in pa["ndcg_by_seed"].items():
            vb = pb["ndcg_by_seed"][stage]
            m_a, m_b, s = float(np.mean(va)), float(np.mean(vb)), float(np.std(va + vb, ddof=1))
            half = max(SIGMAS * s / np.sqrt(5), MIN_HALF)
            reading[stage] = dict(mean_0_4=round(m_a, 4), mean_5_9=round(m_b, 4),
                                  sd=round(s, 4), draws=[round(x, 4) for x in va + vb])
            band[stage] = (max(float(np.floor((min(m_a, m_b) - half) * 1e4) / 1e4), 0.0),
                           min(float(np.ceil((max(m_a, m_b) + half) * 1e4) / 1e4), 1.0))
        readings.append(reading)
        bands.append(band)
    return a, readings, bands


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import conftest
    from repro.data.benchmarks import make_metatool_like

    for name, bench, fractions, n_test in (
            ("small_bench", conftest.small_bench.__wrapped__(), SWEEP_FRACTIONS, SWEEP_TEST),
            ("full", make_metatool_like(seed=0, n_tools=scenarios.LEARN_TOOLS,
                                        n_queries=scenarios.LEARN_QUERIES),
             scenarios.LEARN_FRACTIONS, scenarios.LEARN_TEST)):
        points, readings, bands = measure_bands(bench, fractions, n_test)
        for p, r in zip(points, readings):
            print(name, {k: p[k] for k in ("events", "density", "plan", "ndcg_at_5",
                                           "promoted", "ndcg_promoted")}, r, flush=True)
        print(name, "refine-only", tuple(round(p["ndcg_at_5"]["refine_only"], 6)
                                         for p in points))
        print(name, "bands", bands, flush=True)
        blind = scenarios.density_sweep(label_blind(PORT), bench, fractions, n_test,
                                         trainer_seeds=range(5))
        print(name, "label-blind port five-seed means",
              [{k: round(v, 4) for k, v in m.items()} for m in seed_means(blind)], flush=True)
