"""Scenarios that drive the serving, control and learning planes end to
end, through a package given as a namespace (`port_pkg(device)` for this
one), so that `chip_smoke.py` runs them on the card and the parity tests
run them on the CPU through both the JAX package and the port:

  * the §7.2 refinement loop (`loop_world`, `run_loop`,
    `inject_and_roll_back`): `benchmarks/control_bench.py`'s first leg and
    `examples/live_loop.py`'s act 2;
  * the §7.3 density sweep (`density_sweep`): `benchmarks/learn_bench.py`'s
    refine-only / +adapter / +reranker NDCG@5 and its gated promotion;
  * the learning plane's three acts (`stages_acts`):
    `examples/live_loop.py --stages`;
  * the training path's gradients on a device against the CPU's
    (`grad_gaps`, over `GRAD_CASES`), which needs no namespace.

The defaults are those scripts' settings. Nothing here imports the JAX
package: the namespace brings it.
"""
from __future__ import annotations

import dataclasses
import time
import types

import numpy as np
import torch

import repro_torch.control as control
import repro_torch.learn as learn
from repro_torch.convert import params_from_jax
from repro_torch.core.deployment import recommend_stages
from repro_torch.configs import get_config
from repro_torch.core.refine import RefineConfig, refine_with_gate
from repro_torch.embedding.bag_encoder import BagEncoder
from repro_torch.index import ToolIndexManager
from repro_torch.metrics.retrieval import ndcg_at_k
from repro_torch.models import model as M
from repro_torch.models.config import reduced
from repro_torch.models.params import tree_leaves
from repro_torch.obs import EventBus, HealthMonitor, QualityMonitor
from repro_torch.optim.base import tree_map
from repro_torch.router.gateway import SemanticRouter
from repro_torch.router.stages import StageSet
from repro_torch.router.tooldb import ToolRecord, ToolsDatabase

# the loop (control_bench.py's full settings): MetaTool-like with 2,400
# queries, 6 windows of train queries routed in batches of 64,
# ControllerConfig(min_events=1000, min_queries=30),
# GuardConfig(min_samples=32), held-out NDCG@5 over 400 test queries; act 2
# serves 300 labelled test queries on the good table first
LOOP_QUERIES, LOOP_WINDOWS, LOOP_BATCH, LOOP_EVAL = 2400, 6, 64, 400
LOOP_MIN_EVENTS, LOOP_MIN_QUERIES, LOOP_MIN_SAMPLES = 1000, 30, 32
LOOP_ACT2_BASELINE = 300
# learn_bench.py's full settings: MetaTool-like at 600 tools and 4,000
# queries, cumulative windows of 0.2 / 0.5 / 1.0 of the train queries,
# NDCG@5 over 400 test queries; a gated promotion may lose at most
# REGRESSION_TOL
LEARN_TOOLS, LEARN_QUERIES, LEARN_TEST = 600, 4000, 400
LEARN_FRACTIONS = (0.2, 0.5, 1.0)
REGRESSION_TOL = 0.02
# the JAX package's readings at those settings (measured on a CPU by
# `python tests/test_torch_learn.py`): refine-only NDCG@5 at each point
# (deterministic), and the bands that hold the port's +adapter / +reranker
# NDCG@5 averaged over five trainer seeds: the JAX package's five-seed
# means over seeds 0-4 and 5-9, widened on each side by three standard
# errors of a five-seed mean (the sd of the ten draws over sqrt(5))
LEARN_REFINE_ONLY = (0.850080, 0.885561, 0.889972)
LEARN_BANDS = (
    {"plus_adapter": (0.8533, 0.8923), "plus_rerank": (0.2384, 0.8933)},
    {"plus_adapter": (0.8864, 0.8917), "plus_rerank": (0.8415, 0.8721)},
    {"plus_adapter": (0.8908, 0.9026), "plus_rerank": (0.8802, 0.8944)})
# live_loop.py --stages: the sparse window, held-out queries, the learner's
# trigger and the stage guard's samples
LEARN_SPARSE, LEARN_EVAL, LEARN_MIN_NEW, LEARN_MIN_SAMPLES = 600, 300, 1000, 64
# the training path on a device: reduced configs whose `loss_fn` gradients
# are held against the CPU's leaf by leaf, (overrides, relative tolerance):
# 1e-4, or 1e-3 where an SSD scan is on the path (the parity tests' own)
GRAD_CASES = {"hymba-1.5b": (dict(sliding_window=16), 1e-3), "dbrx-132b": ({}, 1e-4),
              "llama-3.2-vision-90b": ({}, 1e-4)}


def grad_gaps(arch, device, overrides=None, seed=0, batch=2, seq=40):
    """{leaf path: ||g_device - g_cpu|| / ||g_cpu||} of `M.loss_fn`'s
    gradients for the reduced float32 `arch`, drawn from `seed` on the CPU
    (attention at a d_model fan-in, the VLM's gates open) and copied to
    `device`, over one numpy batch (seeded image embeddings for the VLM).
    A leaf whose CPU gradient is zero reads the absolute gap."""
    cfg = reduced(get_config(arch), **(overrides or {}))
    params = M.open_cross_gates(cfg, M.attention_at_d_model_fan_in(
        cfg, M.init(cfg, torch.Generator().manual_seed(seed), "cpu")))
    rng = np.random.default_rng(seed)
    shape = (batch, seq) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    data = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.cross_attn_every:
        data["image_embeds"] = rng.normal(
            size=(batch, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)

    def grads(dev):
        p = tree_map(lambda t: t.to(dev).requires_grad_(), params)
        loss, _ = M.loss_fn(cfg, p, {k: torch.from_numpy(v).to(dev) for k, v in data.items()})
        paths, leaves = zip(*tree_leaves(p))
        return dict(zip(paths, (g.cpu() for g in torch.autograd.grad(loss, leaves))))

    on_cpu, on_dev = grads(torch.device("cpu")), grads(torch.device(device))
    return {path: float((on_dev[path] - g).norm() / (g.norm() if g.norm() > 0 else 1.0))
            for path, g in on_cpu.items()}


def port_pkg(device):
    """The port's side of the scenarios below, on `device`. They take a
    package as a namespace, so a test can hand them the JAX package's side
    too."""

    def refine(table, q_train, pos_train, q_val, pos_val):
        """learn_bench's refine-only stage on `device`: the refined table."""
        up = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
              for a in (table, q_train, pos_train, q_val, pos_val)]
        res = refine_with_gate(*up, RefineConfig(keep_history=False, gate_metric="ndcg"))
        return res.embeddings.cpu().numpy()

    return types.SimpleNamespace(
        control=control, learn=learn, Router=SemanticRouter, DB=ToolsDatabase,
        Record=ToolRecord, StageSet=StageSet, Bus=EventBus, Quality=QualityMonitor,
        Health=HealthMonitor, Index=ToolIndexManager, plan=recommend_stages, refine=refine,
        params=lambda tree: params_from_jax(tree, device),
        encoder=lambda vocab: BagEncoder(vocab, device=device),
        device_kw={"device": device})


def loop_world(pkg, bench, table, backend="dense", *, min_events=LOOP_MIN_EVENTS,
               min_queries=LOOP_MIN_QUERIES, min_samples=LOOP_MIN_SAMPLES, guard_k=5,
               tolerance=0.02, wired=True, metrics=False, tracer=None):
    """One package's §7.2 serving + control plane over `table`: a router
    wired to an outcome store, a table guard and a refinement controller
    (which refines on the router's device) and, when `wired`, to a bus and
    a quality monitor that watch the database before the index does. With
    a `metrics` registry the index manager is built here and records its
    build times there; else the router owns it."""
    enc = pkg.encoder(bench.vocab)
    db = pkg.DB([pkg.Record(i, f"tool_{i}", bench.desc_tokens[i], int(bench.tool_category[i]))
                 for i in range(bench.n_tools)], table.copy())
    bus = quality = None
    if wired:
        bus = pkg.Bus()
        quality = pkg.Quality(bus=bus)
        bus.watch_db(db)
        quality.watch_db(db)
    store = pkg.control.OutcomeStore(n_tools=len(db), capacity=200_000)
    index = None
    if metrics is not False:
        index = pkg.Index(db, backend=backend, metrics=metrics, bus=bus, **pkg.device_kw)
    router = pkg.Router(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                        outcome_sink=store.append, backend=backend, index=index,
                        metrics=metrics, bus=bus, quality=quality, tracer=tracer,
                        **pkg.device_kw)
    guard = pkg.control.TableGuard(
        db, pkg.control.GuardConfig(k=guard_k, min_samples=min_samples, tolerance=tolerance),
        bus=bus)
    controller = pkg.control.RefinementController(
        db, store, enc.encode, routers=[router],
        config=pkg.control.ControllerConfig(min_events=min_events, min_queries=min_queries),
        guard=guard, bus=bus, **pkg.device_kw)
    return types.SimpleNamespace(enc=enc, db=db, bus=bus, quality=quality, store=store,
                                 index=router.index, router=router, guard=guard,
                                 controller=controller)


def close_world(w):
    w.router.close()
    w.index.close()


def serve_and_log(router, bench, idx, observe=None, batch_size=LOOP_BATCH, check=None):
    """Route `idx` in batches and record every routed tool's outcome;
    `observe(result, relevant)` sees each result, `check(idx, results)`
    each batch."""
    for lo in range(0, len(idx), batch_size):
        chunk = idx[lo:lo + batch_size]
        results = router.route_batch([bench.query_tokens[qi] for qi in chunk])
        if check is not None:
            check(chunk, results)
        for qi, res in zip(chunk, results):
            for t in res.tools:
                router.record_outcome(bench.query_tokens[qi], t, int(t in bench.relevant[qi]))
            if observe is not None:
                observe(res, bench.relevant[qi])


def serve_window(w, bench, idx, batch_size=LOOP_BATCH, check=None):
    """`serve_and_log` through the loop world's router, feeding its table
    guard and quality monitor."""
    def observe(res, relevant):
        w.guard.observe(res.table_version, res.tools, relevant)
        if w.quality is not None:
            w.quality.observe(res.tools, relevant)

    serve_and_log(w.router, bench, idx, observe, batch_size, check)


def heldout_ndcg(w, bench, n_eval=LOOP_EVAL):


    idx = bench.test_idx[:n_eval]
    results = w.router.route_batch([bench.query_tokens[qi] for qi in idx])
    return float(np.mean([ndcg_at_k(r.tools, bench.relevant[qi], 5)
                          for qi, r in zip(idx, results)]))


def run_loop(w, bench, n_windows=LOOP_WINDOWS, n_eval=LOOP_EVAL):
    """The §7.2 loop (`benchmarks/control_bench.py`'s first leg): the series
    [(events, table_version, swapped, NDCG@5)] as LOOP_TRAJECTORY, the
    first before any step; the steps' reports; the live table after each."""
    series = [(0, w.db.table_version, False, heldout_ndcg(w, bench, n_eval))]
    reports, tables = [], []
    for idx in np.array_split(bench.train_idx, n_windows):
        serve_window(w, bench, idx)
        rep = w.controller.step()
        reports.append(rep)
        tables.append(w.db.embeddings.copy())
        series.append((w.store.total_ingested, rep.table_version, rep.swapped,
                       heldout_ndcg(w, bench, n_eval)))
    return series, reports, tables


def inject_and_roll_back(w, bench, n_baseline=LOOP_ACT2_BASELINE, after_inject=None):
    """`examples/live_loop.py`'s act 2: labelled traffic on the good table,
    then a scrambled and shifted table bypasses the gate (`after_inject()`
    runs on it); shadow windows until the guard rolls it back. Returns the
    guard's actions."""
    serve_window(w, bench, bench.test_idx[:n_baseline])
    rng = np.random.default_rng(0)
    good = w.db.table_version
    bad = w.db.embeddings.copy()
    rng.shuffle(bad, axis=0)  # tool vectors scrambled across tools
    bad += 3.0 * bad.std()  # and shifted off the query population
    w.db.swap_table(bad, expect_current=good)
    if after_inject is not None:
        after_inject()
    actions = []
    for idx in np.array_split(bench.test_idx, 3):
        serve_window(w, bench, idx)
        rep = w.controller.step()
        actions.append(rep.guard.action)
        if rep.guard.action == "rolled_back":
            break
    return actions


def learn_db(pkg, bench, **router_kw):
    """(encoder, database, outcome store, router): `bench`'s tools served by
    one package's router, every outcome straight into the store."""
    enc = pkg.encoder(bench.vocab)
    db = pkg.DB([pkg.Record(i, f"tool_{i}", bench.desc_tokens[i], int(bench.tool_category[i]))
                 for i in range(bench.n_tools)], enc.encode(bench.desc_tokens))
    store = pkg.control.OutcomeStore(n_tools=len(db), capacity=200_000)
    router = pkg.Router(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                        outcome_sink=store.append, **router_kw, **pkg.device_kw)
    return enc, db, store, router


def density_sweep(pkg, bench, fractions, n_test, trainer_seeds=(0,), backend="dense"):
    """`benchmarks/learn_bench.py`'s density sweep through one package:
    cumulative windows of the train queries at fixed tool count; at each
    point the frozen window's refine-only table, +adapter and +reranker
    trained from it with each of `trainer_seeds` (NDCG@5 on `n_test` test
    queries: `ndcg_at_5` for the first seed, `ndcg_by_seed` for all), the
    density plan, and the first seed's gated promotion (plan veto, then the
    held-out gate per stage) that must not regress refine-only by more
    than REGRESSION_TOL. Each point records its trainers' seconds and its
    gate margins."""


    L, dk = pkg.learn, pkg.device_kw
    enc, db, store, router = learn_db(pkg, bench, backend=backend)
    test_idx = bench.test_idx[:n_test]
    test = (enc.encode([bench.query_tokens[i] for i in test_idx]),
            [bench.query_tokens[i] for i in test_idx], bench.relevance_matrix()[test_idx])
    cut = [int(round(f * len(bench.train_idx))) for f in fractions]
    points, served = [], 0
    for hi in cut:
        serve_and_log(router, bench, bench.train_idx[served:hi])
        served = hi
        plan = pkg.plan(len(db), store.total_ingested)
        window = L.build_train_window(db, store, enc.encode, min_queries=30)
        if window is None:
            raise AssertionError(f"sweep window at {store.total_ingested} events too sparse")
        tr, va = window.train_idx, window.val_idx
        t = time.perf_counter()
        refined = pkg.refine(window.table, window.query_emb[tr], window.pos_mask[tr],
                             window.query_emb[va], window.pos_mask[va])
        refine_s = time.perf_counter() - t
        window = dataclasses.replace(window, table=refined)
        val = (window.query_emb[va], window.tokens(va), window.pos_mask[va])

        def ndcg_of(stages, split):
            return L.stage_ndcg(refined, *split, stages, **dk)

        base = pkg.StageSet()
        val_base = ndcg_of(base, val)
        trained, train_s = {}, {"adapter": [], "rerank": []}
        by_seed = {"plus_adapter": [], "plus_rerank": []}
        for trainer_seed in trainer_seeds:
            for trainer in (L.AdapterTrainer(**dk), L.RerankerTrainer(**dk)):
                trainer.config = dataclasses.replace(trainer.config, seed=trainer_seed)
                t = time.perf_counter()
                product = trainer.train(window)
                train_s[trainer.stage].append(time.perf_counter() - t)
                trained.setdefault(trainer.stage, product)
                by_seed[f"plus_{trainer.stage}"].append(
                    ndcg_of(product.apply_to(base, **dk), test))
        ndcg = {"refine_only": ndcg_of(base, test),
                **{stage: vals[0] for stage, vals in by_seed.items()}}
        promoted, margins, config = [], {}, base
        for stage, wanted in (("adapter", plan.contrastive_adapter),
                              ("rerank", plan.mlp_reranker)):
            if not wanted:
                continue
            candidate = trained[stage].apply_to(config, **dk)
            margins[stage] = ndcg_of(candidate, val) - max(val_base, ndcg_of(config, val))
            if margins[stage] > 0:
                config = candidate
                promoted.append(stage)
        ndcg_promoted = ndcg_of(config, test)
        points.append(dict(
            events=store.total_ingested, density=plan.density, plan=sorted(plan.stages),
            n_val=len(va), ndcg_at_5=ndcg, ndcg_by_seed=by_seed, promoted=promoted,
            ndcg_promoted=ndcg_promoted,
            promotion_regressed=bool(ndcg_promoted < ndcg["refine_only"] - REGRESSION_TOL),
            gate_margins=margins, refine_s=refine_s, train_s=train_s,
            train_info={k: v.info for k, v in trained.items()}))
    router.close()
    return points


def stages_acts(pkg, bench):
    """`examples/live_loop.py --stages`' three acts through one package
    over a fused router, with its asserts: a sparse window suppresses both
    learned stages; a dense one promotes the adapter with a held-out lift;
    a corrupted out-of-band StageSet is demoted by the StageGuard and
    serving restored within 1e-6. Returns a summary and the world (router,
    learner, ...)."""



    L = pkg.learn
    bus = pkg.Bus()
    enc, db, store, router = learn_db(pkg, bench, backend="fused", bus=bus)
    bus.watch_db(db)
    guard = L.StageGuard(router, L.StageGuardConfig(k=5, min_samples=LEARN_MIN_SAMPLES),
                         bus=bus)
    registry = L.ArtifactRegistry()
    learner = L.LearningController(
        db, store, router, enc.encode, registry=registry, guard=guard,
        config=L.LearnConfig(min_new_events=LEARN_MIN_NEW), bus=bus, **pkg.device_kw)

    def observe(res, relevant):
        guard.observe(res.stage_version, res.tools, relevant)

    def heldout():
        idx = bench.test_idx[:LEARN_EVAL]
        results = router.route_batch([bench.query_tokens[qi] for qi in idx])
        return float(np.mean([ndcg_at_k(r.tools, bench.relevant[qi], 5)
                              for qi, r in zip(idx, results)]))

    steps = []

    def step(act):
        t = time.perf_counter()
        rep = learner.step()
        steps.append(dict(act=act, seconds=time.perf_counter() - t, guard=None
                          if rep.guard is None else rep.guard.action,
                          decisions={k: d.action for k, d in rep.decisions.items()}))
        return rep

    def check(ok, what):
        if not ok:
            raise AssertionError(f"stages acts: {what}")

    # act 1: a sparse window; the density plan suppresses both stages
    serve_and_log(router, bench, bench.train_idx[:LEARN_SPARSE])
    rep = step(1)
    check(rep.decisions["adapter"].action == "suppressed"
          and rep.decisions["rerank"].action == "suppressed"
          and rep.active == frozenset(), f"act 1 decisions {steps[-1]}")
    # act 2: a dense window; the adapter clears the plan and the gate
    ndcg_sparse = heldout()
    serve_and_log(router, bench, bench.train_idx[LEARN_SPARSE:])
    rep = step(2)
    d = rep.decisions["adapter"]
    check(d.action == "promoted" and d.ndcg_candidate > d.ndcg_current,
          f"act 2 adapter {d.action}: {d.reason}")
    check(rep.decisions["rerank"].action == "suppressed" and rep.active == {"adapter"},
          f"act 2 decisions {steps[-1]}")
    art = registry.latest("adapter")
    ndcg_dense = heldout()
    check(ndcg_dense > ndcg_sparse, f"act 2 no lift {ndcg_sparse:.6f} -> {ndcg_dense:.6f}")
    serve_and_log(router, bench, bench.test_idx[:LEARN_EVAL], observe)
    # act 3: a corrupted adapter bypasses the gate; the guard demotes it
    sv, good = router.stage_set()
    rng = np.random.default_rng(0)
    bad = {k: rng.normal(scale=0.5, size=tuple(v.shape)).astype(np.float32)
           for k, v in good.adapter_params.items()}
    router.set_stages(dataclasses.replace(good, adapter_params=pkg.params(bad)),
                      expect_version=sv)
    ndcg_bad = heldout()
    guard_actions = []
    for idx in np.array_split(bench.test_idx, 3):
        serve_and_log(router, bench, idx, observe)
        rep = step(3)
        guard_actions.append(rep.guard.action)
        if rep.guard.action == "demoted":
            break
    _, live = router.stage_set()
    check(bool(guard.demotions) and live.adapter_artifact == art.version,
          f"act 3 guard {guard_actions}, live artifact {live.adapter_artifact}")
    restored = heldout()
    check(abs(restored - ndcg_dense) < 1e-6,
          f"act 3 restored NDCG@5 {restored:.6f} != good {ndcg_dense:.6f}")
    kinds = [e.kind for e in bus.events()]
    for kind in ("promotion", "stage_swap", "demotion", "cooldown"):
        check(kind in kinds, f"{kind} never reached the bus ({sorted(set(kinds))})")
    summary = dict(
        act2=dict(ndcg_current=d.ndcg_current, ndcg_candidate=d.ndcg_candidate,
                  gate_margin=d.ndcg_candidate - d.ndcg_current, artifact=art.version,
                  train_info=art.metrics),
        ndcg_sparse=ndcg_sparse, ndcg_dense=ndcg_dense, ndcg_bad=ndcg_bad,
        ndcg_restored=restored, guard_actions=guard_actions, steps=steps, bus_kinds=kinds)
    world = types.SimpleNamespace(enc=enc, db=db, store=store, router=router, bus=bus,
                                  guard=guard, learner=learner, registry=registry)
    return summary, world
