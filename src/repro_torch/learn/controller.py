"""LearningController: density-gated training + promotion of learned stages.

Counterpart of `repro/learn/controller.py`, with the same contract. Training
and the held-out gate run on the controller's `device` (`None` means its
router's device); the trained params come back to the host for the
registry and go up to that device again in the promoted StageSet.

The control plane (`repro_torch.control`) closes the §7.2 loop for the zero-cost
Stage-1 refinement; this controller closes it for the *learned* stages the
paper says to add "only when data density warrants it" (§7.3). One `step()`
= one pass of:

    (drain routers) -> StageGuard check -> recommend_stages plan over the
    live outcome counters -> per stage {adapter, rerank}:
        plan veto?  -> suppressed (sparse regimes never even train)
        trigger?    -> enough new events since this stage last trained
        train       -> StageTrainer off the hot path (table snapshot +
                       window fingerprint frozen into a TrainWindow)
        gate        -> held-out NDCG@5 of the candidate StageSet vs the
                       live one, on the exact serving composition
        activate    -> ArtifactRegistry.register + compare-and-swap
                       `SemanticRouter.set_stages(expect_version=...)`
        monitor     -> StageGuard.note_promotion (shadow windows +
                       auto-demotion on live labelled traffic)

The plan policy is the same `core.deployment.recommend_stages` decision
table the RefinementController records on every triggered step — here it
*acts*: below the §7.2 density threshold the re-ranker is never trained,
so the paper's negative result (the 2,625-param MLP hurts when outcomes
are sparse relative to the tool set) becomes live behavior instead of a
logged warning. Promotion is strictly additive-gated (`min_gain`): a
heavier serving stage must *beat* the current configuration on held-out
evidence, not tie it.

Step-driven for tests/cron; `start(interval_s)` runs the same `step()` on
an exception-surviving daemon thread, like `RefinementController`. After a
guard demotion the controller holds a training cooldown (watermarks reset
to the live ingest count): the window is dominated by outcomes the
condemned stage set generated, and retraining from it immediately would
re-promote essentially the same regression in a flap loop.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.deployment import DeploymentPlan, recommend_stages
from repro_torch.learn.guard import StageGuard, StageGuardReport
from repro_torch.learn.registry import ArtifactRegistry
from repro_torch.learn.trainers import (
    AdapterTrainer,
    RerankerTrainer,
    TrainWindow,
    stage_ndcg,
)
from repro_torch.obs import clock as obs_clock
from repro_torch.router.tooldb import ConflictError, ToolsDatabase

__all__ = [
    "LearnConfig",
    "StageDecision",
    "LearnReport",
    "LearningController",
    "build_train_window",
]


def build_train_window(
    db: ToolsDatabase,
    store,
    embed_batch_fn: Callable[[Sequence[np.ndarray]], np.ndarray],
    val_fraction: float = 0.15,
    min_queries: int = 40,
    seed: int = 0,
) -> Optional[TrainWindow]:
    """Freeze one (table snapshot, outcome window, split) training set.

    Returns None when the window cannot support a training run: fewer than
    `min_queries` unique queries, or too few positive-bearing queries to
    hold out a gate slice. The gate slice is drawn ONLY from queries with
    >= 1 logged success (failure-only rows are excluded from
    batched_ndcg_at_k, so a val slice without positives would make the gate
    vacuous) — the same discipline as `RefinementController`.
    """
    batch = store.build_refinement_batch(embed_batch_fn)
    if batch.n_queries < min_queries:
        return None
    pos_rows = np.flatnonzero(batch.pos_mask.sum(axis=1) > 0)
    n_val = max(int(round(val_fraction * len(pos_rows))), 2)
    if len(pos_rows) < 2 * n_val:
        return None
    rng = np.random.default_rng(seed + store.total_ingested)
    val_idx = np.sort(rng.permutation(pos_rows)[:n_val])
    train_idx = np.setdiff1d(np.arange(batch.n_queries), val_idx)
    table_version, table = db.snapshot()
    return TrainWindow(
        table=np.asarray(table),
        table_version=table_version,
        query_emb=batch.query_emb,
        query_tokens=batch.query_tokens,
        pos_mask=batch.pos_mask,
        neg_mask=batch.neg_mask,
        tool_category=db.categories(),
        train_idx=train_idx,
        val_idx=val_idx,
        # taken atomically with the event snapshot the batch was built from,
        # so the stamped lineage matches the training data even while the
        # router's outcome_sink appends concurrently
        fingerprint=batch.fingerprint,
    )


@dataclasses.dataclass(frozen=True)
class LearnConfig:
    min_new_events: int = 512  # per-stage retrain trigger (fresh evidence)
    val_fraction: float = 0.15  # held-out slice of positive-bearing queries
    min_queries: int = 40  # don't train off a handful of queries
    # a promotion must beat the live config by MORE than this on held-out
    # NDCG@5 — learned stages carry serving cost, so a tie is a rejection
    min_gain: float = 0.0
    k: int = 5
    seed: int = 0


@dataclasses.dataclass
class StageDecision:
    """What one step decided for one learned stage."""

    stage: str
    # "suppressed" | "below_trigger" | "too_few_queries" | "train_failed" |
    # "gate_rejected" | "table_moved" | "promoted" | "activation_conflict"
    action: str
    reason: str = ""
    ndcg_current: Optional[float] = None  # held-out NDCG@5 of the live set
    ndcg_candidate: Optional[float] = None  # ... of the trained candidate
    artifact_version: Optional[int] = None  # registry version when promoted
    stage_version: Optional[int] = None  # router stage version after action


@dataclasses.dataclass
class LearnReport:
    """What one `step()` did, for logs/tests/benchmarks."""

    plan: Optional[DeploymentPlan]
    n_events: int = 0
    density: float = 0.0
    decisions: Dict[str, StageDecision] = dataclasses.field(default_factory=dict)
    guard: Optional[StageGuardReport] = None
    stage_version: int = 0  # live stage version when the step finished
    active: frozenset = frozenset()  # live stages when the step finished
    reason: str = ""


class LearningController:
    def __init__(
        self,
        db: ToolsDatabase,
        store,  # OutcomeStore
        router,  # SemanticRouter whose StageSet this plane deploys to
        embed_batch_fn: Callable[[Sequence[np.ndarray]], np.ndarray],
        registry: Optional[ArtifactRegistry] = None,
        guard: Optional[StageGuard] = None,
        config: LearnConfig = LearnConfig(),
        adapter_trainer: Optional[AdapterTrainer] = None,
        reranker_trainer: Optional[RerankerTrainer] = None,
        routers: Sequence = (),  # extra routers to drain into the store
        clock: Callable[[], float] = obs_clock.monotonic,
        # injectable for tests; production keeps the §7.3 decision table
        plan_fn: Callable[[int, int], DeploymentPlan] = recommend_stages,
        bus: Optional["EventBus"] = None,  # repro_torch.obs.events lifecycle surface
        flight_recorder=None,  # duck-typed `record_crash(exc, source=)` hook
        device: Union[str, torch.device, None] = None,
    ):
        self.db = db
        self.store = store
        self.router = router
        self.embed_batch_fn = embed_batch_fn
        # where training and the gate run, and where promoted params live:
        # the serving router's device unless asked
        self.device = resolve_device(router.device if device is None else device)
        self.registry = registry if registry is not None else ArtifactRegistry()
        self.guard = guard
        self.config = config
        self.trainers = {
            "adapter": adapter_trainer or AdapterTrainer(device=self.device),
            "rerank": reranker_trainer or RerankerTrainer(k=config.k, device=self.device),
        }
        self.routers = list(routers)
        self.clock = clock
        self.plan_fn = plan_fn
        # lifecycle events (promotion, gate_reject, cooldown, loop_error
        # transitions); demotions reach the bus via the StageGuard's own bus
        self.bus = bus
        # black-box hook: a daemon-step crash dumps the full telemetry state
        # (works without a bus; the recorder's debounce dedupes against the
        # loop_error event when both paths are wired)
        self.flight_recorder = flight_recorder
        self.reports: List[LearnReport] = []
        # daemon-loop health surface: most recent step() exception, cleared
        # by the next successful step (mirrors RefinementController) — a
        # health check polls this instead of scanning reports
        self.last_loop_error: Optional[BaseException] = None
        # per-stage trigger watermark: a stage retrains only on fresh
        # evidence (min_new_events ingested since its last training attempt)
        self._seen: Dict[str, int] = {"adapter": 0, "rerank": 0}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------------ step
    def step(self) -> LearnReport:
        for router in self.routers:
            self.store.drain_router(router)
        guard_report = self.guard.check() if self.guard is not None else None
        if guard_report is not None and guard_report.action == "demoted":
            # cooldown: the window is dominated by outcomes the condemned
            # stage set served — a retrain from it would pass the same gate
            # the condemned artifact passed and re-promote essentially the
            # same regression in a flap loop. Purge the window and consume
            # the watermarks so training restarts from fresh evidence — the
            # same discipline RefinementController applies after a guard
            # table rollback (and on the same store, when both planes share
            # one: condemned-era outcomes are biased evidence for both).
            n_purged = self.store.clear()
            for stage in self._seen:
                self._seen[stage] = self.store.total_ingested
            # the registry must agree with what serves: drop the condemned
            # artifact(s) so `latest` cannot resurrect them
            self._sync_registry_to_live()
            report = LearnReport(
                plan=None,
                reason=(
                    f"cooldown after stage demotion "
                    f"({n_purged} condemned-era events purged)"
                ),
            )
            if self.bus is not None:
                self.bus.publish("cooldown", plane="learn", purged=n_purged)
        else:
            report = self._learn_step()
        report.guard = guard_report
        report.stage_version, stages = self.router.stage_set()
        report.active = stages.active
        self.reports.append(report)
        return report

    def _learn_step(self) -> LearnReport:
        cfg = self.config
        pos_counts, neg_counts = self.store.tool_counts()
        n_examples = int(pos_counts.sum() + neg_counts.sum())
        # the same §7.2/§7.3 decision table the RefinementController records
        # on its reports — evaluated over the live counters, and acted on
        plan = self.plan_fn(len(self.db), n_examples)
        report = LearnReport(
            plan=plan, n_events=len(self.store), density=plan.density
        )
        window: Optional[TrainWindow] = None
        window_built = False  # None is also a valid build result (unusable
        for stage, wanted in (  # window) — don't rebuild it per stage
            ("adapter", plan.contrastive_adapter),
            ("rerank", plan.mlp_reranker),
        ):
            if not wanted:
                report.decisions[stage] = StageDecision(
                    stage, "suppressed", reason=plan.reason
                )
                continue
            n_new = self.store.total_ingested - self._seen[stage]
            if n_new < cfg.min_new_events:
                report.decisions[stage] = StageDecision(
                    stage,
                    "below_trigger",
                    reason=f"{n_new} new events < {cfg.min_new_events}",
                )
                continue
            if not window_built:
                window = self._build_window()
                window_built = True
            report.decisions[stage] = self._consider(stage, window)
        return report

    def _sync_registry_to_live(self) -> None:
        """Roll the registry back to the artifacts the live StageSet serves.

        A StageGuard demotion restores a previous StageSet on the router;
        without this, the condemned artifact would linger as
        `registry.latest(stage)` and any lineage consumer (persistence,
        displays, future warm starts) would pick up exactly what the guard
        just condemned. A live artifact no longer retained by the bounded
        registry history degrades to dropping the stage's whole retained
        lineage — everything newer than it is condemned by construction.
        """
        _, stages = self.router.stage_set()
        live = {
            "adapter": stages.adapter_artifact,
            "rerank": stages.rerank_artifact,
        }
        for stage, live_version in live.items():
            latest = self.registry.latest(stage)
            if latest is None or latest.version == live_version:
                continue
            if live_version in self.registry.versions(stage):
                self.registry.rollback(stage, to_version=live_version)
            else:
                for v in self.registry.versions(stage):
                    self.registry.discard(stage, v)

    def _build_window(self) -> Optional[TrainWindow]:
        cfg = self.config
        return build_train_window(
            self.db,
            self.store,
            self.embed_batch_fn,
            val_fraction=cfg.val_fraction,
            min_queries=cfg.min_queries,
            seed=cfg.seed,
        )

    def _consider(self, stage: str, window: Optional[TrainWindow]) -> StageDecision:
        cfg = self.config
        # training consumes the watermark whatever happens next — a window
        # that fails to train or gate should not retry every step until
        # traffic doubles it, just fold into the next trigger cycle
        self._seen[stage] = self.store.total_ingested
        if window is None:
            return StageDecision(
                stage,
                "too_few_queries",
                reason=(
                    f"window below min_queries={cfg.min_queries} or too few "
                    f"positive-bearing queries for a held-out gate"
                ),
            )
        # one stage snapshot anchors the whole train -> gate -> activate
        # pass: the re-ranker trains on the representation this snapshot
        # serves (the live adapter's output), the gate judges against it,
        # and the CAS activation refuses if it moved mid-training
        sv, current = self.router.stage_set()
        try:
            trained = self.trainers[stage].train(window, current)
        except ValueError as exc:
            return StageDecision(stage, "train_failed", reason=str(exc))
        # gate on the exact serving composition: candidate = live StageSet
        # with this one stage replaced, judged on the held-out slice
        candidate = trained.apply_to(current, device=self.device)
        val_q = window.query_emb[window.val_idx]
        val_tokens = window.tokens(window.val_idx)
        val_rel = window.pos_mask[window.val_idx]
        mult = getattr(self.router, "candidate_multiplier", 5)
        ndcg_cur = stage_ndcg(
            window.table, val_q, val_tokens, val_rel, current, cfg.k, mult, self.device
        )
        ndcg_new = stage_ndcg(
            window.table, val_q, val_tokens, val_rel, candidate, cfg.k, mult, self.device
        )
        decision = StageDecision(
            stage, "", ndcg_current=ndcg_cur, ndcg_candidate=ndcg_new
        )
        if not ndcg_new > ndcg_cur + cfg.min_gain:
            decision.action = "gate_rejected"
            decision.reason = (
                f"held-out NDCG@{cfg.k} {ndcg_new:.3f} did not beat the live "
                f"config's {ndcg_cur:.3f} (+{cfg.min_gain})"
            )
            if self.bus is not None:
                self.bus.publish("gate_reject", plane="learn", stage=stage,
                                 reason=decision.reason)
            return decision
        if self.db.table_version != window.table_version:
            # the gate judged this candidate against the window's table
            # snapshot; a refinement swap landed mid-training, so that
            # evidence is stale on the live table — stand down and fold
            # into the next cycle (a swap slipping in after this check is
            # the narrow residual race the StageGuard exists to catch)
            decision.action = "table_moved"
            decision.reason = (
                f"table moved v{window.table_version} -> "
                f"v{self.db.table_version} mid-training; gate evidence is "
                f"stale"
            )
            return decision
        artifact = self.registry.register(
            stage,
            trained.params,
            table_version=window.table_version,
            fingerprint=window.fingerprint,
            metrics={
                "ndcg_current": ndcg_cur,
                "ndcg_candidate": ndcg_new,
                "n_train_queries": float(len(window.train_idx)),
                "n_val_queries": float(len(window.val_idx)),
                **trained.info,
            },
            aux=trained.aux,
        )
        decision.artifact_version = artifact.version
        try:
            # compare-and-swap: this candidate was gated against stage
            # version `sv`; if another promotion landed mid-training, stand
            # down rather than clobber a set the gate never saw
            new_sv = self.router.set_stages(
                trained.apply_to(current, artifact_version=artifact.version,
                                 device=self.device),
                expect_version=sv,
            )
        except ConflictError as exc:
            # the artifact never deployed: drop it so it cannot shadow the
            # artifact that won the race as `latest`
            self.registry.discard(stage, artifact.version)
            decision.action = "activation_conflict"
            decision.reason = str(exc)
            return decision
        if self.guard is not None:
            self.guard.note_promotion(sv, new_sv)
        decision.action = "promoted"
        decision.stage_version = new_sv
        decision.reason = (
            f"stage v{sv} -> v{new_sv} (held-out NDCG@{cfg.k} "
            f"{ndcg_cur:.3f} -> {ndcg_new:.3f}, artifact "
            f"{stage}/v{artifact.version})"
        )
        if self.bus is not None:
            self.bus.publish("promotion", plane="learn", stage=stage,
                             from_version=sv, to_version=new_sv,
                             artifact_version=artifact.version)
        return decision

    # ---------------------------------------------------------------- daemon
    def start(self, interval_s: float = 1.0) -> None:
        """Run `step()` on a daemon thread every `interval_s` seconds.

        A failing step is recorded in `self.reports` (reason
        "step failed: ...") AND in `self.last_loop_error` (cleared by the
        next successful step) so a health check can see the failure without
        scanning reports; the loop continues — a transient trainer or
        encoder error must not silently kill the learning plane for the
        rest of the serving process's lifetime."""
        assert self._thread is None, "learning controller already running"
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.step()
                    if self.last_loop_error is not None and self.bus is not None:
                        # transition back to healthy, not one event per step
                        self.bus.publish("loop_recovered", plane="learn",
                                         controller=type(self).__name__)
                    self.last_loop_error = None
                except Exception as exc:  # survive transient failures
                    if self.last_loop_error is None:
                        # crash dump FIRST (reason "crash", full exception),
                        # so the loop_error publish below debounces into it
                        # rather than racing it for the dump slot
                        if self.flight_recorder is not None:
                            try:
                                self.flight_recorder.record_crash(
                                    exc, source=type(self).__name__
                                )
                            except Exception:  # noqa: BLE001 — never rethrow
                                pass  # the black box must not kill the loop
                        if self.bus is not None:
                            self.bus.publish("loop_error", plane="learn",
                                             controller=type(self).__name__,
                                             error=repr(exc))
                    self.last_loop_error = exc
                    self.reports.append(
                        LearnReport(plan=None, reason=f"step failed: {exc!r}")
                    )

        self._thread = threading.Thread(
            target=loop, name="learning-controller", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
