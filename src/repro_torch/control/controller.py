"""RefinementController: the loop that closes §7.2 against the live router.

Counterpart of `repro/control/controller.py`, with the same contract. The
refinement runs on the controller's `device` (`None` means the first
router's device, else the CUDA card): the table and the window's numpy
arrays go up as tensors, and the accepted table comes back to the host for
`swap_table`.

One `step()` = one pass of the paper's operational loop:

    drain routers -> guard check -> trigger? -> density gate ->
    build masks from the event window -> refine_with_gate on a held-out
    validation slice -> accepted? atomic swap_table -> register with guard

Step-driven so tests (and cron-style deployments) control the cadence
exactly; `start(interval_s)` wraps the same `step()` in a daemon thread for
serving processes that want the loop in-process beside the gateway. Serving
traffic continues throughout: `swap_table` is atomic w.r.t.
`ToolsDatabase.snapshot()`, so in-flight `route_batch` calls finish on the
table they started with and the next batch picks up the new version.

Triggering is `core.deployment.refine_trigger` (event-count OR staleness).
Each triggered step also computes `core.deployment.recommend_stages` over
the store's live per-tool counters and records the plan on its report:
refinement itself is always-on in that policy (zero serving cost,
gate-protected, §7.2), while the plan's density thresholds gate training of
the learned stages (rerank/adapter) — acted on by the learning plane
(`repro_torch.learn.LearningController`). This controller itself never
trains serving-path models mid-flight.

The validation slice is a deterministic per-refinement split of the *unique
queries* in the window (not of raw events: a query's K outcome events must
land on one side of the split, or the gate validates on its own train set).

Index layer: every swap/rollback this loop performs invalidates a
`repro_torch.index.ToolIndexManager`'s built index. The managers' own
`ToolsDatabase` swap listeners rebuild it the moment the table moves
(inline on the thread that swapped, or on a background thread for IVF);
the controller additionally refreshes any managers passed via `indexes=`
at the end of each step and records `ControllerReport.index_fresh`.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.deployment import DeploymentPlan, recommend_stages, refine_trigger
from repro_torch.core.refine import RefineConfig, refine_with_gate
from repro_torch.control.guard import GuardReport, TableGuard
from repro_torch.control.outcome_store import OutcomeStore
from repro_torch.obs import clock as obs_clock
from repro_torch.router.tooldb import ConflictError, ToolsDatabase

__all__ = ["ControllerConfig", "ControllerReport", "RefinementController"]


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    min_events: int = 256  # event-count trigger (refine_trigger)
    max_interval_s: float = 300.0  # staleness trigger (refine_trigger)
    val_fraction: float = 0.15  # held-out slice of unique queries
    min_queries: int = 20  # don't refine off a handful of queries
    # keep_history=False: the controller re-refines the same large table over
    # and over; the [N+1, T, D] convergence buffer is pure overhead here.
    # gate_metric="ndcg": with streamed-outcome relevance every logged
    # positive was in the serving top-K by construction, so Recall@K starts
    # at its 1.0 ceiling and could only tie or reject; NDCG still measures
    # rank improvement within the top-K.
    refine: RefineConfig = RefineConfig(keep_history=False, gate_metric="ndcg")
    seed: int = 0


@dataclasses.dataclass
class ControllerReport:
    """What one `step()` did, for logs/tests/benchmarks."""

    triggered: bool
    reason: str
    n_events: int = 0  # events in the store window at step time
    n_new_events: int = 0  # ingested since the last refinement
    n_queries: int = 0  # unique queries folded into the masks
    plan: Optional[DeploymentPlan] = None
    accepted: Optional[bool] = None
    recall_before: Optional[float] = None
    recall_after: Optional[float] = None
    swapped: bool = False
    table_version: int = -1  # live version when the step finished
    guard: Optional[GuardReport] = None
    # index-layer freshness at step end (None when no managers attached):
    # False means a swap/rollback this step left at least one ToolIndexManager
    # rebuilding, i.e. its router is serving the exact dense fallback
    index_fresh: Optional[bool] = None


class RefinementController:
    def __init__(
        self,
        db: ToolsDatabase,
        store: OutcomeStore,
        embed_batch_fn: Callable[[Sequence[np.ndarray]], np.ndarray],
        routers: Sequence = (),
        config: ControllerConfig = ControllerConfig(),
        guard: Optional[TableGuard] = None,
        clock: Callable[[], float] = obs_clock.monotonic,
        refine_fn: Callable = refine_with_gate,  # injectable for tests
        indexes: Sequence = (),  # ToolIndexManagers to keep fresh across swaps
        bus: Optional["EventBus"] = None,  # repro_torch.obs.events lifecycle surface
        flight_recorder=None,  # duck-typed `record_crash(exc, source=)` hook
        device: Union[str, torch.device, None] = None,
    ):
        self.db = db
        self.store = store
        self.embed_batch_fn = embed_batch_fn
        self.routers = list(routers)
        # where refine_with_gate runs: the serving card unless asked
        if device is None and self.routers:
            device = self.routers[0].device
        self.device = resolve_device(device)
        self.config = config
        self.guard = guard
        # rebuild-on-swap: managers already watch the db through their swap
        # listener; the controller's job is (a) belt-and-braces refresh after
        # its own swaps/rollbacks and (b) reporting fallback-serving windows
        self.indexes = list(indexes)
        self.clock = clock
        self.refine_fn = refine_fn
        # lifecycle events (cooldown, gate_reject, loop_error transitions) go
        # to the bus; successful swaps reach it via `EventBus.watch_db`
        self.bus = bus
        # black-box hook: a daemon-step crash dumps the full telemetry state
        # (works without a bus; the recorder's debounce dedupes against the
        # loop_error event when both paths are wired)
        self.flight_recorder = flight_recorder
        self.reports: List[ControllerReport] = []
        # the daemon loop's health surface: the most recent step() exception,
        # cleared by the next successful step — a dashboard/health check polls
        # this (a failing control plane is otherwise invisible: the thread
        # survives and reports are easy to miss)
        self.last_loop_error: Optional[BaseException] = None
        self.n_refinements = 0
        self._seen_events = store.total_ingested  # trigger watermark
        self._last_refine_t = clock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------------ step
    def step(self) -> ControllerReport:
        for router in self.routers:
            self.store.drain_router(router)
        guard_report = self.guard.check() if self.guard is not None else None
        if guard_report is not None and guard_report.action == "rolled_back":
            # cooldown: the window is dominated by outcomes the condemned
            # table generated — refining from it (now or at the next
            # trigger) would rebuild and re-swap essentially the same bad
            # table in a flap loop. Purge the window and consume the
            # trigger watermark: refinement restarts from fresh evidence
            # served by the restored table.
            n_purged = self.store.clear()
            self._seen_events = self.store.total_ingested
            self._last_refine_t = self.clock()
            report = ControllerReport(
                triggered=False,
                reason=(
                    f"cooldown after guard rollback "
                    f"({n_purged} condemned-era events purged)"
                ),
            )
            if self.bus is not None:
                self.bus.publish("cooldown", plane="control", purged=n_purged)
        else:
            report = self._refine_step()
        report.guard = guard_report
        report.table_version = self.db.table_version
        if self.indexes:
            for manager in self.indexes:
                # honor each manager's build mode: a synchronous manager
                # (a cheap backend, or async_rebuild=False) must be fresh
                # when the step returns; async managers get a no-op poke
                # when already fresh/building
                manager.refresh(block=not getattr(manager, "async_rebuild", True))
            report.index_fresh = all(m.is_fresh() for m in self.indexes)
        self.reports.append(report)
        return report

    def _refine_step(self) -> ControllerReport:
        cfg = self.config
        n_new = self.store.total_ingested - self._seen_events
        elapsed = self.clock() - self._last_refine_t
        if not refine_trigger(n_new, elapsed, cfg.min_events, cfg.max_interval_s):
            return ControllerReport(
                triggered=False,
                reason=f"below trigger ({n_new} new events, {elapsed:.1f}s elapsed)",
                n_events=len(self.store),
                n_new_events=n_new,
            )
        batch = self.store.build_refinement_batch(self.embed_batch_fn)
        # triggering consumes the watermark whatever happens next — a window
        # too sparse to refine should not re-trigger every step until traffic
        # doubles it, just fold into the next trigger cycle
        self._seen_events = self.store.total_ingested
        self._last_refine_t = self.clock()
        pos_counts, neg_counts = self.store.tool_counts()
        n_examples = int(pos_counts.sum() + neg_counts.sum())
        # §7.2/§7.3 stage plan over the live counters. Refinement itself is
        # always-on in that policy (zero serving cost, gate-protected), so
        # the plan doesn't veto this step; it is recorded on the report, and
        # the same policy gates learned-stage training in the learning plane
        # (the learning plane reads these thresholds over the same counters).
        plan = recommend_stages(len(self.db), n_examples)
        base = ControllerReport(
            triggered=True,
            reason="",
            n_events=batch.n_events,
            n_new_events=n_new,
            n_queries=batch.n_queries,
            plan=plan,
        )
        if batch.n_queries < cfg.min_queries:
            base.reason = (
                f"too few unique queries ({batch.n_queries} < {cfg.min_queries})"
            )
            return base
        # deterministic held-out slice, reseeded per refinement so repeated
        # runs on an evolving window rotate the slice. The val slice is
        # drawn ONLY from queries with >= 1 logged success: all-zero
        # relevance rows are excluded from batched_recall_at_k, so a val
        # slice of failure-only queries would make the gate vacuous
        # (0 >= 0 accepts with zero validation signal)
        pos_rows = np.flatnonzero(batch.pos_mask.sum(axis=1) > 0)
        n_val = max(int(round(cfg.val_fraction * len(pos_rows))), 2)
        if len(pos_rows) < 2 * n_val:
            base.reason = (
                f"too few positive queries for a held-out gate "
                f"({len(pos_rows)} with successes, need >= {2 * n_val})"
            )
            return base
        rng = np.random.default_rng(cfg.seed + self.n_refinements)
        val_idx = rng.permutation(pos_rows)[:n_val]
        train_idx = np.setdiff1d(np.arange(batch.n_queries), val_idx)
        version_before, table = self.db.snapshot()

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        result = self.refine_fn(
            up(table),
            up(batch.query_emb[train_idx]),
            up(batch.pos_mask[train_idx]),
            up(batch.query_emb[val_idx]),
            up(batch.pos_mask[val_idx]),
            cfg.refine,
        )
        self.n_refinements += 1
        accepted = bool(result.accepted)
        base.accepted = accepted
        base.recall_before = float(result.recall_before)
        base.recall_after = float(result.recall_after)
        metric = f"{cfg.refine.gate_metric}@{cfg.refine.k}"
        if not accepted:
            base.reason = f"gate rejected: held-out {metric} did not improve"
            if self.bus is not None:
                self.bus.publish("gate_reject", plane="control",
                                 reason=base.reason)
            return base
        try:
            # compare-and-swap: this table was refined FROM version_before;
            # if another deployment landed mid-refinement, stand down rather
            # than clobber a table the gate never saw
            new_version = self.db.swap_table(
                result.embeddings.detach().cpu().numpy(),
                expect_current=version_before,
            )
        except ConflictError as exc:
            base.reason = f"swap refused: {exc}"
            return base
        if self.guard is not None:
            self.guard.note_swap(version_before, new_version)
        base.swapped = True
        base.reason = (
            f"swapped v{version_before} -> v{new_version} "
            f"(val {metric} {base.recall_before:.3f} -> "
            f"{base.recall_after:.3f})"
        )
        return base

    # ---------------------------------------------------------------- daemon
    def start(self, interval_s: float = 1.0) -> None:
        """Run `step()` on a daemon thread every `interval_s` seconds.

        A failing step is recorded in `self.reports` (reason
        "step failed: ...") AND in `self.last_loop_error` (cleared by the
        next successful step) so a health check can see the failure without
        scanning reports; the loop continues — a transient encoder or
        refinement error must not silently kill the control plane for the
        rest of the serving process's lifetime.
        """
        assert self._thread is None, "controller already running"
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.step()
                    if self.last_loop_error is not None and self.bus is not None:
                        # transition back to healthy, not one event per step
                        self.bus.publish("loop_recovered", plane="control",
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
                            self.bus.publish("loop_error", plane="control",
                                             controller=type(self).__name__,
                                             error=repr(exc))
                    self.last_loop_error = exc
                    self.reports.append(
                        ControllerReport(
                            triggered=False,
                            reason=f"step failed: {exc!r}",
                            table_version=self.db.table_version,
                        )
                    )

        self._thread = threading.Thread(
            target=loop, name="refinement-controller", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
