"""TableGuard: post-swap shadow monitoring + automatic rollback.

The validation gate (`refine_with_gate`) protects a swap *before* deployment
on a held-out slice; the guard protects it *after*, on live labelled
traffic, against the failure modes the gate cannot see (distribution shift
between the validation slice and real traffic, a bad table deployed by an
out-of-band job that bypassed the gate). Serving code reports each labelled
result via `observe(...)`; the guard keeps a rolling NDCG@k / Recall@k
window per table version, and `check()` (run by the controller every step,
or callable directly) compares the live version's rolling NDCG against the
baseline frozen from its predecessor at swap time. A regression beyond
`tolerance`, judged only after `min_samples` observations, triggers
`ToolsDatabase.rollback()` to the most recent retained version — the table
that was serving before the condemned swap.

The restored table comes back under a NEW version number (rollback is
itself a swap), with a fresh observation window and no baseline — the
restored table *is* the baseline, so a rollback can never cascade into
flapping.

Counterpart of `repro/control/guard.py`, copied with only its imports changed (it
imports no JAX).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterable, List, Optional

from repro_torch.metrics.retrieval import ndcg_at_k, recall_at_k
from repro_torch.obs.quality import RollingWindows
from repro_torch.router.tooldb import ConflictError, ToolsDatabase

__all__ = ["GuardConfig", "GuardReport", "TableGuard"]


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    k: int = 5  # NDCG@k / Recall@k cutoff
    window: int = 256  # rolling observations kept per table version
    min_samples: int = 32  # judge a version only after this many labels
    tolerance: float = 0.02  # allowed NDCG drop vs the frozen baseline


@dataclasses.dataclass
class GuardReport:
    # "healthy" | "insufficient_data" | "no_baseline" | "stale" |
    # "regressed_unrestorable" | "rolled_back"
    action: str
    table_version: int  # version under judgement when check() ran
    ndcg: Optional[float] = None  # rolling NDCG@k of that version
    baseline: Optional[float] = None  # frozen predecessor NDCG@k
    n_samples: int = 0
    restored_version: Optional[int] = None  # new version after a rollback


class TableGuard:
    """Rolling per-version retrieval quality monitor over labelled traffic."""

    def __init__(
        self,
        db: ToolsDatabase,
        config: GuardConfig = GuardConfig(),
        bus: Optional["EventBus"] = None,  # repro_torch.obs.events
    ):
        self.db = db
        self.config = config
        # per-version rolling windows (repro_torch.obs.quality's shared machinery,
        # accessed only under self._lock — RollingWindows is not locked)
        self._ndcg = RollingWindows(config.window)
        self._recall = RollingWindows(config.window)
        self._baseline: Dict[int, Optional[float]] = {}  # frozen at swap time
        self._last_version = db.table_version
        self._lock = threading.Lock()
        self.rollbacks: List[GuardReport] = []
        self.bus = bus

    # ------------------------------------------------------------- observing
    def observe(
        self,
        table_version: int,
        ranked_tools: Iterable[int],
        relevant: Iterable[int],
    ) -> None:
        """Record one labelled result against the version that served it.

        `ranked_tools` is `RouteResult.tools` (use `RouteResult.table_version`
        — NOT `db.table_version`, which may have moved since the batch was
        scored); `relevant` is the ground-truth tool set once the label
        arrives (§4.1's o_j, minutes-to-hours after serving).
        """
        ranked = list(ranked_tools)
        rel = list(relevant)
        nd = ndcg_at_k(ranked, rel, self.config.k)
        rc = recall_at_k(ranked, rel, self.config.k)
        with self._lock:
            self._ndcg.push(table_version, nd)
            self._recall.push(table_version, rc)

    def note_swap(self, old_version: int, new_version: int) -> None:
        """Freeze the outgoing version's rolling NDCG as the incoming
        version's baseline (the controller calls this right after a swap).
        An old version without enough samples yields no baseline — the guard
        then has nothing to compare against and will not judge the swap."""
        with self._lock:
            self._baseline[new_version] = (
                self._ndcg.mean(old_version)
                if self._ndcg.n(old_version) >= self.config.min_samples
                else None
            )
            self._last_version = new_version

    def version_stats(self, table_version: int) -> dict:
        with self._lock:
            return {
                "n": self._ndcg.n(table_version),
                "ndcg": self._ndcg.mean(table_version),
                "recall": self._recall.mean(table_version),
                "baseline": self._baseline.get(table_version),
            }

    # -------------------------------------------------------------- judging
    def check(self) -> GuardReport:
        """Judge the live table; roll back if it regressed past tolerance."""
        with self._lock:
            version = self.db.table_version
            if version != self._last_version and version not in self._baseline:
                # unannounced swap (an out-of-band job that bypassed the
                # controller — the very case shadow monitoring exists for):
                # freeze the displaced version's rolling NDCG as baseline
                self._baseline[version] = (
                    self._ndcg.mean(self._last_version)
                    if self._ndcg.n(self._last_version) >= self.config.min_samples
                    else None
                )
            self._last_version = version
            # prune dead versions: anything no longer live nor retained can
            # never be judged or restored again, and a long-running daemon
            # under table churn would otherwise grow these windows forever
            alive = set(self.db.retained_versions())
            alive.add(version)
            self._ndcg.prune(alive)
            self._recall.prune(alive)
            for v in [v for v in self._baseline if v not in alive]:
                del self._baseline[v]
            n = self._ndcg.n(version)
            if n < self.config.min_samples:
                return GuardReport("insufficient_data", version, n_samples=n)
            ndcg = self._ndcg.mean(version)
            baseline = self._baseline.get(version)
            if baseline is None:
                return GuardReport("no_baseline", version, ndcg=ndcg, n_samples=n)
            if ndcg + self.config.tolerance >= baseline:
                return GuardReport(
                    "healthy", version, ndcg=ndcg, baseline=baseline, n_samples=n
                )
            if not self.db.retained_versions():
                # regression confirmed but no retained table to restore —
                # a distinct, alertable state (do NOT conflate with the
                # can't-judge "no_baseline" case)
                return GuardReport(
                    "regressed_unrestorable", version,
                    ndcg=ndcg, baseline=baseline, n_samples=n,
                )
        # rollback runs OUTSIDE the guard lock: it is itself a swap, and the
        # database fires swap listeners whose index rebuilds may upload to
        # device — holding _lock across that would stall every observe() for
        # the duration and nests the guard lock around device dispatch. The
        # compare-and-swap below still makes the judgement safe: if anything
        # (another guard thread, a deploy) moved the table after we released
        # the lock, expect_current refuses the rollback.
        try:
            restored = self.db.rollback(expect_current=version)
        except ConflictError:
            # the condemned table is no longer live; judge the new one
            # on its own evidence next check
            return GuardReport("stale", version, ndcg=ndcg, n_samples=n)
        with self._lock:
            # the restored table IS the new baseline: no judgement, no flap
            self._baseline[restored] = None
            self._last_version = restored
            report = GuardReport(
                "rolled_back",
                version,
                ndcg=ndcg,
                baseline=baseline,
                n_samples=n,
                restored_version=restored,
            )
            self.rollbacks.append(report)
        if self.bus is not None:  # outside the lock, like the rollback itself
            self.bus.publish(
                "rollback", plane="control",
                condemned_version=version, restored_version=restored,
                ndcg=ndcg, baseline=baseline,
            )
        return report
