"""StageGuard: post-promotion shadow monitoring + automatic demotion.

Counterpart of `repro/learn/guard.py`, a copy with only its imports
changed.

The learning plane's promotion gate protects a StageSet *before* activation
on a held-out slice of the outcome window; this guard protects it *after*,
on live labelled traffic — the same division of labor `TableGuard` gives
table swaps, against the same blind spots (window-vs-traffic distribution
shift, a stage activated out-of-band that bypassed the gate).

Serving code reports each labelled result via
`observe(result.stage_version, result.tools, relevant)`; the guard keeps a
rolling NDCG@k window per stage version, freezes the predecessor's rolling
NDCG as each promoted version's baseline (`note_promotion`, or lazily for
unannounced out-of-band `set_stages` calls), and `check()` demotes a
version regressing past `tolerance` after `min_samples` labels via
`SemanticRouter.rollback_stages(expect_current=...)` — compare-and-swap, so
a promotion that lands after judgement can never be condemned on evidence
it did not generate. The restored StageSet comes back under a new version
with no baseline (it *is* the baseline), so demotion cannot cascade into
flapping — the invariants are `TableGuard`'s, applied to the stage axis.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterable, List, Optional

from repro_torch.metrics.retrieval import ndcg_at_k
from repro_torch.obs.quality import RollingWindows
from repro_torch.router.tooldb import ConflictError

__all__ = ["StageGuardConfig", "StageGuardReport", "StageGuard"]


@dataclasses.dataclass(frozen=True)
class StageGuardConfig:
    k: int = 5  # NDCG@k cutoff
    window: int = 256  # rolling observations kept per stage version
    min_samples: int = 32  # judge a version only after this many labels
    tolerance: float = 0.02  # allowed NDCG drop vs the frozen baseline


@dataclasses.dataclass
class StageGuardReport:
    # "healthy" | "insufficient_data" | "no_baseline" | "stale" |
    # "regressed_unrestorable" | "demoted"
    action: str
    stage_version: int  # version under judgement when check() ran
    ndcg: Optional[float] = None
    baseline: Optional[float] = None
    n_samples: int = 0
    restored_version: Optional[int] = None  # new version after a demotion


class StageGuard:
    """Rolling per-stage-version quality monitor over labelled traffic."""

    def __init__(
        self,
        router,
        config: StageGuardConfig = StageGuardConfig(),
        bus: Optional["EventBus"] = None,  # repro_torch.obs.events
    ):
        self.router = router
        self.config = config
        # per-version rolling windows (repro_torch.obs.quality's shared machinery,
        # accessed only under self._lock — RollingWindows is not locked)
        self._ndcg = RollingWindows(config.window)
        self._baseline: Dict[int, Optional[float]] = {}
        self._last_version = router.stage_version
        self._lock = threading.Lock()
        self.demotions: List[StageGuardReport] = []
        self.bus = bus

    # ------------------------------------------------------------- observing
    def observe(
        self,
        stage_version: int,
        ranked_tools: Iterable[int],
        relevant: Iterable[int],
    ) -> None:
        """Record one labelled result against the stage set that served it
        (`RouteResult.stage_version` — NOT `router.stage_version`, which may
        have moved since the batch was scored)."""
        nd = ndcg_at_k(list(ranked_tools), list(relevant), self.config.k)
        with self._lock:
            self._ndcg.push(stage_version, nd)

    def note_promotion(self, old_version: int, new_version: int) -> None:
        """Freeze the outgoing stage set's rolling NDCG as the promoted
        set's baseline (the LearningController calls this right after a
        CAS activation). A predecessor without enough samples yields no
        baseline — the guard then has nothing to judge the promotion by."""
        with self._lock:
            self._baseline[new_version] = (
                self._ndcg.mean(old_version)
                if self._ndcg.n(old_version) >= self.config.min_samples
                else None
            )
            self._last_version = new_version

    def version_stats(self, stage_version: int) -> dict:
        with self._lock:
            return {
                "n": self._ndcg.n(stage_version),
                "ndcg": self._ndcg.mean(stage_version),
                "baseline": self._baseline.get(stage_version),
            }

    # -------------------------------------------------------------- judging
    def check(self) -> StageGuardReport:
        """Judge the live stage set; demote if it regressed past tolerance."""
        with self._lock:
            version = self.router.stage_version
            if version != self._last_version and version not in self._baseline:
                # unannounced promotion (out-of-band set_stages that bypassed
                # the controller): freeze the displaced version's rolling
                # NDCG as its baseline, like TableGuard does for tables
                self._baseline[version] = (
                    self._ndcg.mean(self._last_version)
                    if self._ndcg.n(self._last_version) >= self.config.min_samples
                    else None
                )
            self._last_version = version
            # prune dead versions (neither live nor a demotion target):
            # a long-running daemon under promotion churn must not grow
            # these windows forever
            alive = set(self.router.retained_stage_versions())
            alive.add(version)
            self._ndcg.prune(alive)
            for v in [v for v in self._baseline if v not in alive]:
                del self._baseline[v]
            n = self._ndcg.n(version)
            if n < self.config.min_samples:
                return StageGuardReport("insufficient_data", version, n_samples=n)
            ndcg = self._ndcg.mean(version)
            baseline = self._baseline.get(version)
            if baseline is None:
                return StageGuardReport("no_baseline", version, ndcg=ndcg, n_samples=n)
            if ndcg + self.config.tolerance >= baseline:
                return StageGuardReport(
                    "healthy", version, ndcg=ndcg, baseline=baseline, n_samples=n
                )
            if not self.router.retained_stage_versions():
                return StageGuardReport(
                    "regressed_unrestorable", version,
                    ndcg=ndcg, baseline=baseline, n_samples=n,
                )
        # demotion runs OUTSIDE the guard lock: rollback_stages takes the
        # router's stage lock, and restored stage sets may touch device state
        # on their next application — holding _lock across that would stall
        # every observe() and nest the guard lock around router internals.
        # The compare-and-swap keeps the judgement safe after the release:
        # a promotion landing in the gap makes expect_current refuse.
        try:
            restored = self.router.rollback_stages(expect_current=version)
        except ConflictError:
            # the condemned stage set is no longer live; judge the new
            # one on its own evidence next check
            return StageGuardReport("stale", version, ndcg=ndcg, n_samples=n)
        with self._lock:
            # the restored set IS the new baseline: no judgement, no flap
            self._baseline[restored] = None
            self._last_version = restored
            report = StageGuardReport(
                "demoted",
                version,
                ndcg=ndcg,
                baseline=baseline,
                n_samples=n,
                restored_version=restored,
            )
            self.demotions.append(report)
        if self.bus is not None:  # outside the lock, like the demotion itself
            self.bus.publish(
                "demotion", plane="learn",
                condemned_version=version, restored_version=restored,
                ndcg=ndcg, baseline=baseline,
            )
        return report
