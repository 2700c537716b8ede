"""Streaming quality observability: rolling retrieval quality, confidence,
and query-embedding drift — the *leading* indicators for the guards.

`TableGuard`/`StageGuard` judge versions on labelled traffic and act
(rollback/demotion); that is the enforcement arm, and labels arrive
minutes-to-hours after serving (§4.1). This module is the observation arm,
and it adds one signal the guards cannot have: **label-free drift**. A bad
table swap or a query-population shift moves the geometry between queries
and the live table *immediately*, long before enough labels accumulate for
the guard's `min_samples` judgement — so a `quality_drift` event fires
while the guard is still collecting evidence.

Three signals:

* rolling NDCG@k / Recall@k over labelled traffic (`observe`), published
  as ``quality_ndcg`` / ``quality_recall`` gauges — the same rolling
  machinery the guards use, extracted here as `RollingWindows` so all
  three stay numerically identical;
* routing confidence: the gateway records per-query top-1/top-2 score gaps
  into the ``route_score_gap`` histogram; `confidence()` summarizes it (a
  collapsing gap means the router is guessing between tools);
* query-embedding drift: `observe_queries` keeps an EWMA of the per-dim
  query mean and compares it against the live table's per-dim population
  stats (`set_reference`, refreshed on every swap via `watch_db`); the RMS
  z-score is the ``quality_drift_score`` gauge, and crossing
  ``drift_threshold`` publishes a rising-edge ``quality_drift`` event.

Telemetry discipline: `observe_queries` is called from `route_batch` but
does O(batch * dim) numpy work outside any router lock, and the whole
monitor is optional — a gateway without one pays a single None check.

Counterpart of `repro/obs/quality.py`, copied with only its imports changed (it
imports no JAX).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Callable, Deque, Dict, Iterable, List, Optional

import numpy as np

__all__ = ["QualityConfig", "QualityMonitor", "RollingWindows"]


class RollingWindows:
    """Per-key bounded rolling windows of floats (the guards' machinery).

    A plain data structure, NOT thread-safe by itself: every user
    (`TableGuard`, `StageGuard`, `QualityMonitor`) already serializes its
    observation path under its own lock, and layering a second lock here
    would only add nesting the lock-order checker must then prove safe.
    """

    def __init__(self, maxlen: int):
        assert maxlen >= 1
        self.maxlen = int(maxlen)
        self._windows: Dict[object, Deque[float]] = {}

    def push(self, key, value: float) -> None:
        w = self._windows.get(key)
        if w is None:
            w = self._windows[key] = deque(maxlen=self.maxlen)
        w.append(float(value))

    def n(self, key) -> int:
        w = self._windows.get(key)
        return len(w) if w is not None else 0

    def mean(self, key) -> Optional[float]:
        w = self._windows.get(key)
        return float(np.mean(w)) if w else None

    def values(self, key) -> List[float]:
        return list(self._windows.get(key, ()))

    def keys(self) -> List[object]:
        return list(self._windows)

    def prune(self, keep: Iterable[object]) -> None:
        """Drop every window whose key is not in `keep` (dead versions)."""
        alive = set(keep)
        for k in [k for k in self._windows if k not in alive]:
            del self._windows[k]


@dataclasses.dataclass(frozen=True)
class QualityConfig:
    k: int = 5  # NDCG@k / Recall@k cutoff
    window: int = 256  # rolling labelled observations kept
    drift_ewma: float = 0.1  # per-batch EWMA weight for the query mean
    drift_threshold: float = 0.5  # RMS z-score that counts as drift
    drift_min_batches: int = 5  # judge drift only after this many batches
    # fold only every Nth batch into the drift EWMA (1 = every batch). The
    # EWMA's horizon is tens of folds, so a small stride changes detection
    # latency by a few batches while cutting the per-route_batch cost by
    # ~1/stride — serve.py and obs_bench run stride 4 as the production
    # shape; the default keeps every-batch semantics for tests and guards
    drift_every: int = 1


class QualityMonitor:
    """Streaming quality signals over live traffic (label-free + labelled)."""

    def __init__(
        self,
        config: QualityConfig = QualityConfig(),
        registry: Optional["MetricsRegistry"] = None,  # repro_torch.obs.metrics
        bus: Optional["EventBus"] = None,  # repro_torch.obs.events
    ):
        self.config = config
        self.bus = bus
        self._rolling = RollingWindows(config.window)
        self._lock = threading.Lock()
        # drift state: reference = live table population stats (per-dim);
        # current = EWMA of per-dim query batch means
        self._ref_mean: Optional[np.ndarray] = None
        self._ref_inv_std: Optional[np.ndarray] = None
        self._ref_version: Optional[int] = None
        self._ew_mean: Optional[np.ndarray] = None
        self._z_scratch: Optional[np.ndarray] = None
        self._seen = 0  # all observe_queries calls (drift_every stride base)
        self._last_score: Optional[float] = None
        self._n_batches = 0
        self._drifting = False  # rising-edge latch for quality_drift
        self.drift_events = 0
        self._g_ndcg = self._g_recall = self._g_drift = None
        self._score_gap_hist = None
        if registry is not None:
            k = str(config.k)
            self._g_ndcg = registry.gauge("quality_ndcg", k=k)
            self._g_recall = registry.gauge("quality_recall", k=k)
            self._g_drift = registry.gauge("quality_drift_score")
            self._score_gap_hist = registry.histogram("route_score_gap")

    # ---------------------------------------------------------- labelled path
    def observe(self, ranked_tools: Iterable[int], relevant: Iterable[int]) -> None:
        """Record one labelled result into the rolling NDCG/Recall windows.

        Unlike the guards this is not per-version — it is the *serving
        stream's* quality, whatever versions produced it; the guards keep
        the per-version attribution needed for rollback judgement.
        """
        from repro_torch.metrics.retrieval import ndcg_at_k, recall_at_k

        ranked, rel = list(ranked_tools), list(relevant)
        nd = ndcg_at_k(ranked, rel, self.config.k)
        rc = recall_at_k(ranked, rel, self.config.k)
        with self._lock:
            self._rolling.push("ndcg", nd)
            self._rolling.push("recall", rc)
            nd_mean = self._rolling.mean("ndcg")
            rc_mean = self._rolling.mean("recall")
        if self._g_ndcg is not None:
            self._g_ndcg.set(nd_mean)
            self._g_recall.set(rc_mean)

    # -------------------------------------------------------- label-free path
    def set_reference(self, table: np.ndarray, version: Optional[int] = None) -> None:
        """Freeze per-dim population stats of the live table as the drift
        reference (refreshed on every swap via `watch_db`)."""
        t = np.asarray(table, dtype=np.float64)
        # stats in float64 (one-time), stored float32 with the division
        # pre-inverted: the per-batch z-score is then two float32 vector ops
        mean = t.mean(axis=0).astype(np.float32)
        inv_std = (1.0 / np.maximum(t.std(axis=0), 1e-6)).astype(np.float32)
        with self._lock:
            self._ref_mean, self._ref_inv_std = mean, inv_std
            self._ref_version = version

    def watch_db(self, db) -> "Callable[[], None]":
        """Track `db`'s live table as the drift reference across swaps.

        Sets the reference now and re-freezes it after every swap/rollback
        (listeners fire outside the database lock). Returns a zero-arg
        detach handle, mirroring `EventBus.watch_db`.
        """
        version, table = db.snapshot()
        self.set_reference(table, version=version)

        def _on_swap(new_version: int) -> None:
            v, t = db.snapshot()
            self.set_reference(t, version=v)

        db.add_swap_listener(_on_swap)
        return lambda: db.remove_swap_listener(_on_swap)

    def observe_queries(self, queries: np.ndarray) -> Optional[float]:
        """Fold one batch of raw query embeddings into the drift estimate.

        Returns the current RMS z-score (None until a reference exists).
        Publishes ``quality_drift`` on the rising edge only — the event
        re-arms once the score falls back under the threshold, so a
        persistently drifted population produces one event, not one per
        batch (the EventBus transitions-only discipline).
        """
        stride = self.config.drift_every
        if stride > 1:
            with self._lock:
                self._seen += 1
                if self._seen % stride:
                    return self._last_score
        q = np.asarray(queries)
        if q.ndim == 1:
            q = q[None, :]
        if q.size == 0:
            return None
        # float32 throughout: this runs on every route_batch, and a drift
        # z-score of O(1) magnitude needs no double precision. The column
        # mean runs as a BLAS matvec — several times faster than
        # `q.mean(axis=0)`'s strided reduction on the [Q, D] row-major block
        if q.dtype != np.float32:
            q = q.astype(np.float32)
        batch_mean = np.dot(
            np.full(q.shape[0], 1.0 / q.shape[0], dtype=np.float32), q
        )
        a = np.float32(self.config.drift_ewma)
        fire = False
        with self._lock:
            if self._ew_mean is None:
                self._ew_mean = batch_mean.copy()
                self._z_scratch = np.empty_like(batch_mean)
            else:
                # in-place fold (and scratch reuse below): this runs on every
                # route_batch, and the allocation-free form halves the
                # cache-cold per-batch cost (temporaries dominate, not
                # flops)
                self._ew_mean *= np.float32(1.0) - a
                batch_mean *= a
                self._ew_mean += batch_mean
            self._n_batches += 1
            if self._ref_mean is None:
                return None
            z = self._z_scratch
            if z.shape != self._ref_mean.shape:
                z = self._z_scratch = np.empty_like(self._ref_mean)
            np.subtract(self._ew_mean, self._ref_mean, out=z)
            z *= self._ref_inv_std
            score = float(np.sqrt(np.dot(z, z) / z.shape[0]))
            self._last_score = score
            ref_version = self._ref_version
            if self._n_batches >= self.config.drift_min_batches:
                if score > self.config.drift_threshold and not self._drifting:
                    self._drifting = True
                    self.drift_events += 1
                    fire = True
                elif score <= self.config.drift_threshold:
                    self._drifting = False
        if self._g_drift is not None:
            self._g_drift.set(score)
        if fire and self.bus is not None:  # outside the lock, like the guards
            self.bus.publish(
                "quality_drift", plane="serve",
                score=score, threshold=self.config.drift_threshold,
                table_version=ref_version,
            )
        return score

    # --------------------------------------------------------------- reading
    @property
    def drifting(self) -> bool:
        with self._lock:
            return self._drifting

    def drift_score(self) -> Optional[float]:
        with self._lock:
            if self._ref_mean is None or self._ew_mean is None:
                return None
            z = (self._ew_mean - self._ref_mean) * self._ref_inv_std
            return float(np.sqrt(np.mean(z * z)))

    def confidence(self) -> Optional[dict]:
        """Summary of the gateway's top-1/top-2 score-gap histogram."""
        if self._score_gap_hist is None or self._score_gap_hist.count() == 0:
            return None
        return self._score_gap_hist.summary()

    def summary(self) -> dict:
        with self._lock:
            out = {
                "ndcg": self._rolling.mean("ndcg"),
                "recall": self._rolling.mean("recall"),
                "n_labelled": self._rolling.n("ndcg"),
                "k": self.config.k,
                "drifting": self._drifting,
                "drift_events": self.drift_events,
                "n_batches": self._n_batches,
                "ref_table_version": self._ref_version,
            }
        out["drift_score"] = self.drift_score()
        out["confidence"] = self.confidence()
        return out
