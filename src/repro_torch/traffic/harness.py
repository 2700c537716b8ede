"""Stream replay harness: drive `route_batch`, time it, gate staleness.

The staleness gate is the harness's reason to exist beyond timing: every
result's served `(table_version, stage_version)` must lie inside the live
version window read immediately around the `route_batch` call. Both
counters are monotone (swap/rollback/promotion/demotion are all version
bumps — see `ToolsDatabase` / `SemanticRouter.set_stages`), so
[versions-at-entry, versions-at-exit] is an exact bound on what any
correct path — cached or not — may serve, even while control-plane churn
lands concurrently mid-stream. A violation means a cache served a decision
from a dead snapshot; `chip_smoke.py`'s cache leg fails on the first
one.

Counterpart of `repro/traffic/harness.py`, copied with only its imports changed (it
imports no JAX).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.obs import clock

__all__ = ["TrafficReport", "agreement", "drive"]


@dataclasses.dataclass
class TrafficReport:
    batches: int
    queries: int
    route_s: float  # wall time inside route_batch only (generation excluded)
    qps: float
    p50_ms: float  # per-batch route_batch latency percentiles
    p99_ms: float
    hit_rate: float  # fraction of results served from the route cache
    stale_serves: int  # results outside the live version window (MUST be 0)
    stale_examples: List[dict]  # first few violations, for the artifact
    results: Optional[List[List["RouteResult"]]] = None  # kept when record=True


def drive(
    router,
    batches: Sequence[List[np.ndarray]],
    record: bool = False,
    on_batch: Optional[Callable[[int], None]] = None,
) -> TrafficReport:
    """Replay pre-materialized arrival batches through `route_batch`.

    Batches are materialized by the caller (`list(gen.stream(n))`) so the
    generator's cost never pollutes the timing, and so the same list can be
    replayed against a second router. `on_batch(i)` runs between batches —
    the hook cache_bench uses to fire control-plane swaps mid-stream.
    `record=True` retains every RouteResult for `agreement` comparison.
    """
    lat_ms: List[float] = []
    kept: List[List] = []
    n_queries = n_hits = stale = 0
    stale_examples: List[dict] = []
    route_s = 0.0
    for i, batch in enumerate(batches):
        if on_batch is not None:
            on_batch(i)
        # live version window around the call: monotone counters make
        # [entry, exit] an exact staleness bound (module docstring)
        tv0, sv0 = router.db.table_version, router.stage_version
        t0 = clock.perf()
        results = router.route_batch(batch)
        route_s += clock.perf() - t0
        tv1, sv1 = router.db.table_version, router.stage_version
        lat_ms.append((clock.perf() - t0) * 1e3)
        for r in results:
            n_queries += 1
            n_hits += bool(r.cache_hit)
            if not (tv0 <= r.table_version <= tv1 and sv0 <= r.stage_version <= sv1):
                stale += 1
                if len(stale_examples) < 8:
                    stale_examples.append({
                        "batch": i,
                        "served": [r.table_version, r.stage_version],
                        "window": [[tv0, sv0], [tv1, sv1]],
                        "cache_hit": r.cache_hit,
                    })
        if record:
            kept.append(results)
    lat = np.asarray(lat_ms) if lat_ms else np.zeros(1)
    return TrafficReport(
        batches=len(lat_ms),
        queries=n_queries,
        route_s=route_s,
        qps=n_queries / route_s if route_s > 0 else 0.0,
        p50_ms=float(np.percentile(lat, 50)),
        p99_ms=float(np.percentile(lat, 99)),
        hit_rate=n_hits / n_queries if n_queries else 0.0,
        stale_serves=stale,
        stale_examples=stale_examples,
        results=kept if record else None,
    )


def agreement(a: List[List], b: List[List]) -> float:
    """Top-1 routing agreement between two replays of the same stream.

    The routing decision that matters downstream is which tool a request is
    dispatched to — the top-1 — so agreement is the fraction of queries
    whose top-1 tool matches (empty results agree only with empty).
    """
    total = same = 0
    for batch_a, batch_b in zip(a, b):
        assert len(batch_a) == len(batch_b), "streams differ in shape"
        for ra, rb in zip(batch_a, batch_b):
            total += 1
            ta = ra.tools[0] if ra.tools else None
            tb = rb.tools[0] if rb.tools else None
            same += ta == tb
    return same / total if total else 1.0
