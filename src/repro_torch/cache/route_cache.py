"""SemanticRouteCache: embedding-space near-duplicate cache for route results.

Production gateway traffic is Zipfian — most requests are near-duplicates of
a small hot set — yet every `route_batch` call pays the full score+top-K
(+re-rank) path. This cache serves a previously-computed routing decision
when a new query lands close enough (cosine) to a cached one, skipping the
index backend and the Stage-2 MLP entirely for the hit subset of a batch.

Keying: multi-table LSH over the query embedding's sign bits. Each of
`n_tables` independent tables projects the unit-normalized query onto its
own `n_bits` random hyperplanes (seeded, lazily sized to the embedding
dim); the packed sign pattern is that table's bucket key. A single table
is useless for *near*-duplicates — a cosine-0.95 paraphrase flips any one
sign bit with probability acos(0.95)/pi ~ 0.10, so at 16 bits it lands in
a sibling bucket ~80% of the time. With L tables of b bits the miss
probability is (1 - (1 - theta/pi)^b)^L: the defaults (8 x 12) catch
~93% of cosine-0.95 pairs for eight dict probes per query. Bucket
collisions between genuinely different queries are harmless because a hit
additionally requires cosine similarity to the *stored* query above
``threshold`` — the keys only decide where to look, the cosine check
decides whether to trust.

Staleness is exact, not heuristic. Every entry is stamped with the
``(table_version, stage_version)`` pair its routing decision was computed
under, and `lookup_batch` requires the stamp to equal the live pair the
gateway read at batch entry. Both version counters are monotone (a rollback
is itself a version bump — see `ToolsDatabase.rollback` /
`SemanticRouter.rollback_stages`), so an entry stamped under a superseded
snapshot can never become servable again; stamp-dead entries found during
lookup are reclaimed on the spot. A bus subscription (`watch`) additionally
purges dead entries *eagerly* on every ``swap``/``stage_swap`` event and
publishes ``cache_invalidated`` — that wiring reclaims capacity and feeds
telemetry, but exactness never depends on event delivery.

Concurrency discipline: one lock guards the entry map. Everything under it
is dict traffic plus a 384-float `np.dot` — plain numpy, never device
dispatch (the `cache-version-stamp` analyzer rule enforces this lexically),
so a lookup can never stall a concurrent batch behind device work. Key
computation (the one per-batch allocation on the miss path) happens outside
the lock. Capacity is bounded with LRU eviction: hits refresh recency,
inserts evict the coldest bucket first.

Counterpart of `repro/cache/route_cache.py`, copied with only its imports changed (it
imports no JAX).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry, get_registry

__all__ = ["CacheConfig", "CachedRoute", "SemanticRouteCache"]


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Knobs, in the order they matter (guidance: package docstring)."""

    threshold: float = 0.95  # min cosine(stored query, new query) for a hit
    min_gap: float = 0.0  # min stored top-1/top-2 margin to serve a hit
    n_bits: int = 12  # hyperplanes per LSH table -> 2^n_bits buckets each
    n_tables: int = 8  # independent LSH tables probed per query
    capacity: int = 65536  # max retained key slots (LRU beyond this); one
    # entry occupies n_tables slots, so distinct cached decisions are
    # bounded by ~capacity / n_tables
    seed: int = 0  # hyperplane RNG seed (deterministic keys per seed)

    def __post_init__(self):
        # threshold > 1 is the supported "never hit" setting for measuring
        # pure cache overhead
        assert 0.0 < self.threshold, self.threshold
        assert 1 <= self.n_bits <= 48, self.n_bits  # packed into one int64
        assert 1 <= self.n_tables <= 64, self.n_tables
        assert self.capacity >= self.n_tables, self.capacity


@dataclasses.dataclass(frozen=True)
class CachedRoute:
    """One cached routing decision + the snapshot stamps it was made under."""

    query: np.ndarray  # unit-norm embedding of the query that was scored
    tools: Tuple[int, ...]
    scores: Tuple[float, ...]
    table_version: int
    stage_version: int
    # top-1/top-2 margin of the stored decision (inf when < 2 candidates):
    # a unit-norm perturbation ||q - q'|| can only flip the top-1 when the
    # gap is < 2*||q - q'||, so low-gap decisions are the ones a paraphrase
    # legitimately re-routes — CacheConfig.min_gap refuses to serve them
    gap: float = float("inf")


class _CacheInstruments:
    """Preresolved metric handles (catalog: `repro_torch.obs` docstring)."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.hits = registry.counter("route_cache_hits_total")
        self.misses = registry.counter("route_cache_misses_total")
        self.evictions = registry.counter("route_cache_evictions_total")
        self.invalidated = registry.counter("route_cache_invalidated_total")
        self.hit_ratio = registry.gauge("route_cache_hit_ratio")
        self.size = registry.gauge("route_cache_size")


class SemanticRouteCache:
    def __init__(
        self,
        config: Optional[CacheConfig] = None,
        metrics: Union[MetricsRegistry, bool, None] = None,
        bus: Optional["EventBus"] = None,  # repro_torch.obs.events
    ):
        self.config = config or CacheConfig()
        self._entries: "OrderedDict[int, CachedRoute]" = OrderedDict()
        self._lock = threading.Lock()
        # hyperplanes sized lazily to the first batch's embedding dim; the
        # init is deterministic in (seed, dim), so a benign double-init race
        # produces identical planes
        self._planes: Optional[np.ndarray] = None
        # per-table bit weights plus a table tag in the high bits, so all
        # n_tables keys live in one dict under disjoint namespaces
        b, L = self.config.n_bits, self.config.n_tables
        self._pows = (1 << np.arange(b, dtype=np.int64))
        self._table_tag = (np.arange(L, dtype=np.int64) << np.int64(b))
        self.stats = {
            "hits": 0,
            "misses": 0,
            "evictions": 0,
            "invalidated": 0,  # version-dead entries purged (eager or lazy)
        }
        if metrics is False:
            self._obs: Optional[_CacheInstruments] = None
        else:
            registry = metrics if isinstance(metrics, MetricsRegistry) else get_registry()
            self._obs = _CacheInstruments(registry)
        self._bus = bus

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # ------------------------------------------------------------------ keys
    def _keys(self, q: np.ndarray) -> np.ndarray:
        """[Q, n_tables] packed LSH sign-bit bucket keys for a query block.

        Pure numpy, computed outside the cache lock — this array is the only
        allocation a miss pays beyond the dict probes.
        """
        b, L = self.config.n_bits, self.config.n_tables
        planes = self._planes
        if planes is None or planes.shape[0] != q.shape[1]:
            rng = np.random.default_rng(self.config.seed)
            planes = rng.standard_normal((q.shape[1], L * b)).astype(np.float32)
            self._planes = planes
        signs = (q @ planes) > 0.0  # [Q, L*b]
        bits = signs.reshape(len(q), L, b).astype(np.int64) @ self._pows  # [Q, L]
        return bits | self._table_tag

    # ---------------------------------------------------------------- serving
    def lookup_batch(
        self,
        q: np.ndarray,
        *,
        table_version: int,
        stage_version: int,
    ) -> List[Optional[CachedRoute]]:
        """Probe the cache for a [Q, D] query block; None per miss.

        A hit requires all three: same bucket key, entry stamped with
        exactly the live ``(table_version, stage_version)`` the caller read
        at batch entry, and cosine(stored query, new query) >= threshold.
        Entries whose stamps are dead (either version moved) are purged on
        sight — monotone version counters mean they can never serve again.
        """
        q = np.asarray(q, dtype=np.float32)
        keys = self._keys(q)  # [Q, n_tables]
        out: List[Optional[CachedRoute]] = [None] * len(keys)
        thr = self.config.threshold
        min_gap = self.config.min_gap
        hits = misses = purged = 0
        with self._lock:
            entries = self._entries
            for j, qkeys in enumerate(keys):
                for key in qkeys:
                    k = int(key)
                    e = entries.get(k)
                    if e is None:
                        continue
                    if (
                        e.table_version != table_version
                        or e.stage_version != stage_version
                    ):
                        del entries[k]  # dead lineage: reclaim the slot
                        purged += 1
                        continue
                    if e.gap < min_gap:
                        continue  # near-tie decision: paraphrases can
                        # legitimately flip it, so score it fresh
                    # numpy scalar dot only — never device work under
                    # this lock (cache-version-stamp analyzer rule)
                    if float(e.query @ q[j]) < thr:
                        continue  # bucket collision or too-far paraphrase
                    entries.move_to_end(k)  # LRU: a hit refreshes recency
                    out[j] = e
                    hits += 1
                    break
                else:
                    misses += 1
            self.stats["hits"] += hits
            self.stats["misses"] += misses
            self.stats["invalidated"] += purged
            total_hits, total_misses = self.stats["hits"], self.stats["misses"]
            size = len(entries)
        obs = self._obs
        if obs is not None:  # telemetry outside the lock
            if hits:
                obs.hits.inc(hits)
            if misses:
                obs.misses.inc(misses)
            if purged:
                obs.invalidated.inc(purged)
            looked = total_hits + total_misses
            if looked:
                obs.hit_ratio.set(total_hits / looked)
            obs.size.set(size)
        return out

    def insert_batch(
        self,
        q: np.ndarray,
        tools: Sequence[Sequence[int]],
        scores: Sequence[Sequence[float]],
        *,
        table_version: int,
        stage_version: int,
    ) -> None:
        """Insert freshly-scored routing decisions for a [Q, D] query block.

        `q` must be the same (raw, pre-adapter) embeddings lookups probe
        with. Each decision is ONE shared CachedRoute registered under its
        key in every LSH table; a same-bucket insert overwrites (last write
        wins), and the coldest key slots are evicted past capacity (a
        partially-evicted entry stays servable through its other tables).
        """
        q = np.asarray(q, dtype=np.float32)
        keys = self._keys(q)  # [Q, n_tables]
        capacity = self.config.capacity
        evicted = 0
        with self._lock:
            entries = self._entries
            for j, qkeys in enumerate(keys):
                ss = tuple(float(s) for s in scores[j])
                e = CachedRoute(
                    query=q[j].copy(),
                    tools=tuple(int(t) for t in tools[j]),
                    scores=ss,
                    table_version=int(table_version),
                    stage_version=int(stage_version),
                    gap=(ss[0] - ss[1]) if len(ss) >= 2 else float("inf"),
                )
                for key in qkeys:
                    k = int(key)
                    entries[k] = e
                    entries.move_to_end(k)
            while len(entries) > capacity:
                entries.popitem(last=False)
                evicted += 1
            self.stats["evictions"] += evicted
            size = len(entries)
        obs = self._obs
        if obs is not None:
            if evicted:
                obs.evictions.inc(evicted)
            obs.size.set(size)

    # ----------------------------------------------------------- invalidation
    def invalidate(
        self,
        table_version: Optional[int] = None,
        stage_version: Optional[int] = None,
        reason: str = "swap",
    ) -> int:
        """Purge entries whose stamp differs from the given live version(s).

        Called by the `watch` bus subscription on every ``swap`` /
        ``stage_swap`` event (and usable directly by launchers that wire no
        bus). Returns the number of entries purged; publishes one
        ``cache_invalidated`` event when anything was.
        """
        with self._lock:
            dead = [
                k
                for k, e in self._entries.items()
                if (table_version is not None and e.table_version != table_version)
                or (stage_version is not None and e.stage_version != stage_version)
            ]
            for k in dead:
                del self._entries[k]
            self.stats["invalidated"] += len(dead)
            size = len(self._entries)
        purged = len(dead)
        obs = self._obs
        if obs is not None:
            if purged:
                obs.invalidated.inc(purged)
            obs.size.set(size)
        if self._bus is not None and purged:
            self._bus.publish(
                "cache_invalidated",
                plane="serve",
                reason=reason,
                table_version=table_version,
                stage_version=stage_version,
                purged=purged,
            )
        return purged

    def watch(self, bus: "EventBus") -> Callable[[], None]:
        """Purge eagerly on every ``swap``/``stage_swap`` bus event.

        Exactness never depends on this — `lookup_batch`'s stamp check is
        the authority — but eager purging reclaims capacity the moment a
        deployment lands and surfaces the ``cache_invalidated`` event +
        counters the runbook watches. Returns a detach handle (idempotent),
        mirroring `EventBus.watch_db`.
        """
        if self._bus is None:
            self._bus = bus

        def on_event(event) -> None:
            if event.kind == "swap":
                self.invalidate(
                    table_version=event.details.get("version"), reason="swap"
                )
            elif event.kind == "stage_swap":
                self.invalidate(
                    stage_version=event.details.get("version"),
                    reason="stage_swap",
                )

        bus.subscribe(on_event)
        return lambda: bus.unsubscribe(on_event)

    # ---------------------------------------------------------------- reading
    def hit_rate(self) -> float:
        """Lifetime hit fraction over all lookups (0.0 before any)."""
        with self._lock:
            hits, misses = self.stats["hits"], self.stats["misses"]
        total = hits + misses
        return hits / total if total else 0.0

    def clear(self) -> int:
        """Drop every entry (returns how many); counters are untouched."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
        if self._obs is not None:
            self._obs.size.set(0)
        return n
