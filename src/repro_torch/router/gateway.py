"""SemanticRouter: the serving-plane gateway (paper Fig. 1b / Fig. 2 top).

Counterpart of `repro/router/gateway.py`, with the same contract. Per
batch: embed the queries (host), pad the miss block to a power-of-two
bucket, apply the optional query-side adapter, score and top-K against one
atomic table snapshot through `ToolIndexManager` (the dense backend, or
the fused Hopper kernel or IVF, with the exact fallback on a stale index or a
masked batch), optionally re-rank with the [7,64,32,1] MLP, drop the
`NEG_INF` sentinel slots, and stamp every result with
`(table_version, stage_version)`.

Device work runs on the router's `device` (`None` means the CUDA card and
raises without one). Each phase crosses the host/device boundary once, as
the JAX reference's numpy boundaries do: adapter, index, re-ranker.

Outcome handoff: `record_outcome` either pushes each `OutcomeEvent` straight
into an external sink (`outcome_sink=`) or appends to a bounded,
lock-guarded ring that `drain_outcomes()` hands to the refinement job
(`outcomes_dropped` counts overwrites).

Learned stages live in one immutable `StageSet` behind a version counter:
`route_batch` reads ONE stage snapshot at entry, so an in-flight batch
finishes on the stages it started with; `set_stages` is compare-and-swap
(ConflictError on a lost race), superseded sets are retained in a bounded
history, and `rollback_stages` restores one.

Telemetry and reuse hooks, as in the reference: `cache=` a
`repro_torch.cache.SemanticRouteCache` probed after embed (host numpy keys;
hit rows skip the adapter, the index and the re-ranker; every served entry's
version stamps re-checked against the live pair), `tracer=` a
`repro_torch.obs.trace.RouteTracer` (sampled per-batch spans), `bus=` a
`repro_torch.obs.events.EventBus` (stage swaps, outcome drops, and the owned
index manager's rebuilds) and `quality=` a
`repro_torch.obs.quality.QualityMonitor` fed the raw [Q, D] numpy query block
for label-free drift. While a `repro_torch.obs.trace.recording()` is open,
each batch also records a `route.batch` span and its phases' spans, from
the same stamps the `route_phase_ms` histograms read.

`hot_path_jits()` names what `route_batch` dispatches to, as the
reference's does: there the jitted programs, here the `topk_sim` kernel's
probe (its library and the routes launched so far; see
`kernels/topk_sim/kernel.py`) beside the eager adapter and re-ranker,
which compile nothing.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict, deque
from typing import Callable, Deque, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.common.bucketing import pad_amount
from repro_torch.core import reranker as reranker_lib
from repro_torch.core.features import OutcomeFeaturizer
from repro_torch.core.retrieval import NEG_INF
from repro_torch.index import ToolIndexManager
from repro_torch.obs import clock
from repro_torch.obs import trace as spans_lib
from repro_torch.obs.metrics import MetricsRegistry, get_registry
from repro_torch.router.stages import StageSet
from repro_torch.router.tooldb import ConflictError, ToolsDatabase

__all__ = [
    "RouteResult",
    "OutcomeEvent",
    "SemanticRouter",
    "StageSet",
    "hot_path_jits",
]

PHASES = ("embed", "cache", "adapter", "score", "rerank", "assemble")


def hot_path_jits() -> "OrderedDict[str, Callable]":
    """What `route_batch` dispatches to, by name: the port's counterpart of
    the reference's jitted entry points, read by `obs.profile.JitProfiler`.

    The port compiles nothing with XLA. What it does build and load is the
    `topk_sim` kernel library, and CUDA loads a route's kernels at the
    route's first launch, so its entry is the kernel's probe, whose
    `_cache_size()` is the library loaded (0 or 1) plus the routes launched
    at least once: a load or a route that appears after warmup is the port's
    production retrace. The adapter and the re-ranker are eager torch with
    no compiled program and no such probe; the profiler lists them as
    unsupported.
    """
    from repro_torch.core import adapter as adapter_lib
    from repro_torch.kernels.topk_sim import kernel as topk_kernel

    return OrderedDict(
        (
            ("topk_sim", topk_kernel.PROBE),
            ("adapter_apply", adapter_lib.adapter_apply),
            ("rerank_topk_scored", reranker_lib.rerank_topk_scored),
        )
    )


class _GatewayInstruments:
    """The gateway's metric handles, resolved once at construction.

    Instrument lookup is a dict hit in MetricsRegistry but still costs a
    lock; the hot path must touch preresolved objects only. Catalog:
    the `repro.obs` package docstring."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.requests = registry.counter("route_requests_total")
        self.batches = registry.counter("route_batches_total")
        self.batch_ms = registry.histogram("route_batch_ms")
        self.batch_size = registry.histogram("route_batch_size")
        self.phase = {
            name: registry.histogram("route_phase_ms", phase=name)
            for name in PHASES
        }
        self.table_version = registry.gauge("route_table_version")
        self.stage_version = registry.gauge("route_stage_version")
        self.outcomes_dropped = registry.counter("route_outcomes_dropped_total")
        # top-1/top-2 score gap per query (routing confidence; a collapsing
        # gap means the router is guessing) — recorded via record_many, one
        # vectorized pass per batch, so per-query cost stays O(1/batch)
        self.score_gap = registry.histogram("route_score_gap")
        # tripwire: cache entries whose version stamps failed the gateway's
        # independent re-check against the live pair. Such entries are
        # demoted to misses (never served), so any non-zero value means a
        # cache bug was caught — the cache_staleness SLO holds this at 0.
        self.cache_stale = registry.counter("route_cache_stale_served_total")


@dataclasses.dataclass
class RouteResult:
    tools: List[int]  # selected tool ids (top-K)
    scores: List[float]  # the scores the final ranking was computed from
    latency_ms: float  # per-query share of the (possibly batched) route call
    pool: str  # backend pool the request was dispatched to
    table_version: int
    # version of the StageSet snapshot that scored this batch: together with
    # table_version it fully determines the scores (the learning plane's
    # StageGuard keys its shadow windows on it)
    stage_version: int = 0
    # True when this result was served from the SemanticRouteCache (its
    # tools/scores were computed by an earlier batch under the SAME
    # (table_version, stage_version) pair reported above)
    cache_hit: bool = False


@dataclasses.dataclass
class OutcomeEvent:
    """A logged outcome tuple (q_j, t_i, o_j) (§4.1 step 1)."""

    query_tokens: np.ndarray
    tool_id: int
    outcome: int  # {0, 1}
    timestamp: float


class SemanticRouter:
    def __init__(
        self,
        db: ToolsDatabase,
        embed_fn: Callable[[np.ndarray], np.ndarray],  # tokens -> [384]
        k: int = 5,
        mlp_params: Optional[dict] = None,
        featurizer: Optional[OutcomeFeaturizer] = None,
        candidate_multiplier: int = 5,
        pool_selector: Optional[Callable[[np.ndarray, List[int]], str]] = None,
        embed_batch_fn: Optional[Callable[[Sequence[np.ndarray]], np.ndarray]] = None,
        outcome_capacity: int = 65_536,
        outcome_sink: Optional[Callable[["OutcomeEvent"], None]] = None,
        index: Optional[ToolIndexManager] = None,
        backend: str = "dense",
        backend_opts: Optional[dict] = None,
        stages: Optional[StageSet] = None,
        stage_history_limit: int = 4,
        metrics: Union[MetricsRegistry, bool, None] = None,
        tracer: Optional["RouteTracer"] = None,  # repro_torch.obs.trace
        bus: Optional["EventBus"] = None,  # repro_torch.obs.events
        quality: Optional["QualityMonitor"] = None,  # repro_torch.obs.quality
        cache: Optional["SemanticRouteCache"] = None,  # repro_torch.cache
        device: Union[str, torch.device, None] = None,
    ):
        self.db = db
        self.embed_fn = embed_fn
        self.k = k
        # learned stages live in one immutable snapshot behind a version
        # counter (the table discipline applied to the adapter/re-ranker):
        # constructor args mlp_params/featurizer seed the initial set for
        # backwards compatibility with pre-learning-plane callers
        assert stage_history_limit >= 1
        if stages is None:
            stages = StageSet(mlp_params=mlp_params, featurizer=featurizer)
        else:
            assert mlp_params is None and featurizer is None, (
                "pass learned stages either via stages= or via "
                "mlp_params=/featurizer=, not both"
            )
        self._stages = stages
        self._stage_version = 0
        self._stage_history: "OrderedDict[int, StageSet]" = OrderedDict()
        self._stage_history_limit = int(stage_history_limit)
        self._stage_lock = threading.Lock()
        self.candidate_multiplier = candidate_multiplier
        self.pool_selector = pool_selector or (lambda q, tools: "default")
        # batched encoder (one call for Q queries); falls back to looping
        # embed_fn so any single-query encoder still works batch-first
        self.embed_batch_fn = embed_batch_fn
        # bounded ring: record under lock, drain under the same lock — the
        # discipline ToolsDatabase uses for its table (a lock-free list drops
        # events when a drain races batched serving). `outcome_sink` bypasses
        # the ring entirely: events go straight to the control-plane store.
        self.outcome_log: Deque[OutcomeEvent] = deque()
        assert outcome_capacity >= 1, "outcome_capacity must be >= 1"
        self.outcome_capacity = int(outcome_capacity)
        self.outcomes_dropped = 0
        self.outcome_sink = outcome_sink
        self._outcome_lock = threading.Lock()
        # the scoring layer: a shared ToolIndexManager, or one owned by this
        # router built from (backend, backend_opts) on this router's device
        self._owns_index = index is None
        # an owned manager inherits this router's bus at construction so its
        # very first build publishes rebuild events; a shared manager keeps
        # whatever bus its creator wired
        self.index = index if index is not None else ToolIndexManager(
            db, backend=backend, backend_opts=backend_opts, bus=bus, device=device
        )
        self.device = self.index.device
        # telemetry: metrics default ON against the process registry;
        # `metrics=False` is the truly bare hot path. Instruments are
        # resolved once here so `route_batch` never takes the registry
        # lock.
        if metrics is False:
            self._obs: Optional[_GatewayInstruments] = None
        else:
            registry = metrics if isinstance(metrics, MetricsRegistry) else get_registry()
            self._obs = _GatewayInstruments(registry)
        self._tracer = tracer
        self._gap_tick = 0  # score-gap 1-in-4 batch sampling counter
        self._bus = bus
        # streaming quality observability (obs.quality): route_batch
        # feeds it raw query embeddings for label-free drift detection
        self._quality = quality
        # near-duplicate route cache: probed after embed
        # (keys are embedding-space), so a hit skips the index backend and
        # the Stage-2 re-ranker for its row. Wire `cache.watch(bus)` at the
        # launcher for eager invalidation on swap/stage_swap events.
        self._cache = cache

    @property
    def cache(self):
        """The attached SemanticRouteCache, if any (read-only view for
        health surfaces and launch summaries)."""
        return self._cache

    def close(self) -> None:
        """Tear down a retiring router (idempotent).

        Unregisters the router-owned index manager from the database's swap
        listeners — without this, a discarded router over a long-lived
        ToolsDatabase keeps rebuilding its index (and pinning its table
        copies) on every future swap. A shared manager passed via `index=`
        is left alone: its lifecycle belongs to the caller.
        """
        if self._owns_index:
            self.index.close()

    # --------------------------------------------------------- learned stages
    @property
    def mlp_params(self) -> Optional[dict]:
        """Live re-ranker params (read-only view of the current StageSet)."""
        return self._stages.mlp_params

    @property
    def featurizer(self) -> Optional[OutcomeFeaturizer]:
        return self._stages.featurizer

    @property
    def stage_version(self) -> int:
        return self._stage_version

    def stage_set(self) -> Tuple[int, StageSet]:
        """(version, StageSet) read atomically w.r.t. promotions — the
        stage-side analogue of `ToolsDatabase.snapshot()`."""
        with self._stage_lock:
            return self._stage_version, self._stages

    def set_stages(
        self, stages: StageSet, expect_version: Optional[int] = None
    ) -> int:
        """Atomically deploy a new StageSet (returns the new version).

        The outgoing set is retained as a demotion target (bounded history,
        oldest evicted first). `expect_version` makes activation
        compare-and-swap: a promotion gated against stage version N is
        refused (ConflictError) if another deployment landed past N while it
        was being trained — mirroring `swap_table(expect_current=...)`.
        """
        with self._stage_lock:
            if expect_version is not None and self._stage_version != expect_version:
                raise ConflictError(
                    f"stages are v{self._stage_version}, not v{expect_version} "
                    f"the promotion was gated against; refusing activation"
                )
            self._stage_history[self._stage_version] = self._stages
            while len(self._stage_history) > self._stage_history_limit:
                self._stage_history.popitem(last=False)
            self._stages = stages
            self._stage_version += 1
            version = self._stage_version
        # publish outside the stage lock: subscribers must never be able to
        # stall a promotion racing the serving path's stage_set() read
        if self._bus is not None:
            self._bus.publish("stage_swap", plane="learn", version=version)
        return version

    def retained_stage_versions(self) -> List[int]:
        """Stage versions available as demotion targets, oldest first."""
        with self._stage_lock:
            return list(self._stage_history.keys())

    def rollback_stages(
        self,
        to_version: Optional[int] = None,
        expect_current: Optional[int] = None,
    ) -> int:
        """Instant demotion to a retained StageSet (returns the new version).

        Same semantics as `ToolsDatabase.rollback`: the restore is itself a
        version bump, the condemned set is not retained, retained sets newer
        than the target are dropped, and `expect_current` refuses
        (ConflictError) when another promotion landed after the caller
        judged `expect_current` — the StageGuard's safety hinge.
        """
        with self._stage_lock:
            if expect_current is not None and self._stage_version != expect_current:
                raise ConflictError(
                    f"stages are v{self._stage_version}, not the judged "
                    f"v{expect_current}; refusing demotion"
                )
            if not self._stage_history:
                raise RuntimeError("no previous stage set to roll back to")
            if to_version is None:
                to_version = next(reversed(self._stage_history))
            if to_version not in self._stage_history:
                raise RuntimeError(
                    f"stage version {to_version} not retained "
                    f"(available: {list(self._stage_history.keys())})"
                )
            stages = self._stage_history.pop(to_version)
            for v in [v for v in self._stage_history if v > to_version]:
                del self._stage_history[v]
            self._stages = stages
            self._stage_version += 1
            version = self._stage_version
        if self._bus is not None:
            self._bus.publish(
                "stage_swap", plane="learn", version=version,
                restored_version=to_version,
            )
        return version

    # ---------------------------------------------------------- serving path
    def _embed_batch(self, queries: Sequence[np.ndarray]) -> np.ndarray:
        if self.embed_batch_fn is not None:
            return np.asarray(self.embed_batch_fn(queries), dtype=np.float32)
        return np.stack([np.asarray(self.embed_fn(q), np.float32) for q in queries])

    def route_batch(
        self,
        queries: Sequence[np.ndarray],
        candidate_masks: Optional[np.ndarray] = None,  # [Q, T] {0,1} or None
    ) -> List[RouteResult]:
        """Route Q queries in one batched scoring pass.

        One batched index call (the configured `ScorerBackend`; exact dense
        by default) scores the whole [Q, D] query block against the
        [T, D] table (with optional per-query candidate masks); when the
        Stage-2 MLP is configured, featurization and `rerank_topk_scored`
        also run over the full batch. Returns one RouteResult per query, in
        input order; each carries the per-query amortized latency. A
        candidate mask admitting fewer than k tools yields a correspondingly
        shorter tools/scores list (never masked-out ids).
        """
        t0 = clock.perf()
        n_q = len(queries)
        if n_q == 0:
            return []
        # ONE stage snapshot per batch: a promotion/demotion landing mid-call
        # cannot mix stage configurations within the batch, and the reported
        # stage_version is the set that actually produced the scores
        stage_version, stages = self.stage_set()
        obs = self._obs
        tracing = self._tracer is not None and self._tracer.sample()
        timed = tracing or obs is not None or spans_lib.recording_on()
        q = self._embed_batch(queries)  # [Q, D]
        t_embed = clock.perf() if timed else 0.0
        # cache probe: keys are embedding-space, so it runs
        # after embed and before everything a hit row gets to skip (index
        # backend + Stage-2 re-ranker). Masked batches bypass the cache
        # entirely — a cached decision computed without a mask must never
        # answer a masked request. Lookups are judged against the live pair
        # (db.table_version is the documented racy int read; every served
        # entry's stamps are re-verified below) and probe with raw
        # pre-adapter embeddings, so the stage_version stamp covers adapter
        # promotions too.
        cache = self._cache
        use_cache = cache is not None and candidate_masks is None
        if use_cache:
            tv_live = self.db.table_version
            cached = cache.lookup_batch(
                q, table_version=tv_live, stage_version=stage_version
            )
            # tripwire, independent of the cache's own stamp check: any
            # entry whose versions differ from the live pair is demoted to
            # a miss (never served) and counted —
            # route_cache_stale_served_total must stay 0
            stale = 0
            for j, e in enumerate(cached):
                if e is not None and (
                    e.table_version != tv_live
                    or e.stage_version != stage_version
                ):
                    cached[j] = None
                    stale += 1
            if stale and obs is not None:
                obs.cache_stale.inc(stale)
            miss_idx = [j for j, e in enumerate(cached) if e is None]
        else:
            cached = []
            miss_idx = list(range(n_q))
        t_cache = clock.perf() if timed else 0.0
        n_miss = len(miss_idx)
        # swap_table asserts the table shape is invariant, so the tool count
        # is stable across versions and safe to read without a snapshot
        n_t = len(self.db)
        rerank = stages.has_reranker
        c = min(self.k * self.candidate_multiplier, n_t) if rerank else min(self.k, n_t)
        k_eff = min(self.k, c)  # tables smaller than k yield short results
        if n_miss:
            # the scoring path sees only the miss rows: a mostly-hit batch
            # pays the index backend and re-ranker for its misses alone
            if n_miss == n_q:
                q_miss, queries_miss, masks_miss = q, queries, candidate_masks
            else:
                q_miss = q[miss_idx]
                queries_miss = [queries[j] for j in miss_idx]
                masks_miss = None  # masked batches never reach this branch
            # pad the miss block up to a power-of-two bucket, as the
            # reference does (there, so its jitted programs compile once
            # per bucket; here, so both packages score identical blocks).
            # Pad rows are zero queries whose results are sliced away
            # below.
            n_pad = pad_amount(n_miss)
            if n_pad:
                q_in = np.concatenate(
                    [q_miss, np.zeros((n_pad, q.shape[1]), np.float32)]
                )
                queries_in = list(queries_miss) + [np.zeros(0, np.int64)] * n_pad
                masks_in = None if masks_miss is None else np.concatenate(
                    [masks_miss, np.ones((n_pad, n_t), masks_miss.dtype)]
                )
            else:
                q_in, queries_in, masks_in = q_miss, queries_miss, masks_miss
            # adapter head (query-side only) runs BEFORE the index backend —
            # the tool table is untouched, so any built index stays valid
            # across adapter promotions — and on the PADDED block, like the
            # scoring path. pool_selector below keeps
            # seeing the raw encoder embedding `q`: pool affinity must not
            # flip on stage promotions/demotions.
            q_in = stages.adapt_queries(q_in)
            t_adapter = clock.perf() if timed else 0.0
            # the index layer scores the batch against an atomic
            # (version, table) snapshot — the reported table_version and
            # the scores come from the SAME table even if swap_table lands
            # mid-batch, whichever backend (or the exact mid-rebuild
            # fallback) served it
            cand_scores_np, cand_idx_np, table_version = self.index.topk(
                q_in, c, masks_in
            )
            t_score = clock.perf() if timed else 0.0
            if rerank:
                feats = stages.featurizer.features(q_in, queries_in, cand_idx_np, cand_scores_np)
                dev = stages.mlp_params["w0"].device
                top_idx, top_scores = reranker_lib.rerank_topk_scored(
                    stages.mlp_params,
                    torch.from_numpy(feats).to(dev),
                    torch.from_numpy(np.ascontiguousarray(cand_idx_np)).to(dev),
                    k_eff,
                    valid=torch.from_numpy(cand_scores_np > NEG_INF / 2).to(dev),
                )
                top_idx, top_scores = top_idx.cpu().numpy(), top_scores.cpu().numpy()
            else:
                top_idx, top_scores = cand_idx_np[:, :k_eff], cand_scores_np[:, :k_eff]
            top_idx = np.asarray(top_idx)[:n_miss]
            top_scores = np.asarray(top_scores)[:n_miss]
        else:
            # every row hit: the adapter, index backend, and re-ranker are
            # all skipped, and the batch reports the live pair the hits
            # were verified against
            t_adapter = t_score = t_cache
            table_version = tv_live
            top_idx = np.zeros((0, k_eff), np.int64)
            top_scores = np.zeros((0, k_eff), np.float32)
        t_rank = clock.perf()
        latency_ms = (t_rank - t0) * 1e3 / n_q
        # a mask can leave fewer than k candidates; those slots carry the
        # NEG_INF sentinel and must not surface as selected tools
        miss_tools: List[List[int]] = []
        miss_scores: List[List[float]] = []
        for m in range(n_miss):
            valid_m = top_scores[m] > NEG_INF / 2
            miss_tools.append([int(t) for t in top_idx[m][valid_m]])
            miss_scores.append([float(s) for s in top_scores[m][valid_m]])
        if use_cache and n_miss:
            # fresh decisions enter the cache stamped with the versions
            # that actually produced them: the topk snapshot's
            # table_version plus the batch's stage snapshot — NOT tv_live,
            # which a mid-batch swap may already have left behind
            cache.insert_batch(
                q_miss, miss_tools, miss_scores,
                table_version=table_version, stage_version=stage_version,
            )
        out = []
        m = 0
        for j in range(n_q):
            e = cached[j] if use_cache else None
            if e is not None:
                tools, scores = list(e.tools), list(e.scores)
                tv_j, hit = e.table_version, True
            else:
                tools, scores = miss_tools[m], miss_scores[m]
                tv_j, hit = table_version, False
                m += 1
            out.append(
                RouteResult(
                    tools=tools,
                    scores=scores,
                    latency_ms=latency_ms,
                    pool=self.pool_selector(q[j], tools),
                    table_version=tv_j,
                    stage_version=stage_version,
                    cache_hit=hit,
                )
            )
        if timed:
            t_done = clock.perf()
            # spans exist only for work that actually ran: the cache span
            # only when a cache is attached, adapter/score only when misses
            # reached the index, the rerank span only when the Stage-2 MLP
            # actually ran — recording ~0 ms slice-only "reranks" (or
            # all-hit "scores") would poison the p50
            stamps = [("embed", t0, t_embed)]
            if use_cache:
                stamps.append(("cache", t_embed, t_cache))
            if n_miss:
                stamps.append(("adapter", t_cache, t_adapter))
                stamps.append(("score", t_adapter, t_score))
                if rerank:
                    stamps.append(("rerank", t_score, t_rank))
            stamps.append(("assemble", t_rank, t_done))
            spans = [(name, (b - a) * 1e3) for name, a, b in stamps]
            total_ms = (t_done - t0) * 1e3
            if spans_lib.recording_on():
                spans_lib.record("route.batch", t0, t_done,
                                 [("route." + name, a, b) for name, a, b in stamps],
                                 queries=n_q)
            # trace BEFORE metrics: a sampled batch's trace id becomes the
            # exemplar on the duration buckets it lands in, so a p99 reading
            # links straight to a concrete RouteTrace
            trace = None
            if tracing:
                trace = self._tracer.record(
                    batch_size=n_q,
                    # the bucket is the padded MISS block the scoring path
                    # saw (an all-hit batch never reached
                    # them and reports bucket 0 under path "cache")
                    bucket=(n_miss + n_pad) if n_miss else 0,
                    path="cache" if not n_miss else self.index.last_path(),
                    table_version=table_version,
                    stage_version=stage_version,
                    spans=spans,
                    total_ms=total_ms,
                )
            if obs is not None:
                exemplar = trace.trace_id if trace is not None else None
                obs.requests.inc(n_q)
                obs.batches.inc()
                obs.batch_size.record(float(n_q))
                obs.batch_ms.record(total_ms, exemplar=exemplar)
                phase = obs.phase
                for name, ms in spans:
                    phase[name].record(ms, exemplar=exemplar)
                obs.table_version.set(table_version)
                obs.stage_version.set(stage_version)
                if top_scores.shape[1] >= 2:
                    # sampled 1-in-4 batches: the gap histogram feeds
                    # percentile summaries (confidence()), which a quarter
                    # of the traffic estimates as well as all of it — and
                    # this is the priciest per-batch obs block (a vectorized
                    # pass + record_many). Racy tick increment is fine: the
                    # sampling needs to be approximate, not exact.
                    self._gap_tick += 1
                    if self._gap_tick % 4 == 0:
                        # rows with < 2 valid candidates carry the NEG_INF
                        # sentinel in slot 1 and are skipped
                        valid2 = top_scores[:, 1] > NEG_INF / 2
                        if np.any(valid2):
                            gaps = top_scores[:, 0] - top_scores[:, 1]
                            obs.score_gap.record_many(gaps[valid2])
        if self._quality is not None:
            # raw pre-adapter embeddings, unpadded rows: drift is about the
            # query population vs the live table, not about learned stages
            self._quality.observe_queries(q)
        return out

    def route(
        self,
        query_tokens: np.ndarray,
        candidate_mask: Optional[np.ndarray] = None,  # [T] {0,1} or None
    ) -> RouteResult:
        """Single-query routing: the batch-of-1 case of `route_batch`."""
        masks = None if candidate_mask is None else np.asarray(candidate_mask)[None]
        return self.route_batch([query_tokens], masks)[0]

    # ------------------------------------------------------------ feedback
    def record_outcome(self, query_tokens: np.ndarray, tool_id: int, outcome: int):
        event = OutcomeEvent(
            query_tokens=query_tokens,
            tool_id=tool_id,
            outcome=int(outcome),
            timestamp=clock.wall(),
        )
        if self.outcome_sink is not None:
            self.outcome_sink(event)
            return
        n_dropped = 0
        with self._outcome_lock:
            if len(self.outcome_log) >= self.outcome_capacity:
                self.outcome_log.popleft()
                self.outcomes_dropped += 1
                n_dropped = self.outcomes_dropped
            self.outcome_log.append(event)
        if n_dropped:
            # counter + bus outside the ring lock: telemetry must not extend
            # the record/drain critical section
            if self._obs is not None:
                self._obs.outcomes_dropped.inc()
            if self._bus is not None and n_dropped == 1:
                self._bus.publish("outcomes_dropping", plane="serve",
                                  dropped=n_dropped)

    def drain_outcomes(self) -> List[OutcomeEvent]:
        """Hand the accumulated log to the offline refinement job."""
        with self._outcome_lock:
            log = list(self.outcome_log)
            self.outcome_log.clear()
        return log
