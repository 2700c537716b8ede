"""Serving-plane route cache: near-duplicate reuse with exact invalidation.

`SemanticRouteCache` sits between `SemanticRouter.route_batch`'s embed step
and the index backend: queries whose embeddings land within ``threshold``
cosine of a cached one are served the cached top-K (tools + scores) without
touching `ToolIndexManager.topk` or the Stage-2 re-ranker. On Zipfian
near-duplicate traffic this converts the dominant score+re-rank cost into a
dict probe plus one 384-float dot product.

Choosing a config:

``threshold`` — the correctness knob. A hit is served only when
    cosine(stored query, new query) >= threshold; everything else about the
    cache (LSH tables, LRU) only affects *where* it looks, never *whether*
    a far query can be served. 0.95 (default) keeps routing agreement with
    the uncached path >= 0.98 on paraphrase-jittered streams
    (the JAX package's BENCH_cache.json); raise toward 0.99 for registries with many
    near-synonym tools, lower toward 0.9 only when the tool corpus is
    coarse and hit-rate matters more than tail agreement. ``threshold=2.0``
    is the supported "never hit" setting used to measure pure cache
    overhead.

``min_gap`` — conservative serving guard: a hit is additionally required
    to have had a stored top-1 minus top-2 score gap >= min_gap, since a
    near-duplicate can only flip the top-1 decision when the stored gap is
    small relative to the query perturbation. Default 0.0 (off) — on the
    benched Zipf streams it cost hit-rate without buying agreement — but
    raise it (~0.05) for registries where serving a flipped top-1 is much
    worse than a cache miss.

``n_bits`` / ``n_tables`` — the recall/collision tradeoff of the LSH
    keys. A near-duplicate at angle theta flips each sign bit with
    probability theta/pi, so one table of many bits misses most
    paraphrases; the defaults (8 tables x 12 bits, eight dict probes per
    query) catch ~93% of cosine-0.95 pairs. More bits per table = fewer
    cross-intent collisions (hot intents overwriting each other); more
    tables = higher near-duplicate recall at proportionally more probes
    and key slots per entry.

``capacity`` — bound on retained key slots; beyond it the
    least-recently-used slot is evicted. One decision occupies n_tables
    slots (the entry itself is shared), so the default 65536 holds ~8k
    distinct decisions at ~2 KB each (dim=384, K=5) — ~16 MB.

``seed`` — hyperplane RNG seed. Keys are deterministic per (seed, dim), so
    replayed traffic buckets identically across runs.

Invalidation is exact, never TTL-based: entries are stamped with the
``(table_version, stage_version)`` under which their scores were computed,
lookups require the stamp to equal the live pair, and version counters are
monotone — so a control-plane swap or rollback can never leave a servable
stale entry, even if no event is delivered. Wire `cache.watch(bus)` next to
`EventBus.watch_db(db)` to also purge eagerly on ``swap``/``stage_swap``
and emit the ``cache_invalidated`` event + counters the ROADMAP runbook
watches.

Pass the cache to `SemanticRouter(..., cache=...)` — the gateway probes it
after embedding (keys are embedding-space), scores only the miss subset,
inserts fresh results, and re-checks every served entry's stamps against
the live snapshot (`route_cache_stale_served_total` must stay 0;
`chip_smoke.py`'s cache leg gates on it). Traffic realism lives in
`repro_torch.traffic`.

Counterpart of `repro.cache`, copied with only its imports changed: keys
and hits are decided on the host in numpy, as in the reference, so a hit
never waits on the card.
"""
from repro_torch.cache.route_cache import CacheConfig, CachedRoute, SemanticRouteCache

__all__ = ["CacheConfig", "CachedRoute", "SemanticRouteCache"]
