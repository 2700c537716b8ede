"""Realistic request traffic for the serving plane.

Production router traffic is nothing like the uniform shuffled streams unit
benches replay: request popularity is Zipfian (a small hot set dominates),
repeats are *near*-duplicates (paraphrases, not byte-equal), arrival is
bursty, and the hot set drifts. This package synthesizes that shape,
deterministically per seed, so two runs — e.g. a bare router and a cached
one in `chip_smoke.py`'s cache leg — can be driven with the IDENTICAL
stream and compared query-for-query.

`ZipfTrafficGenerator` (generator.py) samples ranks from a Zipf(s) law over
a fixed pool of distinct intents, applies paraphrase jitter (token
drop+append, tuned to stay within a route cache's cosine threshold), draws
lognormal burst batch sizes, and adversarially rotates the rank→intent
mapping every `hot_set_rotate_every` batches — the churn that flushes any
recency-based cache.

`drive` (harness.py) replays a stream through `route_batch`, timing route
calls only, and enforces the **staleness gate** on every result: the
served `(table_version, stage_version)` must lie inside the live version
window read around the call (versions are monotone, so the window is
exact even while control-plane swaps land concurrently mid-stream).
`agreement` compares two replays of the same stream top-1-for-top-1 — the
cached-vs-uncached routing-agreement number.

Counterpart of `repro.traffic`, copied with only its imports changed.
"""
from repro_torch.traffic.generator import TrafficConfig, ZipfTrafficGenerator
from repro_torch.traffic.harness import TrafficReport, agreement, drive

__all__ = [
    "TrafficConfig",
    "ZipfTrafficGenerator",
    "TrafficReport",
    "agreement",
    "drive",
]
