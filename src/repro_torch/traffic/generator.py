"""Seeded Zipfian near-duplicate query streams (package docstring has the
traffic-shape rationale)."""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["TrafficConfig", "ZipfTrafficGenerator"]


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    zipf_s: float = 1.1  # popularity exponent; higher = hotter hot set
    pool_size: int = 512  # distinct intents behind the stream
    query_len: int = 24  # tokens per intent (longer = milder jitter cosine)
    batch_size: int = 32  # mean arrival batch
    burstiness: float = 0.0  # lognormal sigma on batch size (0 = constant)
    paraphrase_p: float = 0.5  # fraction of requests jittered
    jitter_tokens: int = 1  # tokens dropped+appended per paraphrase
    hot_set_rotate_every: int = 0  # batches between rank->intent reshuffles
    vocab: int = 4096
    seed: int = 0

    def __post_init__(self):
        assert self.zipf_s > 0 and self.pool_size >= 1
        assert self.query_len > 2 * self.jitter_tokens >= 0
        assert self.batch_size >= 1 and 0.0 <= self.paraphrase_p <= 1.0


class ZipfTrafficGenerator:
    """Deterministic per (config, call sequence): two generators built from
    the same config emit the IDENTICAL stream, which is what lets
    `chip_smoke.py`'s cache leg replay one stream through a bare router and
    a cached one and compare agreement query-for-query."""

    def __init__(
        self,
        config: TrafficConfig,
        pool: Optional[Sequence[np.ndarray]] = None,
    ):
        self.config = config
        self._rng = np.random.default_rng(config.seed)
        if pool is not None:
            # realistic intents (e.g. a Benchmark's query_tokens): routing
            # agreement between two replays is only meaningful when queries
            # actually resolve to a tool, so prefer this in benches. The
            # pool is cycled up to pool_size deterministically.
            assert all(len(t) > 2 * config.jitter_tokens for t in pool)
            self._pool = [
                np.asarray(pool[i % len(pool)], dtype=np.int64)
                for i in range(config.pool_size)
            ]
        else:
            # synthetic intents: token rows a BagEncoder-style embedder maps
            # to separated directions; paraphrases of one stay near it
            self._pool = [
                self._rng.integers(0, config.vocab, size=config.query_len).astype(np.int64)
                for _ in range(config.pool_size)
            ]
        # Zipf(s) over ranks, normalized; rank r -> intent _perm[r]
        p = (np.arange(config.pool_size) + 1.0) ** -config.zipf_s
        self._p = p / p.sum()
        self._perm = np.arange(config.pool_size)
        self._batches_emitted = 0

    def rotate_hot_set(self) -> None:
        """Adversarial churn: remap every rank to a fresh intent, so the
        whole hot set a cache has warmed goes cold at once."""
        self._rng.shuffle(self._perm)

    def _paraphrase(self, tokens: np.ndarray) -> np.ndarray:
        """Near-duplicate: drop `jitter_tokens` positions, append as many
        fresh ones. Length is preserved, so under a bag encoder the cosine
        to the original is ~((L - j) / L) — query_len 24 with one jittered
        token keeps ~0.958, inside the cache's default serving threshold
        region (see `repro_torch.cache` for the threshold/agreement tradeoff)."""
        cfg = self.config
        drop = self._rng.choice(len(tokens), size=cfg.jitter_tokens, replace=False)
        kept = np.delete(tokens, drop)
        fresh = self._rng.integers(0, cfg.vocab, size=cfg.jitter_tokens)
        return np.concatenate([kept, fresh.astype(np.int64)])

    def next_batch(self) -> List[np.ndarray]:
        """One arrival batch: Zipf-ranked intents, jittered per request."""
        cfg = self.config
        if cfg.hot_set_rotate_every and self._batches_emitted \
                and self._batches_emitted % cfg.hot_set_rotate_every == 0:
            self.rotate_hot_set()
        self._batches_emitted += 1
        n = cfg.batch_size
        if cfg.burstiness:
            n = max(1, int(round(n * np.exp(self._rng.normal(0.0, cfg.burstiness)))))
        ranks = self._rng.choice(cfg.pool_size, size=n, p=self._p)
        batch = []
        for r in ranks:
            tokens = self._pool[int(self._perm[r])]
            if cfg.paraphrase_p and self._rng.random() < cfg.paraphrase_p:
                tokens = self._paraphrase(tokens)
            batch.append(tokens)
        return batch

    def stream(self, n_batches: int) -> Iterator[List[np.ndarray]]:
        for _ in range(n_batches):
            yield self.next_batch()
