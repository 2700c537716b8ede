"""Seeded request and token streams: frozen copies of the program's
`traffic/generator.py::ZipfTrafficGenerator` and `data/lm_data.py::
synthetic_lm_batches`, so that a change to the program cannot move the
yardstick. Deterministic in their seeds."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


class ZipfQueries:
    """Queries drawn from a pool of intents with Zipf(s) popularity over
    ranks; a share `paraphrase_p` of them has `jitter` tokens dropped and as
    many fresh ones (< `vocab`) appended (the generator's paraphrase)."""

    def __init__(self, pool: Sequence[np.ndarray], zipf_s: float, pool_size: int,
                 paraphrase_p: float, jitter: int, vocab: int, seed: int):
        self._rng = np.random.default_rng(seed)
        self._pool = [np.asarray(pool[i % len(pool)], np.int64) for i in range(pool_size)]
        if any(len(t) <= 2 * jitter for t in self._pool):
            raise ValueError("every intent needs more than 2 * jitter tokens")
        p = (np.arange(pool_size) + 1.0) ** -zipf_s
        self._p = p / p.sum()
        self._paraphrase_p, self._jitter, self._vocab = paraphrase_p, jitter, vocab

    def next(self) -> np.ndarray:
        tokens = self._pool[int(self._rng.choice(len(self._pool), p=self._p))]
        if self._paraphrase_p and self._rng.random() < self._paraphrase_p:
            drop = self._rng.choice(len(tokens), size=self._jitter, replace=False)
            fresh = self._rng.integers(0, self._vocab, size=self._jitter)
            tokens = np.concatenate([np.delete(tokens, drop), fresh.astype(np.int64)])
        return tokens


def lm_batches(vocab_size: int, batch_size: int, seq_len: int, seed: int, n_batches: int,
               branching: int = 64, zipf_a: float = 1.2) -> List[np.ndarray]:
    """`n_batches` token batches [batch_size, seq_len] int32 from a
    first-order Markov source over the vocabulary whose successors and
    jumps follow Zipf(zipf_a): batch i is drawn from the generator seeded
    (seed, i), as `synthetic_lm_batches` draws its step i."""
    rng = np.random.default_rng(seed)
    base = 1.0 / np.arange(1, vocab_size + 1) ** zipf_a
    base /= base.sum()
    succ = rng.choice(vocab_size, size=(min(vocab_size, 4096), branching), p=base)
    cdf = np.cumsum(base)

    def sample_seq(r: np.random.Generator, length: int) -> np.ndarray:
        # a jump draws from `base` by inverse CDF, a step follows `succ`
        follow = r.random(length) < 0.85
        jumps = np.minimum(np.searchsorted(cdf, r.random(length + 1), side="right"),
                           vocab_size - 1)
        picks = r.integers(0, branching, size=length)
        out = np.empty(length, dtype=np.int32)
        t = int(jumps[-1])
        for i in range(length):
            out[i] = t
            t = int(succ[t % succ.shape[0], picks[i]]) if follow[i] else int(jumps[i])
        return out

    batches = []
    for step in range(n_batches):
        r = np.random.default_rng((seed, step))
        batches.append(np.stack([sample_seq(r, seq_len) for _ in range(batch_size)]))
    return batches
