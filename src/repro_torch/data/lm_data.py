"""Synthetic LM token pipeline for backend training (deterministic, shardable).

A copy of `repro/data/lm_data.py` (numpy only), with its imports changed:
the same seed yields the same batches in both packages.

A first-order Markov source over the model's vocabulary with Zipfian
stationary distribution — enough structure that a ~100M model's loss visibly
drops over a few hundred steps (the end-to-end training deliverable) while
staying fully offline and seed-deterministic.

The iterator yields host numpy batches; each data-parallel process would
slice `[process_index::process_count]` in a real multi-host launch (the
single-process CPU container yields the full global batch).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig

__all__ = ["LMDataConfig", "synthetic_lm_batches"]


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    batch_size: int = 8
    seq_len: int = 256
    seed: int = 0
    branching: int = 64  # successor fan-out per token (Markov structure)
    zipf_a: float = 1.2


def _zipf_probs(n: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** a
    return p / p.sum()


def synthetic_lm_batches(
    cfg: ModelConfig, data: LMDataConfig
) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(data.seed)
    v = cfg.vocab_size
    base = _zipf_probs(v, data.zipf_a)
    # per-token successor tables: token t -> `branching` likely successors
    succ = rng.choice(v, size=(min(v, 4096), data.branching), p=base)

    def sample_seq(r: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty(length, dtype=np.int32)
        t = int(r.choice(v, p=base))
        for i in range(length):
            out[i] = t
            if r.random() < 0.85:  # follow Markov structure
                t = int(succ[t % succ.shape[0], r.integers(0, data.branching)])
            else:  # occasional jump
                t = int(r.choice(v, p=base))
        return out

    step = 0
    while True:
        r = np.random.default_rng((data.seed, step))
        if cfg.n_codebooks:
            toks = np.stack(
                [
                    np.stack(
                        [sample_seq(r, data.seq_len) % v for _ in range(cfg.n_codebooks)],
                        axis=-1,
                    )
                    for _ in range(data.batch_size)
                ]
            )
        else:
            toks = np.stack([sample_seq(r, data.seq_len) for _ in range(data.batch_size)])
        batch: Dict[str, np.ndarray] = {"tokens": toks}
        if cfg.cross_attn_every:
            # stubbed vision tower output (DESIGN.md §5)
            batch["image_embeds"] = r.normal(
                size=(data.batch_size, cfg.n_image_tokens, cfg.d_model)
            ).astype(np.float32) * 0.02
        step += 1
        yield batch
