"""ScorerBackend: the contract every tool-index backend serves behind.

Counterpart of `repro/index/base.py`. A backend is an *immutable* index
built from one atomic table snapshot: it captures `(table_version, table)`
at build time, keeps the table resident on its device, and answers batched
top-K similarity queries against exactly that table until it is replaced.
All mutability lives one layer up in `ToolIndexManager`.

Contract (`topk`):

  * input `queries` is a `[Q, D]` float32 numpy block of unit rows (the
    gateway's padded batch); `k` is the candidate count the caller wants;
  * output is numpy `(scores [Q, k] float32, indices [Q, k] int64)` sorted
    by descending score per row, ties to the lowest index. Slots that
    cannot be filled (masked out, or fewer than `k` reachable candidates)
    carry the `NEG_INF` sentinel shared with `core.retrieval` — callers
    filter on `score > NEG_INF / 2`;
  * `scores` are the exact float32 similarities the ranking came from;
  * backends that cannot honor per-query candidate masks declare
    `supports_masks = False`; `ToolIndexManager` routes masked batches to
    the exact dense fallback instead of calling them with one.
"""
from __future__ import annotations

from typing import Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.core.retrieval import NEG_INF

__all__ = ["NEG_INF", "ScorerBackend"]


@runtime_checkable
class ScorerBackend(Protocol):
    """Batched top-K similarity scoring over one immutable table snapshot."""

    name: str  # registry key ("dense" | "fused" | "ivf")
    table_version: int  # ToolsDatabase version the index was built from
    n_tools: int  # rows in the indexed table
    supports_masks: bool  # can honor [Q, T] candidate masks natively
    device: torch.device  # where the table lives and the scoring runs

    def topk(
        self,
        queries: np.ndarray,  # [Q, D] float32 unit rows
        k: int,
        candidate_mask: Optional[np.ndarray] = None,  # [Q, T] {0,1} or None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores [Q, k], indices [Q, k]) by descending similarity."""
        ...
