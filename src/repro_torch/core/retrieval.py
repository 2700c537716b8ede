"""Serving-path retrieval: similarity -> top-K (Eq. 2), in PyTorch.

Counterpart of `repro/core/retrieval.py`. `topk_dense` is the exact path
(one matmul + a sort) and the oracle the fused kernel
(`repro_torch.kernels.topk_sim`) is held against.

Top-K is `torch.sort(descending=True, stable=True)` and not `torch.topk`:
the reference's `lax.top_k` breaks ties toward the lowest index, and only
the stable sort reproduces that (masked rows tie at `NEG_INF`, zero pad
queries tie at 0).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.common.device import resolve_device

__all__ = ["NEG_INF", "similarities", "topk_dense", "rank_dense", "stable_topk"]

# the one padding sentinel: the gateway keeps a slot only when
# `score > NEG_INF / 2`, so every masked or unfillable slot must use it
NEG_INF = -1e30


def similarities(query_emb: torch.Tensor, tool_emb: torch.Tensor) -> torch.Tensor:
    """Cosine similarity assuming unit-normalized rows. [Q,D]x[T,D] -> [Q,T]."""
    return query_emb @ tool_emb.T


def stable_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest per row; ties go to the lowest index.

    Raises ValueError for k outside [0, n] as `lax.top_k` does, instead of
    returning a silently shorter result.
    """
    n = scores.shape[-1]
    if not 0 <= k <= n:
        raise ValueError(f"k={k} is outside [0, {n}]")
    values, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], order[..., :k]


def topk_dense(
    query_emb: torch.Tensor,
    tool_emb: torch.Tensor,
    k: int,
    candidate_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (scores, indices) per query. candidate_mask: [Q,T] {0,1} or None."""
    sims = similarities(query_emb, tool_emb)
    if candidate_mask is not None:
        sims = torch.where(candidate_mask > 0, sims, NEG_INF)
    return stable_topk(sims, k)


def rank_dense(
    query_emb: np.ndarray,
    tool_emb: np.ndarray,
    k: int,
    candidate_mask: Optional[np.ndarray] = None,
    device: Union[str, torch.device, None] = None,
) -> np.ndarray:
    """Numpy convenience wrapper returning indices only."""
    device = resolve_device(device)
    mask = None if candidate_mask is None else torch.as_tensor(candidate_mask, device=device)
    _, idx = topk_dense(
        torch.as_tensor(query_emb, device=device),
        torch.as_tensor(tool_emb, device=device),
        k,
        mask,
    )
    return idx.cpu().numpy()
