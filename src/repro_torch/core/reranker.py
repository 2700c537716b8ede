"""OATS-S2 learned re-ranking MLP (§4.2), serving side. [7, 64, 32, 1].

Counterpart of `repro/core/reranker.py`. At inference the gateway
retrieves C = alpha*K candidates by similarity, rescores them with f_phi
and keeps the top-K by MLP score. Params keep the JAX layout
(`w{i}: [din, dout]`, `b{i}: [dout]`). BCE training is not ported yet;
trained params come across through `convert.py`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.features import N_FEATURES
from repro_torch.core.retrieval import NEG_INF, stable_topk

__all__ = ["LAYERS", "mlp_forward", "rerank_topk", "rerank_topk_scored"]

LAYERS = (N_FEATURES, 64, 32, 1)  # paper §4.2: [7, 64, 32, 1] => 2,625 params


def mlp_forward(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x: [..., 7] -> logits [...]. Sigmoid is applied in the loss/score."""
    h = x
    n_layers = len(LAYERS) - 1
    for li in range(n_layers):
        h = h @ params[f"w{li}"] + params[f"b{li}"]
        if li < n_layers - 1:
            h = torch.relu(h)
    return h[..., 0]


def rerank_topk_scored(
    params: Dict[str, torch.Tensor],
    features: torch.Tensor,  # [Q, C, 7] similarity-ordered candidates
    cand_idx: torch.Tensor,  # [Q, C]
    k: int,
    valid: Optional[torch.Tensor] = None,  # [Q, C] — False for padded slots
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-score candidates with f_phi; return (top-K ids, their f_phi scores).

    Invalid slots score `NEG_INF`, and the top-K is a stable sort, so they
    rank last and tie toward the lowest slot as `lax.top_k` orders them.
    """
    scores = mlp_forward(params, features)  # [Q, C]
    if valid is not None:
        scores = torch.where(valid, scores, NEG_INF)
    top_scores, order = stable_topk(scores, k)
    return torch.gather(cand_idx, 1, order), top_scores


def rerank_topk(
    params: Dict[str, torch.Tensor],
    features: torch.Tensor,
    cand_idx: torch.Tensor,
    k: int,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ids-only wrapper around `rerank_topk_scored`."""
    return rerank_topk_scored(params, features, cand_idx, k, valid)[0]
