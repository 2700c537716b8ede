"""Retrieval metrics: Recall@K, Precision@K, NDCG@K, MRR (paper §5.2).

Counterpart of `repro/metrics/retrieval.py`. The per-query functions are
pure numpy, copied unchanged: they run in the offline evaluation loop on
the host. The batched variants take torch tensors on any device (the
Stage-1 validation gate, the Stage-3 early stopping). They give each
query a float32 value, as the jnp versions do, and return the mean as
float32; but they add in float64, where a sum of a few thousand float32
values in [0, 1] (or a row's few NDCG discounts) is exact in any order,
and round once. So the mean does not depend on a device's summation order, and an
exact tie between two tables stays a tie: the gate's `r_after >=
r_before` accepts it on the card as on the CPU. (On the full
ToolBench-like benchmark the S1 gate is such a tie: 58.1667 / 63 before
and after; the reference's float32 sums happen to round it to `>=`.)
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

__all__ = [
    "recall_at_k",
    "precision_at_k",
    "ndcg_at_k",
    "mrr",
    "evaluate_ranking",
    "batched_recall_at_k",
    "batched_ndcg_at_k",
]


def recall_at_k(ranked: Sequence[int], relevant: Iterable[int], k: int) -> float:
    rel = set(relevant)
    if not rel:
        return 0.0
    hits = sum(1 for t in list(ranked)[:k] if t in rel)
    return hits / len(rel)


def precision_at_k(ranked: Sequence[int], relevant: Iterable[int], k: int) -> float:
    if k <= 0:
        return 0.0
    rel = set(relevant)
    hits = sum(1 for t in list(ranked)[:k] if t in rel)
    return hits / k


def ndcg_at_k(ranked: Sequence[int], relevant: Iterable[int], k: int) -> float:
    """Binary-gain NDCG@K."""
    rel = set(relevant)
    if not rel:
        return 0.0
    dcg = 0.0
    for pos, t in enumerate(list(ranked)[:k]):
        if t in rel:
            dcg += 1.0 / np.log2(pos + 2.0)
    ideal_hits = min(len(rel), k)
    idcg = sum(1.0 / np.log2(pos + 2.0) for pos in range(ideal_hits))
    return dcg / idcg


def mrr(ranked: Sequence[int], relevant: Iterable[int]) -> float:
    rel = set(relevant)
    for pos, t in enumerate(ranked):
        if t in rel:
            return 1.0 / (pos + 1.0)
    return 0.0


def evaluate_ranking(
    ranked: Sequence[int], relevant: Iterable[int], ks: Sequence[int] = (1, 3, 5)
) -> dict:
    """All paper metrics for one query."""
    out = {}
    for k in ks:
        out[f"recall@{k}"] = recall_at_k(ranked, relevant, k)
        out[f"precision@{k}"] = precision_at_k(ranked, relevant, k)
        out[f"ndcg@{k}"] = ndcg_at_k(ranked, relevant, k)
    out["mrr"] = mrr(ranked, relevant)
    return out


# --------------------------------------------------------------------------
# Batched torch variants (validation gate / early stopping). Relevance is a
# dense [n_queries, n_tools] 0/1 float32 tensor; rankings are [n_queries, k]
# index tensors on the same device. Queries with no relevant tools
# contribute 0 and are excluded from the mean via the `valid` mask.
# --------------------------------------------------------------------------


def _mean(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """float32 mean of the valid queries' values, summed exactly in float64."""
    return (values.double().sum() / valid.sum().clamp_min(1)).float()


def _gains(rankings: torch.Tensor, relevance: torch.Tensor) -> torch.Tensor:
    # rankings: [Q, k] int; relevance: [Q, T] {0,1} -> [Q, k] gains
    return torch.gather(relevance, 1, rankings.long())


def batched_recall_at_k(rankings: torch.Tensor, relevance: torch.Tensor) -> torch.Tensor:
    """Mean Recall@k over queries that have >=1 relevant tool (0-dim float32).

    rankings: [Q, k] indices into the tool axis. relevance: [Q, T] binary.
    """
    gains = _gains(rankings, relevance)
    n_rel = relevance.sum(dim=1)
    valid = n_rel > 0
    rec = torch.where(valid, gains.sum(dim=1) / n_rel.clamp_min(1), 0.0)
    return _mean(rec, valid)


def batched_ndcg_at_k(rankings: torch.Tensor, relevance: torch.Tensor) -> torch.Tensor:
    """Mean binary-gain NDCG@k, k = rankings.shape[1] (0-dim float32)."""
    k = rankings.shape[1]
    gains = _gains(rankings, relevance)  # [Q, k]
    discounts = 1.0 / torch.log2(
        torch.arange(k, dtype=torch.float32, device=relevance.device) + 2.0)  # [k]
    # each row's few discounts summed in float64 (exact, in any order),
    # divided and rounded once
    dcg = (gains.double() * discounts.double()).sum(dim=1)
    n_rel = relevance.sum(dim=1)
    ideal_hits = torch.minimum(n_rel, torch.tensor(float(k), device=n_rel.device))  # [Q]
    # idcg = sum of first ideal_hits discounts
    cum = torch.cumsum(discounts, dim=0)
    idcg = torch.where(
        ideal_hits > 0, cum[(ideal_hits.to(torch.int32) - 1).clamp_min(0).long()], 1.0
    )
    valid = n_rel > 0
    ndcg = torch.where(valid, (dcg / idcg.double()).float(), 0.0)
    return _mean(ndcg, valid)
