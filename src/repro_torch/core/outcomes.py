"""Outcome-log machinery (Alg. 1 steps 1-2), in PyTorch.

Counterpart of `repro/core/outcomes.py`. From production logs we build,
per tool, the positive query set Q+ and the hard-negative set Q-,
represented densely as [Q_train, T] masks. Two sources feed this
machinery:

  * train-split ground truth (`collect_outcomes`): retrieval against a dense
    relevance matrix — the offline benchmark shape. It runs on the device
    of its inputs;
  * streamed serving outcomes (`masks_from_stream`, numpy, copied): (query,
    tool, outcome) event triples logged by the live router. Its positive
    mask doubles as the observed relevance matrix `refine_embeddings`
    consumes.

`positives` semantics (paper App. A.3 vs Alg.1 line 10): "ground_truth"
(the default) collects *all* ground-truth queries for the tool as Q+;
"retrieved" keeps only those that were also retrieved.

The top-K is `stable_topk`, not `torch.topk`: under candidate masks the
`-1e30` slots tie, and `lax.top_k` takes them lowest index first, which
decides which masked tools land in `neg_mask` when a query has fewer than
k candidates.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.retrieval import NEG_INF, stable_topk

__all__ = ["OutcomeLogs", "collect_outcomes", "masks_from_topk", "masks_from_stream"]


@dataclasses.dataclass
class OutcomeLogs:
    pos_mask: torch.Tensor  # [Q, T] 1 where q in Q_i^+
    neg_mask: torch.Tensor  # [Q, T] 1 where q in Q_i^- (retrieved, not relevant)
    retrieved: torch.Tensor  # [Q, K] top-K indices under current embeddings

    @property
    def pos_counts(self) -> torch.Tensor:  # [T]
        return self.pos_mask.sum(dim=0)

    @property
    def neg_counts(self) -> torch.Tensor:  # [T]
        return self.neg_mask.sum(dim=0)


def collect_outcomes(
    query_emb: torch.Tensor,  # [Q, D] train queries
    tool_emb: torch.Tensor,  # [T, D] current tool table
    relevance: torch.Tensor,  # [Q, T] binary ground truth
    candidate_mask: Optional[torch.Tensor] = None,  # [Q, T] or None
    k: int = 5,
    positives: str = "ground_truth",
) -> OutcomeLogs:
    sims = query_emb @ tool_emb.T
    if candidate_mask is not None:
        sims = torch.where(candidate_mask > 0, sims, NEG_INF)
    k = min(k, sims.shape[1])  # tool sets smaller than K
    _, topk = stable_topk(sims, k)  # [Q, K]
    pos_mask, neg_mask = masks_from_topk(topk, relevance, positives)
    return OutcomeLogs(pos_mask=pos_mask, neg_mask=neg_mask, retrieved=topk)


def masks_from_topk(
    topk: torch.Tensor,  # [Q, K] retrieved columns of `relevance`
    relevance: torch.Tensor,  # [Q, T] binary ground truth
    positives: str = "ground_truth",
    valid: Optional[torch.Tensor] = None,  # [Q, K] bool: entries naming a column
) -> tuple[torch.Tensor, torch.Tensor]:
    """The (pos_mask, neg_mask) [Q, T] of a top-K: Q+ by `positives`, Q-
    the retrieved columns that are not relevant. With `valid`, entries
    outside it are retrieved elsewhere (a tool-sharded refinement's global
    top-K, shifted into this rank's columns) and mark nothing."""
    # retrieved_mask[q, t] = 1 iff t in topk(q); a top-K names a column once
    if valid is None:
        retrieved_mask = torch.zeros_like(relevance).scatter_(1, topk, 1.0)
    else:  # the entries outside `valid` add 0 to column 0
        retrieved_mask = torch.zeros_like(relevance).scatter_add_(
            1, torch.where(valid, topk, 0), valid.to(relevance.dtype))
    if positives == "retrieved":
        pos_mask = retrieved_mask * relevance
    else:  # "ground_truth": every labelled-relevant train query counts
        pos_mask = relevance
    neg_mask = retrieved_mask * (1.0 - relevance)  # hard negatives only
    return pos_mask, neg_mask


def masks_from_stream(
    query_ids: np.ndarray,  # [E] int — index into the deduped query axis
    tool_ids: np.ndarray,  # [E] int — routed tool per event
    outcomes: np.ndarray,  # [E] {0, 1} — logged success/failure
    n_queries: int,
    n_tools: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Dense `[Q, T]` pos/neg masks from streamed (q_j, t_i, o_j) events.

    Pure numpy (the control plane's side). At least one logged success
    marks a (query, tool) pair positive, and positives veto negatives, so
    `pos * neg == 0` always holds. `pos` is the observed relevance matrix
    for `refine_embeddings`; `neg` the observed-failure mask, kept for
    diagnostics and density accounting.
    """
    query_ids = np.asarray(query_ids, dtype=np.int64)
    tool_ids = np.asarray(tool_ids, dtype=np.int64)
    outcomes = np.asarray(outcomes)
    if query_ids.size:
        assert query_ids.min() >= 0 and query_ids.max() < n_queries
        assert tool_ids.min() >= 0 and tool_ids.max() < n_tools
    pos = np.zeros((n_queries, n_tools), dtype=np.float32)
    neg = np.zeros((n_queries, n_tools), dtype=np.float32)
    good = outcomes > 0
    pos[query_ids[good], tool_ids[good]] = 1.0
    neg[query_ids[~good], tool_ids[~good]] = 1.0
    neg *= 1.0 - pos
    return pos, neg
