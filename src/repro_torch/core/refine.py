"""OATS-S1: iterative outcome-guided embedding refinement (Alg. 1, §4.1).

Counterpart of `repro/core/refine.py`, the paper's core contribution. A
Python loop runs the N iterations (outcome collection -> centroid
interpolation -> momentum blend) on the device of its inputs, and a
separate validation gate (Alg. 1 step 5) accepts the refined table only if
the held-out gate metric does not degrade.

Update rule (Eq. 7), per tool i with |Q_i^+| >= 1:

    e_hat = (1 - alpha) * e + alpha * centroid(Q_i^+) - beta * centroid(Q_i^-)
    e_hat = e_hat / ||e_hat||
    e_new = mu * e_prev + (1 - mu) * e_hat        (momentum, iterations n > 1)

Defaults are the paper's: alpha=0.3, beta=0.1, N=3, mu=0.5, K=5.

The [Q, D] x [D, T] products are `torch.matmul`, as they are plain XLA
matmuls outside any Pallas kernel in the reference; they run in full
float32 (TF32 stays off). The top-K is `stable_topk`: `lax.top_k`'s
lowest-index order on ties.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.outcomes import collect_outcomes
from repro_torch.core.retrieval import NEG_INF, stable_topk
from repro_torch.metrics.retrieval import batched_ndcg_at_k, batched_recall_at_k

__all__ = ["RefineConfig", "RefineResult", "refine_embeddings", "refine_with_gate"]


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    alpha: float = 0.3  # attraction toward positive centroid
    beta: float = 0.1  # repulsion from negative centroid (beta < alpha, §4.1)
    iterations: int = 3  # N
    momentum: float = 0.5  # mu
    k: int = 5  # top-K used both for outcome logs and the validation gate
    positives: str = "ground_truth"  # see outcomes.py
    # validation-gate metric: "recall" (Alg. 1 step 5, the offline default)
    # or "ndcg" (rank-sensitive; what the online control plane gates on)
    gate_metric: str = "recall"
    # materialize the [N+1, T, D] per-iteration history (Fig. 4 convergence
    # plots); False never allocates it
    keep_history: bool = True


@dataclasses.dataclass
class RefineResult:
    embeddings: torch.Tensor  # [T, D] refined (post-gate) tool table
    accepted: torch.Tensor  # 0-dim bool — validation gate decision
    recall_before: torch.Tensor  # 0-dim float32
    recall_after: torch.Tensor
    # [N+1, T, D] per-iteration tables (fig. 4 convergence), or None when
    # the run was configured with keep_history=False
    history: Optional[torch.Tensor]


def _masked_centroid(mask: torch.Tensor,
                     query_emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """mask: [Q, T]; query_emb: [Q, D] -> ([T, D] centroids, [T] counts)."""
    counts = mask.sum(dim=0)  # [T]
    sums = mask.T @ query_emb  # [T, D]
    centroids = sums / counts.clamp_min(1.0)[:, None]
    return centroids, counts


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-9)


def refine_embeddings(
    tool_emb: torch.Tensor,  # [T, D] original table e(d_i)
    query_emb: torch.Tensor,  # [Q, D] train-split query embeddings
    relevance: torch.Tensor,  # [Q, T] binary outcome labels
    candidate_mask: Optional[torch.Tensor] = None,
    *,
    alpha: float = 0.3,
    beta: float = 0.1,
    iterations: int = 3,
    momentum: float = 0.5,
    k: int = 5,
    positives: str = "ground_truth",
    keep_history: bool = True,
) -> torch.Tensor:
    """Run Alg. 1 steps 1-4.

    With `keep_history` (default) returns [N+1, T, D]: the table after each
    iteration (index 0 = original). With `keep_history=False` returns only
    the final [T, D] table, and the N+1 table copies are never allocated.
    """
    history = None
    if keep_history:
        history = torch.zeros((iterations + 1, *tool_emb.shape), dtype=tool_emb.dtype,
                              device=tool_emb.device)
        history[0] = tool_emb
    e_prev = tool_emb
    for n in range(iterations):
        # Steps 1-2: outcome logs against *current* embeddings — each pass
        # exposes the new hard negatives created by the previous update.
        logs = collect_outcomes(
            query_emb, e_prev, relevance, candidate_mask, k=k, positives=positives
        )
        # Step 3: centroid interpolation (Eq. 7)
        pos_c, pos_n = _masked_centroid(logs.pos_mask, query_emb)
        neg_c, neg_n = _masked_centroid(logs.neg_mask, query_emb)
        e_hat = (1.0 - alpha) * e_prev + alpha * pos_c
        e_hat = e_hat - beta * (neg_n > 0).to(e_hat.dtype)[:, None] * neg_c
        e_hat = _unit_rows(e_hat)
        # tools with no positive outcomes stay at their previous embedding
        e_hat = torch.where((pos_n > 0)[:, None], e_hat, e_prev)
        # Step 4: momentum blend with the previous iterate (n > 0)
        if n > 0:
            e_new = _unit_rows(momentum * e_prev + (1.0 - momentum) * e_hat)
        else:
            e_new = e_hat
        if history is not None:
            history[n + 1] = e_new
        e_prev = e_new
    return history if keep_history else e_prev


def _gate_metric_at_k(
    query_emb: torch.Tensor,
    tool_emb: torch.Tensor,
    relevance: torch.Tensor,
    candidate_mask: Optional[torch.Tensor],
    k: int,
    metric: str = "recall",
) -> torch.Tensor:
    sims = query_emb @ tool_emb.T
    if candidate_mask is not None:
        sims = torch.where(candidate_mask > 0, sims, NEG_INF)
    _, topk = stable_topk(sims, min(k, sims.shape[1]))
    if metric == "ndcg":
        return batched_ndcg_at_k(topk, relevance)
    assert metric == "recall", f"unknown gate metric {metric!r}"
    return batched_recall_at_k(topk, relevance)


def refine_with_gate(
    tool_emb: torch.Tensor,
    train_query_emb: torch.Tensor,
    train_relevance: torch.Tensor,
    val_query_emb: torch.Tensor,
    val_relevance: torch.Tensor,
    config: RefineConfig = RefineConfig(),
    train_candidate_mask: Optional[torch.Tensor] = None,
    val_candidate_mask: Optional[torch.Tensor] = None,
) -> RefineResult:
    """Alg. 1 incl. step 5: accept the refined table only if the held-out
    gate metric (Recall@K by default, NDCG@K via `config.gate_metric`) does
    not degrade (`r_after >= r_before`), so the deployed system cannot
    degrade below the static baseline (§4.1). Runs on the device of its
    inputs; `RefineResult.recall_before/after` hold whichever gate metric
    ran.
    """
    out = refine_embeddings(
        tool_emb,
        train_query_emb,
        train_relevance,
        train_candidate_mask,
        alpha=config.alpha,
        beta=config.beta,
        iterations=config.iterations,
        momentum=config.momentum,
        k=config.k,
        positives=config.positives,
        keep_history=config.keep_history,
    )
    history = out if config.keep_history else None
    refined = out[-1] if config.keep_history else out
    r_before = _gate_metric_at_k(
        val_query_emb, tool_emb, val_relevance, val_candidate_mask,
        config.k, config.gate_metric,
    )
    r_after = _gate_metric_at_k(
        val_query_emb, refined, val_relevance, val_candidate_mask,
        config.k, config.gate_metric,
    )
    accepted = r_after >= r_before
    final = torch.where(accepted, refined, tool_emb)
    return RefineResult(
        embeddings=final,
        accepted=accepted,
        recall_before=r_before,
        recall_after=r_after,
        history=history,
    )
