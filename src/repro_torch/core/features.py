"""Outcome-derived features for the Stage-2 re-ranker (Eq. 8).

features(q, t_i) = [ sim, Delta_sim, cat(t_i), sr_i(q), freq_i, len(q), margin ]

d_feat = 7, matching the paper's [7, 64, 32, 1] MLP. `sr_i(q)` is the
historical success rate of tool i on queries in the same cluster as q
(k-means over train query embeddings); `freq_i` is tool usage frequency in
the outcome logs; `cat` is a category-affinity indicator between the tool and
the query's cluster.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

__all__ = ["kmeans", "OutcomeFeaturizer", "N_FEATURES"]

N_FEATURES = 7


def kmeans(
    x: np.ndarray, k: int, iters: int = 25, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Plain Lloyd's k-means. Returns (centroids [k,D], assignment [N])."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    k = min(k, n)
    centroids = x[rng.choice(n, size=k, replace=False)].copy()
    assign = np.zeros(n, dtype=np.int64)
    for _ in range(iters):
        d2 = ((x[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
        new_assign = d2.argmin(axis=1)
        if (new_assign == assign).all():
            break
        assign = new_assign
        for c in range(k):
            m = assign == c
            if m.any():
                centroids[c] = x[m].mean(axis=0)
    return centroids, assign


@dataclasses.dataclass
class OutcomeFeaturizer:
    cluster_centroids: np.ndarray  # [C, D]
    success_rate: np.ndarray  # [T, C] per-tool-per-cluster success rate
    tool_freq: np.ndarray  # [T] normalized usage frequency
    tool_category: np.ndarray  # [T]
    cluster_category: np.ndarray  # [C] dominant ground-truth category per cluster
    mean_query_len: float

    @classmethod
    def fit(
        cls,
        train_query_emb: np.ndarray,  # [Q, D]
        train_query_tokens: Sequence[np.ndarray],
        train_relevance: np.ndarray,  # [Q, T]
        train_retrieved: np.ndarray,  # [Q, K] top-K under serving embeddings
        tool_category: np.ndarray,  # [T]
        n_clusters: int = 32,
        seed: int = 0,
    ) -> "OutcomeFeaturizer":
        n_q, n_t = train_relevance.shape
        n_clusters = max(min(n_clusters, n_q // 8), 1)
        centroids, assign = kmeans(train_query_emb, n_clusters, seed=seed)
        n_c = centroids.shape[0]
        # success rate: of the times tool t was retrieved for cluster c, how
        # often was it relevant (Laplace-smoothed)
        sel = np.zeros((n_t, n_c), dtype=np.float32)
        hit = np.zeros((n_t, n_c), dtype=np.float32)
        for j in range(n_q):
            c = assign[j]
            for t in train_retrieved[j]:
                sel[t, c] += 1.0
                hit[t, c] += train_relevance[j, t]
        success_rate = (hit + 0.5) / (sel + 1.0)
        tool_freq = train_relevance.sum(axis=0)
        tool_freq = tool_freq / max(tool_freq.max(), 1.0)
        # dominant ground-truth category per cluster
        n_cat = int(tool_category.max()) + 1
        cat_votes = np.zeros((n_c, n_cat), dtype=np.float32)
        for j in range(n_q):
            for t in np.flatnonzero(train_relevance[j]):
                cat_votes[assign[j], tool_category[t]] += 1.0
        cluster_category = cat_votes.argmax(axis=1)
        mean_len = float(np.mean([len(t) for t in train_query_tokens])) or 1.0
        return cls(
            cluster_centroids=centroids,
            success_rate=success_rate,
            tool_freq=tool_freq.astype(np.float32),
            tool_category=tool_category,
            cluster_category=cluster_category,
            mean_query_len=mean_len,
        )

    def assign_cluster(self, query_emb: np.ndarray) -> np.ndarray:
        d2 = ((query_emb[:, None, :] - self.cluster_centroids[None, :, :]) ** 2).sum(-1)
        return d2.argmin(axis=1)

    def features(
        self,
        query_emb: np.ndarray,  # [Q, D]
        query_tokens: Sequence[np.ndarray],
        cand_idx: np.ndarray,  # [Q, C] candidate tool ids (similarity-ordered)
        cand_sims: np.ndarray,  # [Q, C] similarity scores, descending
    ) -> np.ndarray:
        """[Q, C, 7] feature tensor for every (query, candidate).

        Candidate slots whose similarity is the candidate-mask sentinel
        (-1e30, i.e. the query has fewer candidates than C) get all-zero
        features; callers must also mask their scores out of the re-ranked
        ordering (see `reranker.rerank_topk`).
        """
        n_q, n_c = cand_idx.shape
        valid = cand_sims > -1e29  # [Q, C]
        sims = np.where(valid, cand_sims, 0.0)
        clusters = self.assign_cluster(query_emb)  # [Q]
        feats = np.zeros((n_q, n_c, N_FEATURES), dtype=np.float32)
        # 0: similarity
        feats[:, :, 0] = sims
        # 1: gap to the next candidate (0 for the last)
        feats[:, :-1, 1] = sims[:, :-1] - sims[:, 1:]
        # 2: category affinity — tool category matches the cluster's dominant one
        feats[:, :, 2] = (
            self.tool_category[cand_idx] == self.cluster_category[clusters][:, None]
        ).astype(np.float32)
        # 3: historical success rate of tool in the query's cluster
        feats[:, :, 3] = self.success_rate[cand_idx, clusters[:, None]]
        # 4: tool usage frequency
        feats[:, :, 4] = self.tool_freq[cand_idx]
        # 5: normalized query length
        qlen = np.array([len(t) for t in query_tokens], dtype=np.float32)
        feats[:, :, 5] = (qlen / self.mean_query_len)[:, None]
        # 6: margin to the top-1 candidate
        feats[:, :, 6] = sims[:, :1] - sims
        return np.where(valid[:, :, None], feats, 0.0).astype(np.float32)
