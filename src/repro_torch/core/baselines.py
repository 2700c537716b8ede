"""Baselines (§5.3): BM25, Static Embedding, SE+Lexical, Random.

BM25 is Okapi BM25 (k1=1.5, b=0.75) over the tool-description token corpus,
vectorized as a dense [T, V] term-frequency matrix (fine at ToolBench scale:
2,413 x ~10k). SE+Lexical reproduces the semantic router's
FilterAndRankTools: a weighted blend of dense similarity, normalized BM25,
exact tool-name match, and a category prior.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["BM25", "se_lexical_scores", "random_rankings"]


@dataclasses.dataclass
class BM25:
    """Okapi BM25 with an inverted index (word -> (docs, weighted tf)).

    Sparse by construction: tool descriptions are ~12 tokens, so the index
    holds O(T * desc_len) postings regardless of vocabulary size.
    """

    idf: np.ndarray  # [V]
    postings: dict  # word -> (doc_ids int64[], saturated_tf float32[])
    n_docs: int
    k1: float
    b: float
    vocab_size: int

    @classmethod
    def fit(
        cls,
        doc_tokens: Sequence[np.ndarray],
        vocab_size: int,
        k1: float = 1.5,
        b: float = 0.75,
    ) -> "BM25":
        n_docs = len(doc_tokens)
        doc_len = np.array([len(t) for t in doc_tokens], dtype=np.float32)
        avg_len = max(doc_len.mean(), 1.0)
        df = np.zeros(vocab_size, dtype=np.float32)
        raw: dict[int, list[tuple[int, float]]] = {}
        for i, toks in enumerate(doc_tokens):
            words, counts = np.unique(np.asarray(toks, dtype=np.int64), return_counts=True)
            df[words] += 1.0
            norm = k1 * (1.0 - b + b * doc_len[i] / avg_len)
            for w, tf in zip(words, counts):
                sat = tf * (k1 + 1.0) / (tf + norm)
                raw.setdefault(int(w), []).append((i, float(sat)))
        idf = np.log((n_docs - df + 0.5) / (df + 0.5) + 1.0)
        postings = {
            w: (
                np.array([d for d, _ in lst], dtype=np.int64),
                np.array([s for _, s in lst], dtype=np.float32),
            )
            for w, lst in raw.items()
        }
        return cls(
            idf=idf, postings=postings, n_docs=n_docs, k1=k1, b=b, vocab_size=vocab_size
        )

    def scores(self, query_tokens: Sequence[np.ndarray]) -> np.ndarray:
        """[Q, T] BM25 scores."""
        out = np.zeros((len(query_tokens), self.n_docs), dtype=np.float32)
        for j, toks in enumerate(query_tokens):
            words, counts = np.unique(np.asarray(toks, dtype=np.int64), return_counts=True)
            for w, qtf in zip(words, counts):
                entry = self.postings.get(int(w))
                if entry is None:
                    continue
                docs, sat = entry
                # query term frequency beyond 1 adds linearly (standard Okapi)
                out[j, docs] += self.idf[w] * sat * qtf
        return out


def se_lexical_scores(
    dense_sims: np.ndarray,  # [Q, T] embedding similarity
    bm25_scores: np.ndarray,  # [Q, T]
    name_match: np.ndarray,  # [Q, T] {0,1} tool-name token appears in query
    category_prior: np.ndarray,  # [Q, T] in [0,1]
    w_embed: float = 0.60,
    w_lex: float = 0.25,
    w_name: float = 0.10,
    w_cat: float = 0.05,
) -> np.ndarray:
    """FilterAndRankTools-style weighted combination (§5.3 baseline 3)."""
    # normalize BM25 per query to [0, 1] so weights are comparable
    mx = bm25_scores.max(axis=1, keepdims=True)
    lex = bm25_scores / np.maximum(mx, 1e-9)
    return w_embed * dense_sims + w_lex * lex + w_name * name_match + w_cat * category_prior


def random_rankings(
    rng: np.random.Generator,
    n_queries: int,
    n_tools: int,
    k: int,
    candidates: Optional[List[np.ndarray]] = None,
) -> np.ndarray:
    """Random top-k per query (§5.3 lower bound)."""
    out = np.zeros((n_queries, k), dtype=np.int64)
    for j in range(n_queries):
        pool = candidates[j] if candidates is not None else np.arange(n_tools)
        perm = rng.permutation(pool)
        take = perm[:k]
        if len(take) < k:  # pad by cycling (tiny candidate sets)
            take = np.concatenate([take, perm[: k - len(take)]])
        out[j] = take
    return out
