"""Benchmark evaluation harness: all methods x all metrics (paper §5-6).

Counterpart of `repro/core/evaluate.py`. Produces the rows of Tables 4/5
and the per-subtask splits of Table 3, on the fixed held-out 30% test set.
Every method ranks exactly the same test queries under the same candidate
constraints. The baselines are numpy on the host; the OATS presets fit on
`device` (None: the card), through `OATSPipeline.fit`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.baselines import BM25, random_rankings, se_lexical_scores
from repro_torch.core.pipeline import STAGE_PRESETS, OATSPipeline, PipelineConfig
from repro_torch.data.benchmarks import SUBTASKS, Benchmark
from repro_torch.embedding.bag_encoder import BagEncoder
from repro_torch.metrics.retrieval import evaluate_ranking

__all__ = ["MethodResult", "BenchmarkEvaluator", "DEFAULT_METHODS"]

DEFAULT_METHODS = ("random", "bm25", "se", "se+lexical", "oats-s1", "oats-s2", "oats-s3")
K_EVAL = 10  # rankings depth: covers R@{1,3,5}, NDCG@5, MRR


@dataclasses.dataclass
class MethodResult:
    name: str
    metrics: Dict[str, float]
    per_subtask: Dict[str, Dict[str, float]]
    rankings: np.ndarray  # [n_test, K_EVAL]
    pipeline: Optional[OATSPipeline] = None


class BenchmarkEvaluator:
    def __init__(self, bench: Benchmark, seed: int = 0,
                 device: Union[str, torch.device, None] = None):
        self.bench = bench
        self.seed = seed
        self.device = resolve_device(device)
        self.encoder = BagEncoder(bench.vocab, device=self.device)
        self.tool_emb = self.encoder.encode(bench.desc_tokens)
        self.query_emb = self.encoder.encode(bench.query_tokens)
        self.relevance = bench.relevance_matrix()
        self.cand_mask = (
            bench.candidate_mask() if bench.candidates is not None else None
        )
        self.test_idx = bench.test_idx
        self.test_tokens = [bench.query_tokens[i] for i in self.test_idx]
        self._bm25 = BM25.fit(bench.desc_tokens, bench.vocab.size)
        # category prior for SE+Lexical: similarity of query to category centroid
        n_cat = int(bench.tool_category.max()) + 1
        cat_centroids = np.zeros((n_cat, self.tool_emb.shape[1]), np.float32)
        for c in range(n_cat):
            m = bench.tool_category == c
            if m.any():
                v = self.tool_emb[m].mean(axis=0)
                cat_centroids[c] = v / max(np.linalg.norm(v), 1e-9)
        self._cat_centroids = cat_centroids

    # ------------------------------------------------------------ rankings
    def _mask_test(self, sims: np.ndarray) -> np.ndarray:
        if self.cand_mask is not None:
            sims = np.where(self.cand_mask[self.test_idx] > 0, sims, -1e30)
        return sims

    def _rank_from_scores(self, sims: np.ndarray) -> np.ndarray:
        return np.argsort(-sims, axis=1, kind="stable")[:, :K_EVAL]

    def rankings_for(self, method: str) -> MethodResult:
        name = method.lower()
        pipeline = None
        if name == "random":
            rng = np.random.default_rng(self.seed)
            cands = (
                [self.bench.candidates[i] for i in self.test_idx]
                if self.bench.candidates is not None
                else None
            )
            rk = random_rankings(
                rng, len(self.test_idx), self.bench.n_tools, K_EVAL, cands
            )
        elif name == "bm25":
            scores = self._bm25.scores(self.test_tokens)
            rk = self._rank_from_scores(self._mask_test(scores))
        elif name == "se":
            sims = self.query_emb[self.test_idx] @ self.tool_emb.T
            rk = self._rank_from_scores(self._mask_test(sims))
        elif name == "se+lexical":
            sims = self.query_emb[self.test_idx] @ self.tool_emb.T
            bm = self._bm25.scores(self.test_tokens)
            name_match = np.zeros_like(sims)
            for j, toks in enumerate(self.test_tokens):
                toks = set(int(t) for t in toks)
                for t in range(self.bench.n_tools):
                    if self.bench.vocab.name_token(t) in toks:
                        name_match[j, t] = 1.0
            cat_sim = (
                self.query_emb[self.test_idx] @ self._cat_centroids.T
            )  # [Q, n_cat]
            cat_prior = cat_sim[:, self.bench.tool_category]  # [Q, T]
            scores = se_lexical_scores(sims, bm, name_match, cat_prior)
            rk = self._rank_from_scores(self._mask_test(scores))
        elif name in STAGE_PRESETS:
            cfg = PipelineConfig(stages=STAGE_PRESETS[name], seed=self.seed)
            pipeline = OATSPipeline.fit(self.bench, cfg, self.encoder, device=self.device)
            rk = pipeline.rank(
                self.test_tokens,
                K_EVAL,
                None if self.cand_mask is None else self.cand_mask[self.test_idx],
            )
        else:
            raise ValueError(f"unknown method {method!r}")
        return self._score(name, rk, pipeline)

    # -------------------------------------------------------------- scoring
    def _score(
        self, name: str, rankings: np.ndarray, pipeline: Optional[OATSPipeline]
    ) -> MethodResult:
        rows: List[Dict[str, float]] = []
        subtask_rows: Dict[str, List[Dict[str, float]]] = {s: [] for s in SUBTASKS}
        for j, qi in enumerate(self.test_idx):
            m = evaluate_ranking(rankings[j], self.bench.relevant[qi])
            rows.append(m)
            subtask_rows[SUBTASKS[self.bench.subtask[qi]]].append(m)

        def mean(rs: List[Dict[str, float]]) -> Dict[str, float]:
            if not rs:
                return {}
            return {k: float(np.mean([r[k] for r in rs])) for k in rs[0]}

        return MethodResult(
            name=name,
            metrics=mean(rows),
            per_subtask={s: mean(r) for s, r in subtask_rows.items()},
            rankings=rankings,
            pipeline=pipeline,
        )

    def run(self, methods: Sequence[str] = DEFAULT_METHODS) -> Dict[str, MethodResult]:
        return {m: self.rankings_for(m) for m in methods}
