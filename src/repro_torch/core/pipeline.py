"""OATS pipeline: stage composition + fit/serve (Eq. 4, §5.4).

Counterpart of `repro/core/pipeline.py`. Configurations (cumulative, as in
the paper):
    OATS-S1 = {refine}
    OATS-S2 = {refine, rerank}
    OATS-S3 = {adapter, refine, rerank}

`fit` runs entirely offline (the control plane's job); `rank` is the
evaluation's serving path. All learning uses only the train split; Stage
1's validation gate and Stage 3's early stopping use an 85/15 sub-split of
train (§5.5), drawn with numpy's `default_rng(seed)`, so it is the
reference's split exactly.

`device=None` means the card. The static tool table and the query
embeddings cross to the device once; the adapter, the refinement and the
re-ranker's training run there. The candidate generation for Stage 2 and
`rank`'s similarity ordering stay numpy on the host, as the reference
computes them, and the MLP re-rank runs on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import adapter as adapter_lib
from repro_torch.core import reranker as reranker_lib
from repro_torch.core.features import OutcomeFeaturizer
from repro_torch.core.refine import RefineConfig, RefineResult, refine_with_gate
from repro_torch.data.benchmarks import Benchmark
from repro_torch.embedding.bag_encoder import BagEncoder

__all__ = ["PipelineConfig", "OATSPipeline", "STAGE_PRESETS"]

STAGE_PRESETS = {
    "se": frozenset(),
    "oats-s1": frozenset({"refine"}),
    "oats-s2": frozenset({"refine", "rerank"}),
    "oats-s3": frozenset({"adapter", "refine", "rerank"}),
    # ablation rows (Table 5 components in isolation)
    "adapter-only": frozenset({"adapter"}),
    "rerank-only": frozenset({"rerank"}),
}


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    stages: frozenset = frozenset({"refine"})
    k: int = 5
    refine: RefineConfig = RefineConfig()
    reranker: reranker_lib.RerankerConfig = reranker_lib.RerankerConfig()
    adapter: adapter_lib.AdapterConfig = adapter_lib.AdapterConfig()
    gate_val_frac: float = 0.15  # 85/15 sub-split of train (§5.5)
    seed: int = 0


@dataclasses.dataclass
class OATSPipeline:
    config: PipelineConfig
    encoder: BagEncoder
    tool_table: np.ndarray  # serving tool-embedding table (post refinement)
    device: torch.device
    adapter_params: Optional[dict] = None  # tensors on `device`
    mlp_params: Optional[dict] = None  # tensors on `device`
    featurizer: Optional[OutcomeFeaturizer] = None
    refine_result: Optional[RefineResult] = None
    adapter_history: Optional[dict] = None

    # ------------------------------------------------------------------ fit
    @classmethod
    def fit(
        cls,
        bench: Benchmark,
        config: PipelineConfig,
        encoder: Optional[BagEncoder] = None,
        device: Union[str, torch.device, None] = None,
    ) -> "OATSPipeline":
        device = resolve_device(device)
        enc = encoder or BagEncoder(bench.vocab, device=device)
        tool_emb0 = enc.encode(bench.desc_tokens)  # static table e(d_i)
        query_emb_all = enc.encode(bench.query_tokens)
        relevance = bench.relevance_matrix()
        cand_mask_all = bench.candidate_mask() if bench.candidates is not None else None

        train = bench.train_idx
        rng = np.random.default_rng(config.seed)
        perm = rng.permutation(len(train))
        n_val = max(int(round(config.gate_val_frac * len(train))), 1)
        fit_idx = train[np.sort(perm[n_val:])]
        val_idx = train[np.sort(perm[:n_val])]

        def sub(mat, idx):
            return None if mat is None else mat[idx]

        # the tables cross to the device once
        tool_t = torch.from_numpy(tool_emb0).to(device)
        q_all_t = torch.from_numpy(query_emb_all).to(device)
        rel_t = torch.from_numpy(relevance).to(device)
        mask_t = None if cand_mask_all is None else torch.from_numpy(cand_mask_all).to(device)
        fit_t = torch.from_numpy(fit_idx).to(device)
        val_t = torch.from_numpy(val_idx).to(device)

        q_t = q_all_t
        adapter_params = None
        adapter_history = None

        # ---- Stage 3 component: contrastive adapter (drop-in encoder swap)
        if "adapter" in config.stages:
            triplets = adapter_lib.mine_triplets(
                query_emb_all[fit_idx],
                tool_emb0,
                relevance[fit_idx],
                n_hard=config.adapter.n_hard_negatives,
                candidate_mask=sub(cand_mask_all, fit_idx),
                seed=config.seed,
            )
            adapter_params, adapter_history = adapter_lib.train_adapter(
                q_all_t[fit_t],
                tool_t,
                triplets,
                q_all_t[val_t],
                rel_t[val_t],
                sub(mask_t, val_t),
                config.adapter,
                device=device,
            )
            # recompute the tool table and all query embeddings once (§4.3)
            with torch.no_grad():
                tool_t = adapter_lib.adapter_apply(adapter_params, tool_t)
                q_t = adapter_lib.adapter_apply(adapter_params, q_all_t)

        # ---- Stage 1: outcome-guided refinement with validation gate
        refine_result = None
        if "refine" in config.stages:
            refine_result = refine_with_gate(
                tool_t,
                q_t[fit_t],
                rel_t[fit_t],
                q_t[val_t],
                rel_t[val_t],
                config.refine,
                sub(mask_t, fit_t),
                sub(mask_t, val_t),
            )
            tool_t = refine_result.embeddings
        tool_table = tool_t.cpu().numpy()
        q_emb = q_t.cpu().numpy() if q_t is not q_all_t else query_emb_all

        # ---- Stage 2: MLP re-ranker over outcome features
        mlp_params = None
        featurizer = None
        if "rerank" in config.stages:
            c = config.k * config.reranker.candidate_multiplier
            c = min(c, tool_table.shape[0])
            sims = q_emb[fit_idx] @ tool_table.T
            cm = sub(cand_mask_all, fit_idx)
            if cm is not None:
                sims = np.where(cm > 0, sims, -1e30)
            order = np.argsort(-sims, axis=1)[:, :c]
            cand_sims = np.take_along_axis(sims, order, axis=1)
            featurizer = OutcomeFeaturizer.fit(
                q_emb[fit_idx],
                [bench.query_tokens[i] for i in fit_idx],
                relevance[fit_idx],
                order[:, : config.k],
                bench.tool_category,
                seed=config.seed,
            )
            feats = featurizer.features(
                q_emb[fit_idx],
                [bench.query_tokens[i] for i in fit_idx],
                order,
                cand_sims,
            )
            labels = np.take_along_axis(relevance[fit_idx], order, axis=1)
            valid = cand_sims > -1e29  # ignore padded candidate slots
            mlp_params, _ = reranker_lib.train_reranker(
                feats[valid], labels[valid], config.reranker, device=device
            )

        return cls(
            config=config,
            encoder=enc,
            tool_table=tool_table,
            device=device,
            adapter_params=adapter_params,
            mlp_params=mlp_params,
            featurizer=featurizer,
            refine_result=refine_result,
            adapter_history=adapter_history,
        )

    # ---------------------------------------------------------------- serve
    def embed_queries(self, query_tokens: Sequence[np.ndarray]) -> np.ndarray:
        q = self.encoder.encode(query_tokens)
        if self.adapter_params is not None:
            with torch.no_grad():
                q = adapter_lib.adapter_apply(
                    self.adapter_params, torch.from_numpy(q).to(self.device)).cpu().numpy()
        return q

    def rank(
        self,
        query_tokens: Sequence[np.ndarray],
        k: int,
        candidate_mask: Optional[np.ndarray] = None,
        query_emb: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Evaluation path: embed -> similarity -> (optional re-rank) -> top-k."""
        q = self.embed_queries(query_tokens) if query_emb is None else query_emb
        sims = q @ self.tool_table.T
        if candidate_mask is not None:
            sims = np.where(candidate_mask > 0, sims, -1e30)
        if self.mlp_params is None:
            return np.argsort(-sims, axis=1)[:, :k]
        c = min(
            max(self.config.k * self.config.reranker.candidate_multiplier, k),
            self.tool_table.shape[0],
        )
        order = np.argsort(-sims, axis=1)[:, :c]
        cand_sims = np.take_along_axis(sims, order, axis=1)
        feats = self.featurizer.features(q, query_tokens, order, cand_sims)
        with torch.no_grad():
            reranked = reranker_lib.rerank_topk(
                self.mlp_params,
                torch.from_numpy(feats).to(self.device),
                torch.from_numpy(order).to(self.device),
                k,
                valid=torch.from_numpy(cand_sims > -1e29).to(self.device),
            )
        return reranked.cpu().numpy()
