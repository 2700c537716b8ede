"""StageTrainers: turn an outcome window into trained stage artifacts.

Counterpart of `repro/learn/trainers.py`. The offline fitting code in
`core.adapter` / `core.reranker` consumes dense benchmark splits; these
trainers are the bridge from the control plane's *streamed* evidence — a
`RefinementBatch` built from the `OutcomeStore` ring — to those same
training entry points, run off the hot path by the `LearningController`:

  * `TrainWindow` freezes everything a training run needs (one table
    snapshot + the window's deduped queries/masks + a train/val split of
    positive-bearing queries) so the run is reproducible and attributable
    to (table_version, window fingerprint). It stays numpy, as the
    reference's;
  * `AdapterTrainer` mines triplets (`mine_triplets`, numpy) over the
    window's observed successes and runs `train_adapter` on its `device`
    in query-side-only mode (`adapt_tools=False`): the product is a pure
    query-transform whose promotion never touches the tool table or any
    built index;
  * `RerankerTrainer` fits an `OutcomeFeaturizer` (numpy) on the window,
    featurizes the top-C candidates of every train query (scored on its
    `device`), and runs `train_reranker` there on the *outcome-labelled*
    (query, candidate) pairs only — unobserved pairs carry no label,
    conflating "not tried" with "failed" is exactly the sparse-regime
    failure §7.3 warns about;
  * `stage_ndcg` is the shared held-out gate metric: NDCG@5 of the ranking
    the serving path would produce under a given `StageSet`, computed on
    the device through `adapter_apply`, `rerank_topk` and
    `batched_ndcg_at_k`, so promotion decisions are judged on the exact
    serving composition (adapter before scoring, re-ranker after) rather
    than a proxy.

Products come back to the host as numpy (the registry's and the
checkpoint's format); `TrainedStage.apply_to` puts them on the serving
device. `device=None` means the CUDA card.

Tie order: the reference ranks candidates with `np.argsort(-sims)`, which
is not stable; the port ranks with `stable_topk` (ties to the lowest tool
index, as `lax.top_k` and the serving path order them). The two agree
except where two tools score exactly the same for a query.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import adapter as adapter_lib
from repro_torch.core import reranker as reranker_lib
from repro_torch.core.features import OutcomeFeaturizer
from repro_torch.core.retrieval import stable_topk
from repro_torch.metrics.retrieval import batched_ndcg_at_k
from repro_torch.router.stages import StageSet

__all__ = [
    "TrainWindow",
    "TrainedStage",
    "AdapterTrainer",
    "RerankerTrainer",
    "stage_ndcg",
    "featurizer_to_tree",
    "featurizer_from_tree",
]

Device = Union[str, torch.device, None]


def _tensors(params: dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """Params (numpy arrays or tensors) as tensors on `device`."""
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.array(v))).to(device)
            for k, v in params.items()}


@dataclasses.dataclass
class TrainWindow:
    """One frozen training set: table snapshot + outcome-window evidence."""

    table: np.ndarray  # [T, D] snapshot the training set is built on
    table_version: int
    query_emb: np.ndarray  # [Q, D] deduped window queries (batched-encoded)
    query_tokens: List[np.ndarray]
    pos_mask: np.ndarray  # [Q, T] observed successes
    neg_mask: np.ndarray  # [Q, T] observed failures
    tool_category: np.ndarray  # [T]
    train_idx: np.ndarray  # rows used for fitting
    val_idx: np.ndarray  # held-out positive-bearing rows (the gate slice)
    fingerprint: str  # OutcomeStore.window_fingerprint() at build time

    def tokens(self, idx: np.ndarray) -> List[np.ndarray]:
        return [self.query_tokens[i] for i in idx]


@dataclasses.dataclass
class TrainedStage:
    """A trainer's product, ready for the registry + gate."""

    stage: str
    params: dict  # numpy pytree (registry/serving both accept it)
    aux: dict  # extra state the stage needs at serving (featurizer tree)
    info: Dict[str, float]  # training diagnostics for reports/benchmarks

    def apply_to(
        self,
        current: StageSet,
        artifact_version: Optional[int] = None,
        device: Device = None,
    ) -> StageSet:
        """Candidate StageSet = `current` with this stage replaced, its
        params on `device` (the serving router's)."""
        device = resolve_device(device)
        if self.stage == "adapter":
            return dataclasses.replace(
                current,
                # device-resident params: the hot path applies them per batch
                adapter_params=_tensors(self.params, device),
                adapter_artifact=artifact_version,
            )
        assert self.stage == "rerank", self.stage
        return dataclasses.replace(
            current,
            mlp_params=_tensors(self.params, device),
            featurizer=featurizer_from_tree(self.aux),
            rerank_artifact=artifact_version,
        )


# --------------------------------------------------------------------- gate
def stage_ndcg(
    table: np.ndarray,
    query_emb: np.ndarray,
    query_tokens: List[np.ndarray],
    relevance: np.ndarray,
    stages: StageSet,
    k: int = 5,
    candidate_multiplier: int = 5,
    device: Device = None,
) -> float:
    """Held-out NDCG@k of the ranking the serving path produces under
    `stages` — adapter applied to queries before scoring, re-ranker over the
    top-C candidates after, exactly like `SemanticRouter.route_batch` — on
    `device`."""
    device = resolve_device(device)
    q = torch.as_tensor(np.asarray(query_emb, np.float32), device=device)
    if stages.has_adapter:
        q = adapter_lib.adapter_apply(_tensors(stages.adapter_params, device), q,
                                      scale=stages.adapter_scale)
    t = torch.as_tensor(np.asarray(table, np.float32), device=device)
    sims = q @ t.T
    if stages.has_reranker:
        c = min(max(k * candidate_multiplier, k), t.shape[0])
        cand_sims, order = stable_topk(sims, c)
        feats = stages.featurizer.features(
            q.cpu().numpy(), query_tokens, order.cpu().numpy(), cand_sims.cpu().numpy()
        )
        topk = reranker_lib.rerank_topk(
            _tensors(stages.mlp_params, device), torch.from_numpy(feats).to(device),
            order, min(k, c),
        )
    else:
        _, topk = stable_topk(sims, min(k, sims.shape[1]))
    rel = torch.as_tensor(np.asarray(relevance, np.float32), device=device)
    return float(batched_ndcg_at_k(topk, rel))


# ------------------------------------------------------------------ trainers
class AdapterTrainer:
    """§4.3 contrastive adapter from streamed outcomes (query-side only)."""

    stage = "adapter"

    def __init__(
        self,
        config: Optional[adapter_lib.AdapterConfig] = None,
        device: Device = None,
    ):
        # online defaults: adapt_tools=False is the hot-swap contract; a few
        # epochs at a serving-loop-friendly lr (the offline 1e-5/5-epoch
        # schedule assumes many passes over a static corpus, not a bounded
        # window between controller steps) — early stopping on held-out
        # NDCG@5 inside train_adapter keeps the schedule safe
        self.config = config or adapter_lib.AdapterConfig(
            lr=3e-4, epochs=6, adapt_tools=False
        )
        assert not self.config.adapt_tools, (
            "the learning plane serves the adapter query-side only; training "
            "with adapt_tools=True would optimize a different deployment"
        )
        self.device = resolve_device(device)

    def train(
        self, window: TrainWindow, live_stages: Optional[StageSet] = None
    ) -> TrainedStage:
        # `live_stages` is ignored by design: a trained adapter REPLACES the
        # live one wholesale, so it learns from raw encoder embeddings —
        # composing h(h'(q)) would couple artifacts across generations
        cfg = self.config
        triplets = adapter_lib.mine_triplets(
            window.query_emb[window.train_idx],
            window.table,
            window.pos_mask[window.train_idx],
            n_hard=cfg.n_hard_negatives,
            seed=cfg.seed,
        )
        if len(triplets[0]) == 0:
            raise ValueError(
                "no mineable triplets in the window (every positive-bearing "
                "query lacks enough hard negatives)"
            )
        params, history = adapter_lib.train_adapter(
            window.query_emb[window.train_idx],
            window.table,
            triplets,
            window.query_emb[window.val_idx],
            window.pos_mask[window.val_idx],
            None,
            cfg,
            device=self.device,
        )
        return TrainedStage(
            stage=self.stage,
            params={k: v.cpu().numpy() for k, v in params.items()},
            aux={},
            info={
                "n_triplets": float(len(triplets[0])),
                "val_ndcg_first": float(history["val_ndcg"][0]),
                "val_ndcg_best": float(max(history["val_ndcg"])),
            },
        )


class RerankerTrainer:
    """§4.2 MLP re-ranker from outcome-labelled (query, candidate) pairs."""

    stage = "rerank"

    def __init__(
        self,
        config: Optional[reranker_lib.RerankerConfig] = None,
        k: int = 5,
        min_pairs: int = 64,
        device: Device = None,
    ):
        self.config = config or reranker_lib.RerankerConfig(epochs=10)
        self.k = int(k)
        self.min_pairs = int(min_pairs)
        self.device = resolve_device(device)

    def train(
        self, window: TrainWindow, live_stages: Optional[StageSet] = None
    ) -> TrainedStage:
        cfg = self.config
        tr = window.train_idx
        # the re-ranker runs DOWNSTREAM of the adapter at serving time, so
        # its featurizer and candidate ordering must be fit on the same
        # query representation the serving path scores with — the live
        # adapter's output, when one is active (training/serving skew
        # otherwise: the MLP would score a feature distribution it never saw)
        q = window.query_emb[tr]
        if live_stages is not None:
            q = live_stages.adapt_queries(q)
        c = min(max(self.k * cfg.candidate_multiplier, self.k), window.table.shape[0])
        sims = (torch.as_tensor(np.asarray(q, np.float32), device=self.device)
                @ torch.as_tensor(window.table, device=self.device).T)
        cand_sims, order = (x.cpu().numpy() for x in stable_topk(sims, c))
        featurizer = OutcomeFeaturizer.fit(
            q,
            window.tokens(tr),
            window.pos_mask[tr],
            order[:, : self.k],
            window.tool_category,
            seed=cfg.seed,
        )
        feats = featurizer.features(q, window.tokens(tr), order, cand_sims)
        labels = np.take_along_axis(window.pos_mask[tr], order, axis=1)
        # train ONLY on observed pairs: an unobserved candidate is unlabelled,
        # not failed (the §7.3 sparse-regime trap)
        observed = np.take_along_axis(
            (window.pos_mask[tr] + window.neg_mask[tr]) > 0, order, axis=1
        )
        n_pairs = int(observed.sum())
        if n_pairs < self.min_pairs:
            raise ValueError(
                f"only {n_pairs} outcome-labelled pairs in the window "
                f"(need >= {self.min_pairs})"
            )
        params, losses = reranker_lib.train_reranker(
            feats[observed], labels[observed], cfg, device=self.device
        )
        return TrainedStage(
            stage=self.stage,
            params={k: v.cpu().numpy() for k, v in params.items()},
            aux=featurizer_to_tree(featurizer),
            info={
                "n_pairs": float(n_pairs),
                "loss_first": float(losses[0]),
                "loss_last": float(losses[-1]),
            },
        )


# ------------------------------------------- featurizer <-> checkpoint tree
def featurizer_to_tree(f: OutcomeFeaturizer) -> dict:
    """Featurizer state as an array pytree (registry aux / checkpointable)."""
    return {
        "cluster_centroids": np.asarray(f.cluster_centroids),
        "success_rate": np.asarray(f.success_rate),
        "tool_freq": np.asarray(f.tool_freq),
        "tool_category": np.asarray(f.tool_category),
        "cluster_category": np.asarray(f.cluster_category),
        "mean_query_len": np.float64(f.mean_query_len),
    }


def featurizer_from_tree(tree: dict) -> OutcomeFeaturizer:
    return OutcomeFeaturizer(
        cluster_centroids=np.asarray(tree["cluster_centroids"], np.float32),
        success_rate=np.asarray(tree["success_rate"], np.float32),
        tool_freq=np.asarray(tree["tool_freq"], np.float32),
        tool_category=np.asarray(tree["tool_category"], np.int64),
        cluster_category=np.asarray(tree["cluster_category"], np.int64),
        mean_query_len=float(np.asarray(tree["mean_query_len"])),
    )
