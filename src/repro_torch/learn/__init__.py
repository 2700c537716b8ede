"""Learning plane: train, version, and gate the learned stages against the
live router.

Counterpart of `repro.learn`, with the same exports: the registry and the
guard are copies with only their imports changed; the trainers, the
held-out gate (`stage_ndcg`) and the controller run on a torch device (the
serving router's card unless asked).

The paper's practical guidance is staged (§7.2-7.3): start with zero-cost
centroid refinement (the `repro_torch.control` plane), then add learned
components *only when data density warrants it*. This package is the
subsystem that acts on that guidance: it turns the outcome window the
control plane already maintains into trained stage artifacts, and promotes
them into the serving path only when a held-out gate says they beat the
live configuration — then keeps watching them on live traffic and demotes
on regression.

  * `AdapterTrainer` / `RerankerTrainer` (trainers.py) — build training
    sets from the `OutcomeStore` window (triplet mining via
    `core.adapter.mine_triplets`, featurization via `core.features`) and
    run `train_adapter` / `train_reranker` off the hot path.
  * `ArtifactRegistry` (registry.py) — versioned, bounded, rollback-able
    store of trained artifacts keyed by (stage, version) and stamped with
    (table_version, window fingerprint); persists via
    `repro_torch.checkpoint`.
  * `StageGuard` (guard.py) — TableGuard-style shadow monitoring of the
    live `StageSet` on labelled traffic, with compare-and-swap
    auto-demotion through `SemanticRouter.rollback_stages`.
  * `LearningController` (controller.py) — the loop: plan
    (`core.deployment.recommend_stages` over live counters) -> train ->
    held-out NDCG@5 gate -> CAS activation -> shadow monitoring.

Stage-selection guide (the §7.3 decision table, as live policy)
===============================================================

``refine`` — always on. Zero serving cost, gate-protected; owned by
    `repro_torch.control.RefinementController`, not this package.

``adapter`` — the 197,248-param contrastive head. Trained and promoted
    only for large tool sets with abundant logs (|T| > 500, > 10K outcome
    examples). Served *query-side only*: `route_batch` applies it to the
    query block before the index backend scores, so the tool table — and
    any built IVF or fused index — is untouched by a promotion, and demotion
    is an instant StageSet rollback. Adds one tiny [Q,384]x[384,256]x
    [256,384] matmul pair per batch.

``rerank`` — the 2,625-param MLP over outcome features. Viable only above
    the ~10:1 outcome-to-tool density threshold (and below ~500 tools);
    below it the paper measured it *hurting* — the LearningController
    never trains it there, so sparse-density regimes never deploy it.
    Adds featurization + one MLP pass over C = 5K candidates per query.

Both gates are empirical on top of the density policy: a stage activates
only if it beats the live configuration's held-out NDCG@5 on the window's
positive-bearing queries, and stays only while live labelled traffic
agrees (`StageGuard`).

`chip_smoke.py` runs `benchmarks/learn_bench.py`'s density sweep
(refine-only vs +adapter vs +reranker NDCG@5) and `examples/live_loop.py
--stages`' three acts through this package on the card.
"""
from repro_torch.learn.controller import (
    LearnConfig,
    LearnReport,
    LearningController,
    StageDecision,
    build_train_window,
)
from repro_torch.learn.guard import StageGuard, StageGuardConfig, StageGuardReport
from repro_torch.learn.registry import ArtifactRegistry, StageArtifact
from repro_torch.learn.trainers import (
    AdapterTrainer,
    RerankerTrainer,
    TrainedStage,
    TrainWindow,
    featurizer_from_tree,
    featurizer_to_tree,
    stage_ndcg,
)

__all__ = [
    "LearnConfig",
    "LearnReport",
    "LearningController",
    "StageDecision",
    "StageGuard",
    "StageGuardConfig",
    "StageGuardReport",
    "ArtifactRegistry",
    "StageArtifact",
    "AdapterTrainer",
    "RerankerTrainer",
    "TrainedStage",
    "TrainWindow",
    "build_train_window",
    "featurizer_from_tree",
    "featurizer_to_tree",
    "stage_ndcg",
]
