"""StageSet: one atomic snapshot of the gateway's learned serving stages.

Counterpart of `repro/router/stages.py`. A `StageSet` is an immutable
value: the adapter params applied to query embeddings before the index
backend scores (query-side only, so the tool table — and any built index
over it — is untouched by a promotion), plus the re-ranker params and
featurizer applied per batch after candidate retrieval. `SemanticRouter`
holds one live StageSet behind a version counter (CAS `set_stages`,
bounded history, `rollback_stages`).

Params are dicts of torch tensors (`convert.params_from_jax` carries the
JAX package's across); each stage runs on the device its params live on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.adapter import adapter_apply
from repro_torch.core.features import OutcomeFeaturizer

__all__ = ["StageSet"]


@dataclasses.dataclass(frozen=True)
class StageSet:
    """Immutable learned-stage configuration served by one router snapshot.

    `adapter_artifact` / `rerank_artifact` are the artifact versions the
    params came from (None for hand-wired params), so serving results stay
    attributable to a specific trained artifact.
    """

    adapter_params: Optional[Dict[str, torch.Tensor]] = None  # §4.3 head
    adapter_scale: float = 1.0
    adapter_artifact: Optional[int] = None
    mlp_params: Optional[Dict[str, torch.Tensor]] = None  # §4.2 [7,64,32,1] MLP
    featurizer: Optional[OutcomeFeaturizer] = None
    rerank_artifact: Optional[int] = None

    @property
    def has_adapter(self) -> bool:
        return self.adapter_params is not None

    @property
    def has_reranker(self) -> bool:
        return self.mlp_params is not None and self.featurizer is not None

    @property
    def active(self) -> frozenset:
        """Stage names live in this set (mirrors `DeploymentPlan.stages`)."""
        s = set()
        if self.has_adapter:
            s.add("adapter")
        if self.has_reranker:
            s.add("rerank")
        return frozenset(s)

    def adapt_queries(self, q: np.ndarray) -> np.ndarray:
        """Apply the adapter head to a [Q, D] numpy query block (identity
        when no adapter is active) on the params' device and return numpy.
        Unit rows in, unit rows out — the index backend scores the adapted
        queries against the *unadapted* table."""
        if not self.has_adapter:
            return q
        device = self.adapter_params["w1"].device
        q_t = torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(device)
        out = adapter_apply(self.adapter_params, q_t, scale=self.adapter_scale)
        return out.cpu().numpy()
