"""Deployment decision rules (paper §7.2-7.3).

The paper's practitioner guidance, as executable policy:
  * refinement is always on (zero serving cost, gate-protected);
  * the MLP re-ranker deploys only above a ~10:1 outcome-to-tool ratio
    ("Gate behind a data-density check (>= 10 examples/tool)", §7.2) —
    below that it hurt on ToolBench;
  * the contrastive adapter targets large tool sets with abundant logs
    (|T| > 500, > 10K logs, §7.3).
"""
from __future__ import annotations

import dataclasses

__all__ = ["DeploymentPlan", "recommend_stages", "data_density", "refine_trigger"]

MLP_DENSITY_THRESHOLD = 10.0  # outcome examples per tool (§7.2)
ADAPTER_MIN_TOOLS = 500  # §7.3
ADAPTER_MIN_LOGS = 10_000


@dataclasses.dataclass(frozen=True)
class DeploymentPlan:
    refine: bool
    mlp_reranker: bool
    contrastive_adapter: bool
    density: float
    reason: str

    @property
    def stages(self) -> frozenset:
        s = set()
        if self.refine:
            s.add("refine")
        if self.mlp_reranker:
            s.add("rerank")
        if self.contrastive_adapter:
            s.add("adapter")
        return frozenset(s)


def data_density(n_outcome_examples: int, n_tools: int) -> float:
    return n_outcome_examples / max(n_tools, 1)


def recommend_stages(n_tools: int, n_outcome_examples: int) -> DeploymentPlan:
    """Paper §7.3 decision table."""
    density = data_density(n_outcome_examples, n_tools)
    mlp = density >= MLP_DENSITY_THRESHOLD and n_tools <= 500
    adapter = n_tools > ADAPTER_MIN_TOOLS and n_outcome_examples > ADAPTER_MIN_LOGS
    if n_tools < 200:
        reason = "small tool set: refinement alone captures most gains (§7.3)"
        mlp = mlp and density >= 5 * MLP_DENSITY_THRESHOLD  # only if abundant
    elif mlp:
        reason = f"density {density:.1f} >= {MLP_DENSITY_THRESHOLD}: re-ranker viable"
    elif adapter:
        reason = "large tool set with abundant logs: contrastive adapter scales better"
    else:
        reason = f"density {density:.2f} < {MLP_DENSITY_THRESHOLD}: learned components would hurt"
    return DeploymentPlan(
        refine=True, mlp_reranker=mlp, contrastive_adapter=adapter,
        density=density, reason=reason,
    )


def refine_trigger(
    n_new_events: int,
    elapsed_s: float,
    min_events: int,
    max_interval_s: float,
) -> bool:
    """When should the online control plane wake the refinement job?

    §7.2's cadence guidance as policy: run when a full batch of fresh
    outcome evidence has accumulated (`min_events`), or when the table has
    gone stale (`max_interval_s` since the last refinement) *and* there is
    at least one new event — an idle router never churns its table, and a
    trickle of events is folded into the staleness cycle rather than waking
    the job per event.
    """
    if n_new_events >= min_events:
        return True
    return elapsed_s >= max_interval_s and n_new_events > 0
