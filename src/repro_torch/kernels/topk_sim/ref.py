"""Plain PyTorch version of the fused similarity + top-K kernel (Eq. 2).

Counterpart of `repro/kernels/topk_sim/ref.py`: one matmul that builds the
[Q, T] score matrix, then a stable descending sort, so ties go to the
lowest index as `lax.top_k` resolves them. `ops.topk_sim` serves it for
CPU tensors; `chip_smoke.py` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.retrieval import stable_topk

__all__ = ["topk_sim_ref"]


def topk_sim_ref(
    queries: torch.Tensor,  # [Q, D] unit rows
    table: torch.Tensor,  # [T, D] unit rows
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (scores [Q, k], indices [Q, k]) by descending similarity."""
    return stable_topk(queries @ table.T, k)
