"""Public fused similarity + top-K op: `topk_sim(queries, table, k)`.

Counterpart of `repro/kernels/topk_sim/ops.py`. The device of the inputs
picks the path, and nothing else does: CPU tensors take the plain version
(`ref.topk_sim_ref`), CUDA tensors the hand-written kernel
(`kernel.topk_sim_cuda`), anything else raises. There is no fallback from
the kernel to the plain version: a kernel that cannot build or launch is
an error the caller sees.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.topk_sim.kernel import topk_sim_cuda
from repro_torch.kernels.topk_sim.ref import topk_sim_ref

__all__ = ["topk_sim"]


def topk_sim(
    queries: torch.Tensor,  # [Q, D] float32 unit rows
    table: torch.Tensor,  # [T, D] float32 unit rows
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, k] float32 descending, indices [Q, k] int64); ties go to
    the lowest index."""
    if queries.device != table.device:
        raise ValueError(
            f"queries on {queries.device} but table on {table.device}"
        )
    if queries.device.type == "cpu":
        return topk_sim_ref(queries, table, k)
    if queries.device.type == "cuda":
        return topk_sim_cuda(queries, table, k)
    raise ValueError(f"topk_sim has no path for device {queries.device}")
