"""FusedBackend: the fused score + top-K kernel behind the serving path.

Counterpart of `repro/index/pallas_backend.py::PallasBackend`. It serves
through `kernels/topk_sim/ops.topk_sim`: on the card that is the
hand-written Hopper kernel, which splits the table across the SMs, keeps a
running top-K per query in shared memory and never writes the [Q, T] score
matrix; on the CPU it is the plain version (matmul + stable sort), which
computes what `DenseBackend` computes, so the two backends agree exactly
there.

Constructing one on a CUDA device builds the kernel library (nvcc, once
per source hash), so the first served batch never pays for the compile.
CUDA still loads a route's kernels at the route's first launch; `warm`
makes those launches before serving.

No candidate-mask support: the kernel scores every table row by design.
The manager's exact fallback covers masked batches.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.common.bucketing import expected_buckets
from repro_torch.common.device import resolve_device
from repro_torch.kernels.topk_sim import kernel as topk_sim_kernel
from repro_torch.kernels.topk_sim.ops import topk_sim

__all__ = ["FusedBackend"]


class FusedBackend:
    name = "fused"
    supports_masks = False
    build_is_cheap = True  # one device upload; manager rebuilds inline on swap

    def __init__(
        self,
        table: np.ndarray,
        table_version: int,
        device: Union[str, torch.device, None] = None,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            topk_sim_kernel.build()
        table = np.asarray(table, np.float32)
        self.table_version = int(table_version)
        self.n_tools = table.shape[0]
        self._table_t = torch.from_numpy(np.ascontiguousarray(table)).to(self.device)

    def topk(
        self,
        queries: np.ndarray,
        k: int,
        candidate_mask: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        if candidate_mask is not None:
            raise ValueError(
                "FusedBackend scores the full table (no mask support); "
                "ToolIndexManager routes masked batches to the exact fallback"
            )
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(self.device)
        scores, idx = topk_sim(q, self._table_t, k)
        return scores.cpu().numpy(), idx.cpu().numpy()

    def warm(self, batch_size: int, ks) -> None:
        """On the card, launch the kernel once at each padded block that a
        `route_batch` of 1 to `batch_size` queries gives (its power-of-two
        buckets) for each k in `ks`, with table rows as the queries, and wait
        for the launches. CUDA loads a route's kernels at that route's first
        launch, so this puts the loads before serving. On the CPU it does
        nothing."""
        if self.device.type != "cuda":
            return
        ks = sorted({min(int(k), self.n_tools) for k in ks})
        for n_q in expected_buckets(range(1, max(int(batch_size), 1) + 1)):
            q = self._table_t[torch.arange(n_q, device=self.device) % self.n_tools]
            for k in ks:
                topk_sim(q, self._table_t, k)
        torch.cuda.synchronize(self.device)
