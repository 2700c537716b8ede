"""DenseBackend: exact brute-force scoring — the default and the oracle.

Counterpart of `repro/index/dense.py`: one `topk_dense` call (matmul +
stable sort, optional per-query candidate masks) against a copy of the
table snapshot resident on the backend's device, uploaded once per
version. On the card the matmul is cuBLAS in full float32 and the sort is
PyTorch's, just as the JAX dense path is XLA outside any Pallas kernel.
The manager's exact fallback is a DenseBackend too, so fallback and dense
numerics are identical by construction.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.retrieval import topk_dense

__all__ = ["DenseBackend"]


class DenseBackend:
    name = "dense"
    supports_masks = True
    # build == one device upload: the manager rebuilds inline on swap
    build_is_cheap = True

    def __init__(
        self,
        table: np.ndarray,
        table_version: int,
        device: Union[str, torch.device, None] = None,
    ):
        self.device = resolve_device(device)
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
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(self.device)
        mask = None
        if candidate_mask is not None:
            mask = torch.from_numpy(np.ascontiguousarray(candidate_mask)).to(self.device)
        scores, idx = topk_dense(q, self._table_t, k, mask)
        return scores.cpu().numpy(), idx.cpu().numpy()
