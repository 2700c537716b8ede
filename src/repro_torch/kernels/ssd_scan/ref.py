"""Plain PyTorch version of the SSD chunk-scan kernel.

Counterpart of `repro/kernels/ssd_scan/ref.py::ssd_scan_ref`: the chunked
state-space duality algorithm of the port's `models/ssm.py::ssd_chunked`
(one source of truth, as in the JAX package). `ops.ssd_scan` serves it for
CPU tensors; `chip_smoke.py` holds the kernel against it on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models import ssm

__all__ = ["ssd_scan_ref"]


def ssd_scan_ref(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H]
    a_log: torch.Tensor,  # [H]
    b_mat: torch.Tensor,  # [B, S, G, N]
    c_mat: torch.Tensor,  # [B, S, G, N]
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [B, S, H, P] in x's dtype, final state [B, H, P, N] float32)."""
    return ssm.ssd_chunked(x, dt, a_log, b_mat, c_mat, chunk)
