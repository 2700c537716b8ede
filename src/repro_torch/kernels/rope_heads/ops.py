"""Public rope_heads op: `rope_heads(q, k, v, positions, theta)`.

With `use_kernel=None` the device of the inputs picks the path: CPU tensors
take the plain version (`ref.rope_heads_ref`), CUDA tensors the
hand-written kernel (`kernel.rope_heads_cuda`), anything else raises. A
kernel that cannot build or launch is an error the caller sees. The kernel
has no backward: on the kernel path an input that requires grad while grad
is enabled raises (`no_backward_check`); training never calls this op (its
attention takes the plain `rope`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import no_backward_check
from repro_torch.kernels.rope_heads.kernel import rope_heads_cuda
from repro_torch.kernels.rope_heads.ref import rope_heads_ref

__all__ = ["rope_heads"]


def rope_heads(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, Hkv, hd]
    v: torch.Tensor,  # [B, S, Hkv, hd]
    positions: torch.Tensor,  # [B, S] int64
    theta: float,
    use_kernel: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if use_kernel is None:
        if q.device.type not in ("cpu", "cuda"):
            raise ValueError(f"rope_heads has no path for device {q.device}")
        use_kernel = q.device.type == "cuda"
    if use_kernel:
        no_backward_check("rope_heads", q, k, v)
        return rope_heads_cuda(q, k, v, positions, theta)
    return rope_heads_ref(q, k, v, positions, theta)
