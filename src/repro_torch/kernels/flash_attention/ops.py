"""Public flash-attention op: `flash_attention(q, k, v, causal, window, q_offset)`.

Counterpart of `repro/kernels/flash_attention/ops.py`, whose `use_pallas`
becomes `use_kernel`. With `use_kernel=None` the device of the inputs picks
the path: CPU tensors take the plain version (`ref.attention_ref`), CUDA
tensors the hand-written kernel (`kernel.flash_attention_cuda`), anything
else raises. A CUDA tensor reaches the plain version only when the caller
passes `use_kernel=False`; a kernel that cannot build or launch is an error
the caller sees. The kernel has no backward: on the kernel path an input
that requires grad while grad is enabled raises (`no_backward_check`), and
training passes `use_kernel=False`, as the JAX package differentiates
through its plain attention.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import no_backward_check
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention"]


def flash_attention(
    q: torch.Tensor,  # [BH, Sq, hd]
    k: torch.Tensor,  # [BHkv, Skv, hd], BH % BHkv == 0
    v: torch.Tensor,  # [BHkv, Skv, hd]
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    if use_kernel is None:
        if q.device.type not in ("cpu", "cuda"):
            raise ValueError(f"flash_attention has no path for device {q.device}")
        use_kernel = q.device.type == "cuda"
    if use_kernel:
        no_backward_check("flash_attention", q, k, v)
        return flash_attention_cuda(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
