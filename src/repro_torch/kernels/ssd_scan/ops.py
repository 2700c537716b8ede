"""Public SSD chunk-scan op: `ssd_scan(x, dt, a_log, b_mat, c_mat, chunk)`.

Counterpart of `repro/kernels/ssd_scan/ops.py`, whose `use_pallas` becomes
`use_kernel`. With `use_kernel=None` the device of the inputs picks the
path: CPU tensors take the plain version (`ref.ssd_scan_ref`), CUDA tensors
the hand-written kernel (`kernel.ssd_scan_cuda`), anything else raises. A
CUDA tensor reaches the plain version only when the caller passes
`use_kernel=False`; a kernel that cannot build or launch is an error the
caller sees. The kernel has no backward: on the kernel path an input that
requires grad while grad is enabled raises (`no_backward_check`), and
training passes `use_kernel=False`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# modules, not names: ref imports models.ssm, which imports this module
from repro_torch.kernels import no_backward_check
from repro_torch.kernels.ssd_scan import kernel, ref

__all__ = ["ssd_scan"]


def ssd_scan(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H]
    a_log: torch.Tensor,  # [H]
    b_mat: torch.Tensor,  # [B, S, G, N]
    c_mat: torch.Tensor,  # [B, S, G, N]
    chunk: int,
    use_kernel: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [B, S, H, P] in x's dtype, final state [B, H, P, N] float32)."""
    if use_kernel is None:
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"ssd_scan has no path for device {x.device}")
        use_kernel = x.device.type == "cuda"
    if use_kernel:
        no_backward_check("ssd_scan", x, dt, a_log, b_mat, c_mat)
        return kernel.ssd_scan_cuda(x, dt, a_log, b_mat, c_mat, chunk)
    return ref.ssd_scan_ref(x, dt, a_log, b_mat, c_mat, chunk)
