"""Hand-written Hopper kernels of the port.

  topk_sim        — fused similarity + top-K (replaces the Pallas
                    `repro/kernels/topk_sim/kernel.py::topk_sim_pallas`)
  flash_attention — online-softmax attention (replaces
                    `repro/kernels/flash_attention/kernel.py::flash_attention_pallas`)
  ssd_scan        — the Mamba-2 SSD chunk scan (replaces
                    `repro/kernels/ssd_scan/kernel.py::ssd_scan_pallas`)

Each subpackage ships kernel.py (the CUDA build, binding and launch
wrapper), ref.py (the plain PyTorch version) and ops.py (the public op:
CPU tensors take the plain version, CUDA tensors the kernel). CUDA C++
sources live in `csrc/` and are compiled with nvcc at first use.

No kernel has a backward, as no Pallas kernel of the JAX package has one:
a kernel's output comes out of a ctypes call and carries no `grad_fn`.
`no_backward_check` makes the ops of flash_attention and ssd_scan raise
on their kernel path when an input requires grad, so a gradient is never
lost without an error; training takes the plain versions.
"""
from __future__ import annotations

import torch

__all__ = ["no_backward_check"]


def no_backward_check(op: str, *inputs: torch.Tensor) -> None:
    """Raise ValueError when grad is enabled and an input requires grad:
    the kernel's output would carry no gradient back to it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise ValueError(
            f"{op}: the kernel has no backward, and an input requires grad; "
            f"pass use_kernel=False to differentiate through the plain version")
