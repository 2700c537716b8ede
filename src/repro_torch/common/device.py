"""Device resolution for the port's entry points.

`device=None` means the CUDA card. A machine without one raises here
instead of moving the work to the CPU quietly: a caller that wants the CPU
(the tests) says so with `device="cpu"`.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """`None` -> `cuda`; raise RuntimeError when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU"
        )
    return dev
