"""Plain PyTorch version of the rope_heads kernel, and the plain rotary embedding.

`rope` is the model's rotary embedding, the reference's arithmetic in
float32: `models/layers.py` imports it from here, and training and decode
call it. `rope_heads_ref` is what the kernel computes in one launch: `rope`
of q and of k, then q, k and v each laid out heads-major
(`heads_major`), the layout the flash-attention kernel reads.
`ops.rope_heads` serves it for CPU tensors; `chip_smoke.py` and the card
tests hold the kernel against it.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["heads_major", "inv_freq", "rope", "rope_heads_ref"]


def inv_freq(half: int, theta: float, device) -> torch.Tensor:
    """RoPE's inverse frequencies, theta ** (-i / half) for i < half, float32."""
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: [B, S, H, hd]; positions: [B, S] absolute."""
    half = x.shape[-1] // 2
    freqs = inv_freq(half, theta, x.device)
    ang = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def heads_major(t: torch.Tensor) -> torch.Tensor:
    """[B, S, H, hd] -> contiguous [B*H, S, hd], the flash kernel's layout."""
    b, s, h, hd = t.shape
    # reshape alone returns a strided view when b == 1
    return t.permute(0, 2, 1, 3).contiguous().view(b * h, s, hd)


def rope_heads_ref(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, Hkv, hd]
    v: torch.Tensor,  # [B, S, Hkv, hd]
    positions: torch.Tensor,  # [B, S] absolute
    theta: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(qh [B*H, S, hd], kh [B*Hkv, S, hd], vh [B*Hkv, S, hd]): q and k
    roped, v as it is, each heads-major."""
    return (heads_major(rope(q, positions, theta)), heads_major(rope(k, positions, theta)),
            heads_major(v))
