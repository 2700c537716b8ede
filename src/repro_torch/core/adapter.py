"""OATS-S3 contrastive adapter head (§4.3), serving side: `adapter_apply`.

Counterpart of `repro/core/adapter.py`. The residual head
h(e) = normalize(e + scale * (W2 relu(W1 e + b1) + b2)) with the JAX
package's parameter layout: `w1 [384, 256]`, `b1 [256]`, `w2 [256, 384]`,
`b2 [384]` (`[din, dout]`, so `x @ w`). Triplet mining and InfoNCE training
are not ported yet; trained params come across through `convert.py`.
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["DIM", "HIDDEN", "adapter_apply"]

DIM = 384
HIDDEN = 256  # [384, 256, 384] => 197,248 params


def adapter_apply(
    params: Dict[str, torch.Tensor], emb: torch.Tensor, scale: float = 1.0
) -> torch.Tensor:
    """emb: [..., 384] unit rows -> adapted unit rows (drop-in, same dim)."""
    h = torch.relu(emb @ params["w1"] + params["b1"])
    out = emb + scale * (h @ params["w2"] + params["b2"])
    norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp_min(1e-9)
    return out / norm
