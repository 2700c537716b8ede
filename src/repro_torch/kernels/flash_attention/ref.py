"""Plain PyTorch version of the flash-attention kernel.

Counterpart of `repro/kernels/flash_attention/ref.py::attention_ref`: the
full [Sq, Skv] logits, the causal / window mask, a float32 softmax cast to
v's type, and the PV product. The logits are float32 products of the
inputs' values, as the kernel (and the Pallas kernel, with
`preferred_element_type=float32`) computes them; the JAX oracle rounds
them to the input type first, which for bf16 inputs moves large logits by
whole units. It also takes k and v with fewer rows than q
(grouped-query attention): query row bh reads key/value row bh // g, with
g = BH / BHkv, the mapping the CUDA kernel uses. `ops.flash_attention`
serves it for CPU tensors; `chip_smoke.py` holds the kernel against it on
the card.
"""
from __future__ import annotations

import math

import torch

__all__ = ["attention_ref", "attention_mask"]

MASKED = -1e30  # the logit of a masked pair, as the JAX oracle fills it


def attention_mask(sq: int, skv: int, causal: bool, window: int, q_offset: int,
                   device=None) -> torch.Tensor:
    """[Sq, Skv] boolean, True = attend; query row i sits at q_offset + i."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def attention_ref(
    q: torch.Tensor,  # [BH, Sq, hd]
    k: torch.Tensor,  # [BHkv, Skv, hd], BH % BHkv == 0
    v: torch.Tensor,  # [BHkv, Skv, hd]
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    bh, sq, hd = q.shape
    bhkv, skv = k.shape[0], k.shape[1]
    qg = q.reshape(bhkv, bh // bhkv, sq, hd)
    logits = torch.einsum("bgqd,bkd->bgqk", qg.float(), k.float()) / math.sqrt(hd)
    mask = attention_mask(sq, skv, causal, window, q_offset, q.device)
    logits = logits.masked_fill(~mask, MASKED)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bgqk,bkd->bgqd", probs, v).reshape(bh, sq, hd)
