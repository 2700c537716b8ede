"""MiniLM-shaped sentence encoder in plain PyTorch (all-MiniLM-L6-v2 geometry).

Counterpart of `repro/embedding/transformer.py`: 6 layers, d_model=384,
12 heads, d_ff=1536, mean-pool + L2 — ~22M parameters with a 30k vocab,
the paper's production encoder (§5.5, Table 1). The parameter tree is the
reference's (flat, each per-layer weight stacked over layers), so
`repro_torch.convert.params_from_jax` carries a JAX tree across as it is.

No pretrained weights exist offline, so semantic evaluations use the frozen
bag encoder; this module exists for honest latency measurements (the
per-request cost does not depend on the weights) and the trainable-encoder
path. The reference is plain jnp with a key-padding mask and no Pallas
kernel, so the port is plain torch too, on the card unless the caller
asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Union

import torch
import torch.nn.functional as F

from repro_torch.common.device import resolve_device

__all__ = ["EncoderConfig", "init_encoder", "encode", "encoder_param_count"]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    n_layers: int = 6
    d_model: int = 384
    n_heads: int = 12
    d_ff: int = 1536
    max_len: int = 256


def init_encoder(
    generator: torch.Generator,
    cfg: EncoderConfig = EncoderConfig(),
    device: Union[str, torch.device, None] = None,
) -> dict:
    """The reference's init kinds and scales, drawn in float32 on the
    generator's device and placed on `device` (None: the card). The
    numbers differ from `jax.random`'s; tests carry a JAX tree across."""
    device = resolve_device(device)
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers

    def normal(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * scale).to(device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    return {
        "tok_emb": normal(v, d, scale=0.02),
        "pos_emb": normal(cfg.max_len, d, scale=0.02),
        # stacked per-layer weights
        "wqkv": normal(L, d, 3 * d),
        "wo": normal(L, d, d),
        "w1": normal(L, d, f),
        "w2": normal(L, f, d),
        "ln1": ones(L, d),
        "ln2": ones(L, d),
        "ln_f": ones(d),
    }


def encoder_param_count(params: dict) -> int:
    return sum(int(p.numel()) for p in params.values())


def _layer_norm(x, scale):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-6) * scale


def _block(x, mask, wqkv, wo, w1, w2, ln1, ln2, n_heads):
    b, s, d = x.shape
    h = _layer_norm(x, ln1)
    q, k, v = (h @ wqkv).chunk(3, dim=-1)  # [B, S, D] each
    hd = d // n_heads
    q, k, v = (t.reshape(b, s, n_heads, hd).transpose(1, 2) for t in (q, k, v))
    att = (q @ k.transpose(-1, -2)) / math.sqrt(hd)  # [B, H, S, S]
    att = torch.where(mask[:, None, None, :] > 0, att, -1e30)
    att = torch.softmax(att, dim=-1)
    o = (att @ v).transpose(1, 2).reshape(b, s, d) @ wo
    x = x + o
    h = _layer_norm(x, ln2)
    # jax.nn.gelu's default is the tanh approximation
    return x + F.gelu(h @ w1, approximate="tanh") @ w2


def encode(params: dict, ids: torch.Tensor, mask: torch.Tensor, n_heads: int = 12) -> torch.Tensor:
    """ids, mask: [B, S] on the params' device -> [B, 384] unit embeddings
    (mean-pool over the unmasked positions, §5.5)."""
    s = ids.shape[1]
    x = params["tok_emb"][ids.long()] + params["pos_emb"][:s][None]
    for i in range(params["wqkv"].shape[0]):
        x = _block(x, mask, *(params[n][i] for n in ("wqkv", "wo", "w1", "w2", "ln1", "ln2")),
                   n_heads)
    x = _layer_norm(x, params["ln_f"])
    m = mask[..., None].to(x.dtype)
    pooled = (x * m).sum(1) / m.sum(1).clamp_min(1.0)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-9)
