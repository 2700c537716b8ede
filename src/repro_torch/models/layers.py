"""Transformer building blocks: RMSNorm, RoPE, GQA attention (full causal /
sliding window / decode), the SwiGLU MLP, capacity-based MoE and gated
cross-attention.

Counterpart of `repro/models/layers.py`, with the same shapes and casts.
Parameters arrive as sub-dicts of the trees made in `repro_torch.models.
model`. The JAX package's logical sharding constraints are dropped: the
port runs on one device. Prefill attention (`attn_block`) goes through
`kernels.flash_attention.ops.flash_attention` (the hand-written kernel on
the card), which computes what `gqa_attention` computes under
`_causal_mask(s, s, 0, window)` (the port builds that mask in the kernel's
plain version, `kernels/flash_attention/ref.py::attention_mask`);
single-token decode (`attn_decode`) keeps the plain `gqa_attention` over
its ring-buffer mask, as the JAX decode runs outside any Pallas kernel.
`moe_block` keeps the reference's capacity-based scatter dispatch, its
router top-k in `lax.top_k`'s tie order (`stable_topk`) and its expert
products as batched einsums. `cross_attn_block` attends the image K/V
through the flash-attention kernel with `causal=False`, in prefill and in
single-token decode alike (the reference's all-ones mask).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.retrieval import stable_topk
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import ModelConfig

__all__ = [
    "rms_norm",
    "rope",
    "gqa_attention",
    "attn_block",
    "attn_decode",
    "swiglu",
    "moe_capacity",
    "moe_route",
    "moe_block",
    "cross_attn_block",
    "cross_attn_kv",
]

NEG_INF = -2.0**30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: [B, S, H, hd]; positions: [B, S] absolute."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def gqa_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, T, Hkv, hd]
    v: torch.Tensor,  # [B, T, Hkv, hd]
    mask: torch.Tensor,  # [B or 1, S, T] boolean (True = attend)
) -> torch.Tensor:
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / math.sqrt(hd)
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, hd)


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])  # [B,S,H,hd]
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])  # [B,S,Hkv,hd]
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def _heads_major(t: torch.Tensor) -> torch.Tensor:
    """[B, S, H, hd] -> contiguous [B*H, S, hd], the kernel's layout."""
    b, s, h, hd = t.shape
    # reshape alone returns a strided view when b == 1
    return t.permute(0, 2, 1, 3).contiguous().view(b * h, s, hd)


def attn_block(
    p: dict,
    x: torch.Tensor,  # [B, S, D] (already normed)
    cfg: ModelConfig,
    positions: torch.Tensor,  # [B, S]
    return_cache: bool = False,
    max_cache_len: int = 0,
    use_kernel: Optional[bool] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]]:
    """Full-sequence causal attention (train / prefill). `use_kernel` goes
    to `flash_attention`: None picks the path by device, False the plain
    version (training's, which carries gradients)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    h, hd = q.shape[2], q.shape[3]
    # query row b*H + h reads key/value row (b*H + h) // g = b*Hkv + h // g
    out = flash_attention(_heads_major(q), _heads_major(k), _heads_major(v),
                          causal=True, window=cfg.sliding_window, use_kernel=use_kernel)
    out = out.reshape(b, h, s, hd).permute(0, 2, 1, 3)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if not return_cache:
        return out
    # prefill: build the decode cache [B, W, Hkv, hd].
    #  * sliding window: keep the last W entries, rolled so that entry for
    #    absolute position p sits at ring slot p % W (decode convention);
    #  * full attention: pad to `max_cache_len` slots (decode budget).
    w = cfg.sliding_window
    if w and w < s:
        k, v = k[:, s - w:], v[:, s - w:]
        if s % w:
            k = torch.roll(k, s % w, dims=1)
            v = torch.roll(v, s % w, dims=1)
    elif max_cache_len and max_cache_len > k.shape[1]:
        pad = max_cache_len - k.shape[1]
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return out, (k, v)


def attn_decode(
    p: dict,
    x: torch.Tensor,  # [B, 1, D] (already normed)
    cfg: ModelConfig,
    cache_k: torch.Tensor,  # [B, W, Hkv, hd] ring buffer (keys stored roped)
    cache_v: torch.Tensor,
    pos: int,  # absolute position of the new token
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a (possibly ring-buffered) KV cache.

    The new key and value are written into `cache_k` / `cache_v` in place
    (the JAX version returns updated copies); both are returned.
    """
    b = x.shape[0]
    w = cache_k.shape[1]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    # the slot of the new entry, clamped into the buffer as
    # lax.dynamic_update_slice clamps its start index
    slot = min(pos % w if cfg.sliding_window else pos, w - 1)
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    # validity: ring slots written so far; keys keep absolute-position RoPE
    last = min(pos, w - 1) if cfg.sliding_window else pos
    mask = (torch.arange(w, device=x.device) <= last)[None, None, :]  # [1, 1, W]
    out = gqa_attention(q, cache_k, cache_v, mask)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return out, cache_k, cache_v


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(torch.einsum("bsd,df->bsf", x, p["w_gate"])) * torch.einsum(
        "bsd,df->bsf", x, p["w_up"]
    )
    return torch.einsum("bsf,fd->bsd", h, p["w_down"])


# --------------------------------------------------------------------------
# Mixture of Experts: capacity-based scatter dispatch.
# --------------------------------------------------------------------------


def moe_capacity(t: int, cfg: ModelConfig) -> int:
    """Slots per expert for a batch of `t` tokens (at least one)."""
    return max(int(math.ceil(t * cfg.experts_per_token / cfg.n_experts
                             * cfg.capacity_factor)), 1)


def moe_route(p: dict, xt: torch.Tensor, cfg: ModelConfig):
    """The router of `moe_block` over tokens xt [T, D]: (logits [T, E] and
    probs in float32, top_w and top_e [T, k], keep [T*k] (the assignment
    fits its expert's buffer) and target [T*k], its buffer row, E*cap for
    a dropped one). Assignments are counted token-major, so a token's
    slots come before the next token's."""
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = moe_capacity(xt.shape[0], cfg)
    logits = torch.einsum("td,de->te", xt, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = stable_topk(probs, k)  # [T, k], ties to the lowest expert
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # position of each (token, slot) assignment within its expert's buffer
    flat_e = top_e.reshape(-1)  # [T*k]
    onehot = F.one_hot(flat_e, e)  # [T*k, E]
    pos = torch.cumsum(onehot, dim=0) - onehot  # pre-count
    slot = torch.gather(pos, 1, flat_e[:, None])[:, 0]  # [T*k]
    keep = slot < cap
    target = torch.where(keep, flat_e * cap + slot, e * cap)  # overflow -> dropped row
    return logits, probs, top_w, top_e, keep, target


def moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed experts with capacity; returns (y, aux_loss).

    Dispatch is a scatter into per-expert buffers [E, C, D], the expert
    FFNs run as one batched einsum, and tokens gather their k expert
    outputs back. Capacity depends on the batch: T = B*S tokens share
    ceil(T*k/E * capacity_factor) slots an expert.
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    cap = moe_capacity(t, cfg)
    xt = x.reshape(t, d)
    logits, probs, top_w, top_e, keep, target = moe_route(p, xt, cfg)

    data = xt.repeat_interleave(k, dim=0) * keep[:, None].to(x.dtype)
    buffers = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buffers.index_add_(0, target, data)
    buf = buffers[: e * cap].reshape(e, cap, d)

    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w_gate"])) * torch.einsum(
        "ecd,edf->ecf", buf, p["w_up"]
    )
    out_buf = torch.einsum("ecf,efd->ecd", h, p["w_down"]).reshape(e * cap, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, d))], dim=0)

    gathered = out_buf[target]  # [T*k, D]
    w = (top_w.reshape(-1) * keep).to(x.dtype)
    y = (gathered * w[:, None]).reshape(t, k, d).sum(dim=1).reshape(b, s, d)

    # Switch-style load-balance loss + router z-loss
    frac_tokens = F.one_hot(top_e[:, 0], e).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    lb = e * (frac_tokens * frac_probs).sum() * cfg.load_balance_weight
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean() * cfg.router_z_weight
    return y, lb + z


# --------------------------------------------------------------------------
# Gated cross-attention (llama-3.2-vision style image layers).
# --------------------------------------------------------------------------


def cross_attn_block(
    p: dict,
    x: torch.Tensor,  # [B, S, D] text stream
    cfg: ModelConfig,
    img_k: torch.Tensor,  # [B, I, Hkv, hd] precomputed from patch embeddings
    img_v: torch.Tensor,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """x + tanh(g_a)*xattn + tanh(g_f)*ffn — the vision-conditioning layer.

    Every text position attends every image token: the flash-attention
    kernel with `causal=False` and no window, over heads-major copies of
    q and of the image K/V (S = 1 in decode). `use_kernel` as in
    `attn_block`."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    b, s, nh, hd = q.shape
    out = flash_attention(_heads_major(q), _heads_major(img_k), _heads_major(img_v),
                          causal=False, window=0, use_kernel=use_kernel)
    out = out.reshape(b, nh, s, hd).permute(0, 2, 1, 3)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    x = x + torch.tanh(p["gate_attn"]) * out
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + torch.tanh(p["gate_ffn"]) * swiglu(p["mlp"], h)


def cross_attn_kv(p: dict, img_embeds: torch.Tensor, cfg: ModelConfig):
    """Project (stubbed) vision-tower patch embeddings to K/V once."""
    k = torch.einsum("bid,dhk->bihk", img_embeds, p["wk"])
    v = torch.einsum("bid,dhk->bihk", img_embeds, p["wv"])
    return k, v
