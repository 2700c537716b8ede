"""Transformer building blocks: RMSNorm, RoPE, GQA attention (full causal /
sliding window / decode), the SwiGLU MLP, capacity-based MoE and gated
cross-attention.

Counterpart of `repro/models/layers.py`, with the same shapes and casts.
Parameters arrive as sub-dicts of the trees made in `repro_torch.models.
model`. Activation sharding goes through `common.sharding.
logical_constraint` at the reference's points, with its logical axes: a
no-op on plain tensors and outside a mesh, a redistribution of a DTensor
under one (the dry-run, `launch/dryrun.py`); under a mesh, `attn_decode`
hands seq-sharded decode to `decode_shard_map`.

Attention has two paths. The kernel path (`use_kernel=True`, or None on
the card) hands heads-major copies to
`kernels.flash_attention.ops.flash_attention`, the hand-written kernel,
which computes what `gqa_attention` computes under the same mask. The
plain path (`use_kernel=False`, or None on the CPU) is the reference's:
`gqa_attention` on [B, S, H, hd] under the kernel's own `attention_mask` (the cross layer's
all-ones mask), which keeps the batch and heads dimensions apart, as a
DTensor sharded on both needs. Single-token decode (`attn_decode`) always
takes `gqa_attention` over its ring-buffer mask, as the JAX decode runs
outside any Pallas kernel. `moe_block` keeps the reference's
capacity-based scatter dispatch, its router top-k in `lax.top_k`'s tie
order (`stable_topk`) and its expert products as batched einsums.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.common import meshctx
from repro_torch.common import sharding as shard_lib
from repro_torch.common.sharding import logical_constraint as shard
from repro_torch.common.sharding import blockwise, project
from repro_torch.core.retrieval import stable_topk
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_mask
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


def _repeat_heads(t: torch.Tensor, g: int) -> torch.Tensor:
    """[B, T, Hkv, hd] -> [B, T, Hkv*g, hd], each KV head g times in a row
    (`jnp.repeat(t, g, axis=2)`), as an expand and a reshape, which DTensor
    partitions without gathering the batch."""
    b, t_len, hkv, hd = t.shape
    return t[:, :, :, None, :].expand(b, t_len, hkv, g, hd).reshape(b, t_len, hkv * g, hd)


def gqa_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, T, Hkv, hd]
    v: torch.Tensor,  # [B, T, Hkv, hd]
    mask: torch.Tensor,  # [B or 1, S, T] boolean (True = attend)
    repeat_kv: bool = False,
) -> torch.Tensor:
    """Grouped-query attention. `repeat_kv` materialises K and V per q head
    first (the reference's `repeat_kv` form), so that they shard over the
    heads with q where the KV heads cannot. Rows and heads are independent,
    so on DTensors each rank attends its block (`sharding.blockwise`; the
    mask is whole)."""
    g = q.shape[2] // k.shape[2]
    if repeat_kv and g > 1:
        k = shard(_repeat_heads(k, g), "batch", None, "heads", None)
        v = shard(_repeat_heads(v, g), "batch", None, "heads", None)
    # K and V split over the mesh axes of q's heads (blockwise raises where
    # the KV heads cannot follow: then repeat_kv)
    axes = ("batch", None, "heads", None)
    return blockwise(_attend, (q, k, v, mask), (axes, axes, axes, None), (axes,))


def _attend(q, k, v, mask):
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / math.sqrt(hd)
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, hd)


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    q = project("bsd,dhk->bshk", x, p["wq"])  # [B,S,H,hd]
    k = project("bsd,dhk->bshk", x, p["wk"])  # [B,S,Hkv,hd]
    v = project("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = shard(rope(q, positions, cfg.rope_theta), "batch", None, "heads", None)
    k = shard(rope(k, positions, cfg.rope_theta), "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)
    return q, k, v


def _kernel_path(use_kernel: Optional[bool], x: torch.Tensor) -> bool:
    """`use_kernel` resolved: None takes the kernel on the card only (the
    kernel op raises for any other device)."""
    return x.device.type == "cuda" if use_kernel is None else bool(use_kernel)


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
    """Full-sequence causal attention (train / prefill). `use_kernel`: True
    takes the flash-attention kernel, False the plain `gqa_attention`
    (training's, which carries gradients), None the kernel on the card."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    h, hd = q.shape[2], q.shape[3]
    if _kernel_path(use_kernel, x):
        # query row b*H + h reads key/value row (b*H + h) // g = b*Hkv + h // g
        out = flash_attention(_heads_major(q), _heads_major(k), _heads_major(v),
                              causal=True, window=cfg.sliding_window, use_kernel=True)
        out = out.reshape(b, h, s, hd).permute(0, 2, 1, 3)
    else:
        mask = attention_mask(s, s, True, cfg.sliding_window, 0, x.device)[None]
        out = gqa_attention(q, k, v, mask, repeat_kv=cfg.repeat_kv)
    out = shard(project("bshk,hkd->bsd", out, p["wo"]), "batch", "act_seq", None)
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
    (the JAX version returns updated copies); both are returned. With
    `cfg.decode_attn == "seq_shard"` under a mesh with a "model" axis, the
    cache holds this rank's W/m slots and `decode_shard_map` attends.
    """
    b = x.shape[0]
    w = cache_k.shape[1]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    if cfg.decode_attn == "seq_shard":
        mesh = meshctx.current_mesh()
        if mesh is not None and "model" in mesh.axis_names:
            from repro_torch.models.decode_shard_map import attn_decode_seq_sharded

            out, cache_k, cache_v = attn_decode_seq_sharded(
                cfg, q, k, v, cache_k, cache_v, pos)
            out = project("bshk,hkd->bsd", out, p["wo"])
            return shard(out, "batch", None, None), cache_k, cache_v
    # the slot of the new entry, clamped into the buffer as
    # lax.dynamic_update_slice clamps its start index
    slot = min(pos % w if cfg.sliding_window else pos, w - 1)
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    # validity: ring slots written so far; keys keep absolute-position RoPE
    last = min(pos, w - 1) if cfg.sliding_window else pos
    mask = (torch.arange(w, device=x.device) <= last)[None, None, :]  # [1, 1, W]
    out = gqa_attention(q, cache_k, cache_v, mask, repeat_kv=cfg.repeat_kv)
    out = project("bshk,hkd->bsd", out, p["wo"])
    return shard(out, "batch", None, None), cache_k, cache_v


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(project("bsd,df->bsf", x, p["w_gate"])) * project("bsd,df->bsf", x, p["w_up"])
    h = shard(h, "batch", None, "ff")
    return shard(project("bsf,fd->bsd", h, p["w_down"]), "batch", "act_seq", None)


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
    buffers = shard_lib.scatter_rows(e * cap + 1, target, data)
    buf = shard(buffers[: e * cap].reshape(e, cap, d), "experts", None, None)

    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w_gate"])) * torch.einsum(
        "ecd,edf->ecf", buf, p["w_up"]
    )
    h = shard(h, "experts", None, "ff")
    out_buf = torch.einsum("ecf,efd->ecd", h, p["w_down"]).reshape(e * cap, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, d))], dim=0)
    # the gather-back reads global rows of the expert-sharded buffer: the
    # reference pins it replicated first, and so does the port
    out_buf = shard(out_buf, None, None)

    gathered = out_buf[target]  # [T*k, D]
    w = (top_w.reshape(-1) * keep).to(x.dtype)
    y = (gathered * w[:, None]).reshape(t, k, d).sum(dim=1).reshape(b, s, d)
    y = shard(y, "batch", "act_seq", None)

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

    Every text position attends every image token (S = 1 in decode): on
    the kernel path the flash-attention kernel with `causal=False` and no
    window over heads-major copies of q and of the image K/V, on the plain
    path `gqa_attention` under an all-ones mask. `use_kernel` as in
    `attn_block`."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = shard(project("bsd,dhk->bshk", h, p["wq"]), "batch", None, "heads", None)
    b, s, nh, hd = q.shape
    if _kernel_path(use_kernel, x):
        out = flash_attention(_heads_major(q), _heads_major(img_k), _heads_major(img_v),
                              causal=False, window=0, use_kernel=True)
        out = out.reshape(b, nh, s, hd).permute(0, 2, 1, 3)
    else:
        mask = torch.ones((1, s, img_k.shape[1]), dtype=torch.bool, device=x.device)
        out = gqa_attention(q, img_k, img_v, mask, repeat_kv=cfg.repeat_kv)
    out = project("bshk,hkd->bsd", out, p["wo"])
    x = x + torch.tanh(p["gate_attn"]) * out
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + torch.tanh(p["gate_ffn"]) * swiglu(p["mlp"], h)


def cross_attn_kv(p: dict, img_embeds: torch.Tensor, cfg: ModelConfig):
    """Project (stubbed) vision-tower patch embeddings to K/V once."""
    k = project("bid,dhk->bihk", img_embeds, p["wk"])
    v = project("bid,dhk->bihk", img_embeds, p["wv"])
    return shard(k, "batch", None, "kv_heads", None), shard(v, "batch", None, "kv_heads", None)
