"""Seq-sharded decode attention (flash-decoding combine) over "model".

Counterpart of `repro/models/decode_shard_map.py`, whose `shard_map` body
this runs on each rank. For architectures whose kv_heads don't divide the
"model" axis, the decode KV cache's SEQUENCE dim is sharded over "model"
(policy `tp_kvs`): each rank holds W/m cache slots of its rows of the
batch, and one-token attention runs as flash-decoding. Each rank computes a
partial (max, sum-exp, weighted-V) over its slots; the combine is a MAX
all-reduce of the local maxima, then two SUM all-reduces (denominator,
weighted V). Only the owner of the current ring slot writes the new key and
value; validity is in global slot coordinates.

`shard_decode_cache` cuts this rank's block out of a full decode cache
(`M.prefill`'s) by `decode_cache_specs`, and `gather_decode_cache` puts the
blocks together again.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.common import meshctx, sharding
from repro_torch.models.config import ModelConfig

__all__ = ["NEG", "attn_decode_seq_sharded", "decode_cache_specs", "shard_decode_cache",
           "gather_decode_cache"]

NEG = -2.0**30


def attn_decode_seq_sharded(
    cfg: ModelConfig,
    q: torch.Tensor,  # [B_l, 1, H, hd] (roped), this rank's rows
    k: torch.Tensor,  # [B_l, 1, Hkv, hd] (roped)
    v: torch.Tensor,  # [B_l, 1, Hkv, hd]
    cache_k: torch.Tensor,  # [B_l, W/m, Hkv, hd]: this rank's slots
    cache_v: torch.Tensor,
    pos: int,  # absolute position of the new token
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out [B_l, 1, H, hd], cache_k, cache_v) under the active mesh; the
    owner's cache slices are written in place and returned."""
    mesh = meshctx.current_mesh()
    w_local = cache_k.shape[1]
    w_global = w_local * mesh.shape["model"]
    hd = q.shape[-1]
    shard = mesh.axis_index("model")
    pos = int(pos)
    slot_g = pos % w_global if cfg.sliding_window else pos
    if slot_g // w_local == shard:  # only the ring slot's owner writes
        cache_k[:, slot_g % w_local] = k[:, 0]
        cache_v[:, slot_g % w_local] = v[:, 0]

    # validity in GLOBAL coordinates
    kidx = shard * w_local + torch.arange(w_local, device=q.device)
    limit = min(pos, w_global - 1) if cfg.sliding_window else pos
    valid = kidx <= limit  # [W/m]

    b, _, h, _ = q.shape
    hkv = cache_k.shape[2]
    qg = q.reshape(b, hkv, h // hkv, hd)
    logits = torch.einsum("bkgd,btkd->bkgt", qg, cache_k).float() / math.sqrt(hd)
    logits = torch.where(valid[None, None, None, :], logits, NEG)
    # flash-decoding combine across seq shards
    gmax = mesh.pmax(logits.amax(dim=-1, keepdim=True), "model")  # [B, Hkv, g, 1]
    p = torch.exp(logits - gmax)
    den = mesh.psum(p.sum(dim=-1, keepdim=True), "model")
    num = mesh.psum(torch.einsum("bkgt,btkd->bkgd", p.to(cache_v.dtype), cache_v), "model")
    out = (num / den.clamp_min(1e-30).to(num.dtype)).reshape(b, 1, h, hd)
    return out, cache_k, cache_v


def decode_cache_specs(cfg: ModelConfig, cache: Dict[str, torch.Tensor],
                       mesh: meshctx.Mesh) -> Dict[str, sharding.Spec]:
    """Each cache entry's spec on `mesh`: rows over the data axes that
    divide the batch; with `cfg.decode_attn == "seq_shard"` the attention
    K/V slots over "model". Raises when "model" does not divide W."""
    specs = {}
    for name, t in cache.items():
        batch = sharding.spec_for(("batch",), mesh.axis_names, (t.shape[1],),
                                  meshctx.axis_sizes_dict(mesh))[0]
        spec = [None, batch] + [None] * (t.dim() - 2)
        if (name in ("k", "v") and cfg.decode_attn == "seq_shard"
                and "model" in mesh.axis_names):
            m = mesh.shape["model"]
            if t.shape[2] % m:
                raise ValueError(f"cache slots {t.shape[2]} must divide over the model "
                                 f"axis {m}")
            spec[2] = "model"
        specs[name] = tuple(spec)
    return specs


def shard_decode_cache(cfg: ModelConfig, cache: Dict[str, torch.Tensor],
                       mesh: meshctx.Mesh) -> Dict[str, torch.Tensor]:
    """This rank's block of each entry of a full decode cache, copied: the
    decode writes its cache in place, so the full cache stays as it was
    (also where a block is the whole tensor)."""
    specs = decode_cache_specs(cfg, cache, mesh)
    return {n: sharding.local_shard(t, specs[n], mesh).clone(memory_format=torch.contiguous_format)
            for n, t in cache.items()}


def gather_decode_cache(cache: Dict[str, torch.Tensor], specs: Dict[str, sharding.Spec],
                        mesh: meshctx.Mesh) -> Dict[str, torch.Tensor]:
    """The full cache from every rank's block, by the specs
    `decode_cache_specs` gave the full cache (the inverse of
    `shard_decode_cache`)."""
    return {n: sharding.gather_shards(t, specs[n], mesh) for n, t in cache.items()}
