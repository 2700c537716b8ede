"""Backend model: spec construction + forward / prefill / decode programs.

Counterpart of `repro/models/model.py` for all six families (dense, moe,
ssm, hybrid, vlm, audio). Parameters keep the JAX package's tree: one dict
per kind, each leaf stacked over layers ([L, ...]; the VLM's cross layers
over their own stack [G, ...]), so `repro_torch.convert` carries a JAX
tree across as it is. A Python loop over layers replaces `lax.scan`; the
VLM runs groups of `cross_attn_every - 1` self layers, then one cross
layer, self layer j of group g being stacked row g*(cross_attn_every-1)+j.

Program surface:
  init(cfg, generator, device)                 — params
  forward(cfg, params, batch, use_kernel)      — logits [B,S,(K,)V], aux loss
  loss_fn(cfg, params, batch) -> (loss, metrics)  — training's, differentiable
  prefill(cfg, params, batch) -> (logits, cache)
  decode_step(cfg, params, cache, batch)       — updates `cache` in place
The VLM's batches carry "image_embeds" [B, I, d_model] (the stubbed
vision tower's patch embeddings); codebook models take tokens [B, S, K].

Under an active mesh (`common.meshctx.use_mesh`) every rank runs these
programs on its rows of the batch: `cfg.moe_impl == "shard_map"` takes the
expert-parallel MoE (`moe_shard_map`) and `cfg.decode_attn == "seq_shard"`
the seq-sharded decode attention (`decode_shard_map`), as the reference
picks them. The programs also run on DTensors (the dry-run,
`launch/dryrun.py`): the reference's sharding constraints are
`common.sharding.logical_constraint` calls, no-ops on plain tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.common import sharding as shard_lib
from repro_torch.common.sharding import logical_constraint as shard
from repro_torch.models import layers as lyr
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe_shard_map import moe_block_shard_map
from repro_torch.models.params import ParamSpec as PS
from repro_torch.models.params import init_params

__all__ = [
    "make_specs",
    "init",
    "attention_at_d_model_fan_in",
    "open_cross_gates",
    "forward",
    "loss_fn",
    "prefill",
    "decode_step",
    "cache_spec",
]


# ============================================================ spec building
def _attn_specs(cfg: ModelConfig, n: int, stack_axis: str = "layers") -> Dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = {
        "wq": PS((n, d, h, hd), (stack_axis, "embed", "heads", None)),
        "wk": PS((n, d, hkv, hd), (stack_axis, "embed", "kv_heads", None)),
        "wv": PS((n, d, hkv, hd), (stack_axis, "embed", "kv_heads", None)),
        "wo": PS((n, h, hd, d), (stack_axis, "heads", None, "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = PS((n, h, hd), (stack_axis, "heads", None), "zeros")
        s["bk"] = PS((n, hkv, hd), (stack_axis, "kv_heads", None), "zeros")
        s["bv"] = PS((n, hkv, hd), (stack_axis, "kv_heads", None), "zeros")
    return s


def _mlp_specs(cfg: ModelConfig, n: int, stack_axis="layers"):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": PS((n, d, f), (stack_axis, "embed", "ff")),
        "w_up": PS((n, d, f), (stack_axis, "embed", "ff")),
        "w_down": PS((n, f, d), (stack_axis, "ff", "embed")),
    }


def _moe_specs(cfg: ModelConfig, n: int):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_ff
    return {
        "router": PS((n, d, e), ("layers", "embed", None)),
        "w_gate": PS((n, e, d, f), ("layers", "experts", "embed", "ff")),
        "w_up": PS((n, e, d, f), ("layers", "experts", "embed", "ff")),
        "w_down": PS((n, e, f, d), ("layers", "experts", "ff", "embed")),
    }


def _ssm_specs(cfg: ModelConfig, n: int):
    d, di = cfg.d_model, cfg.d_inner
    gn = cfg.ssm_n_groups * cfg.ssm_state
    h = cfg.ssm_heads
    dproj = 2 * di + 2 * gn + h
    conv_c = di + 2 * gn
    k = cfg.ssm_conv_width
    return {
        "in_proj": PS((n, d, dproj), ("layers", "embed", None)),
        "conv_w": PS((n, k, conv_c), ("layers", None, None)),
        "conv_b": PS((n, conv_c), ("layers", None), "zeros"),
        "a_log": PS((n, h), ("layers", "ssm_heads"), "zeros"),
        "d_skip": PS((n, h), ("layers", "ssm_heads"), "ones"),
        "dt_bias": PS((n, h), ("layers", "ssm_heads"), "zeros"),
        "norm": PS((n, di), ("layers", None), "ones"),
        "out_proj": PS((n, di, d), ("layers", None, "embed")),
    }


def _n_cross(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.cross_attn_every if cfg.cross_attn_every else 0


def make_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab_size
    n_cross = _n_cross(cfg)
    n_self = cfg.n_layers - n_cross
    kb = cfg.n_codebooks or 1

    specs: Dict[str, Any] = {
        "embed": PS((kb * v, d), ("vocab", "embed"), "embed"),
        "ln_f": PS((d,), (None,), "ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = PS((d, kb * v), ("embed", "vocab"))

    layer: Dict[str, Any] = {"ln1": PS((n_self, d), ("layers", None), "ones")}
    if cfg.arch_type == "ssm":
        layer["ssm"] = _ssm_specs(cfg, n_self)
    else:
        layer["attn"] = _attn_specs(cfg, n_self)
        layer["ln2"] = PS((n_self, d), ("layers", None), "ones")
        if cfg.arch_type == "moe":
            layer["moe"] = _moe_specs(cfg, n_self)
            if cfg.dense_residual:
                layer["mlp"] = _mlp_specs(cfg, n_self)
        else:
            layer["mlp"] = _mlp_specs(cfg, n_self)
        if cfg.hybrid:
            layer["ssm"] = _ssm_specs(cfg, n_self)
    specs["layers"] = layer

    if n_cross:
        specs["cross"] = {
            **_attn_specs(cfg, n_cross, "stack"),
            "ln1": PS((n_cross, d), ("stack", None), "ones"),
            "ln2": PS((n_cross, d), ("stack", None), "ones"),
            "gate_attn": PS((n_cross,), ("stack",), "zeros"),
            "gate_ffn": PS((n_cross,), ("stack",), "zeros"),
            "mlp": _mlp_specs(cfg, n_cross, stack_axis="stack"),
        }
    return specs


def init(
    cfg: ModelConfig,
    generator: torch.Generator,
    device: Union[str, torch.device, None] = None,
) -> Dict[str, Any]:
    """Parameters in `cfg.dtype`, drawn from `generator` (on `device`)."""
    return init_params(make_specs(cfg), generator, dtype=cfg.dtype, device=device)


def attention_at_d_model_fan_in(cfg: ModelConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """`params` with wq, wk and wv rescaled from the heads-axis fan-in to d_model's.

    `init`, like the JAX package's, scales the [L, d, heads, hd] projections
    by the fan-in of the heads axis (their `fan_in_dims` is (-2,)), not of
    the contracted d_model axis: at hymba-1.5b's width wq is 8x and wk, wv
    18x too large, and a 2,048-token prompt's attention logits reach ~1,000
    (ROADMAP.md queue 3). The VLM's cross stack has the same fault and is
    rescaled too. This returns a new tree with unit-scale logits; the other
    leaves are shared. Works on a tree of torch tensors or of numpy / JAX
    arrays, so a parity test can rescale the JAX tree before carrying it
    across.
    """
    def rescaled(attn):
        attn = dict(attn)
        for name in ("wq", "wk", "wv"):
            attn[name] = attn[name] * (attn[name].shape[-2] / cfg.d_model) ** 0.5
        return attn

    out = dict(params)
    if "attn" in params["layers"]:
        out["layers"] = {**params["layers"], "attn": rescaled(params["layers"]["attn"])}
    if "cross" in params:
        out["cross"] = rescaled(params["cross"])
    return out


def open_cross_gates(cfg: ModelConfig, params: Dict[str, Any], seed: int = 0) -> Dict[str, Any]:
    """`params` with the VLM's cross-layer gates set to seeded values in
    [0.5, 1.5) (tanh 0.46-0.91). `init` zeroes `gate_attn` and `gate_ffn`,
    as the reference does, and tanh(0) = 0 makes every cross layer the
    identity: a check of the cross-attention needs them open. Works on a
    tree of torch tensors or of numpy / JAX arrays, like
    `attention_at_d_model_fan_in`; the other leaves are shared."""
    if "cross" not in params:
        return params
    values = np.random.default_rng(seed).uniform(0.5, 1.5, (2, _n_cross(cfg))).astype(np.float32)
    cross = dict(params["cross"])
    for name, vals in zip(("gate_attn", "gate_ffn"), values):
        gate = cross[name]
        if isinstance(gate, torch.Tensor):
            cross[name] = torch.as_tensor(vals, device=gate.device).to(gate.dtype)
        else:
            cross[name] = (gate * 0 + vals).astype(gate.dtype)
    return {**params, "cross": cross}


def _layer(tree: Any, i: int) -> Any:
    """Layer `i`'s views of a tree of layer-stacked tensors."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ============================================================== embedding
def _embed_tokens(cfg: ModelConfig, params, batch) -> torch.Tensor:
    tokens = batch["tokens"].long()
    if cfg.n_codebooks:
        # musicgen: sum the K codebook embeddings (tokens [B, S, K])
        offsets = torch.arange(cfg.n_codebooks, device=tokens.device) * cfg.vocab_size
        tokens = tokens + offsets
    x = shard_lib.lookup_rows(params["embed"], tokens)
    if cfg.n_codebooks:
        x = x.sum(dim=2)
    return shard(x, "batch", "act_seq", None)


def _logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    x = lyr.rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = shard_lib.project("bsd,dv->bsv", x, head)
    if cfg.n_codebooks:
        logits = shard_lib.unflatten(logits, 2, (cfg.n_codebooks, cfg.vocab_size))
    return logits


# =============================================================== layer body
def _ffn(cfg: ModelConfig, lp, x):
    """The layer's second half: x + MLP or MoE of its norm; (x, aux)."""
    h = lyr.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.arch_type != "moe":
        return x + lyr.swiglu(lp["mlp"], h), None
    moe_fn = moe_block_shard_map if cfg.moe_impl == "shard_map" else lyr.moe_block
    y, aux = moe_fn(lp["moe"], h, cfg)
    if cfg.dense_residual:
        y = y + lyr.swiglu(lp["mlp"], h)
    return x + y, aux


def _self_layer(cfg: ModelConfig, lp, x, positions, max_cache_len: int = 0,
                return_cache: bool = False, use_kernel: Optional[bool] = None):
    """One decoder layer over the full sequence; (x, cache entries or {},
    the MoE aux loss or None). `use_kernel` goes to the attention and the
    SSD scan (None: by device; False: the plain versions)."""
    out_cache: Dict[str, torch.Tensor] = {}
    h = lyr.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.arch_type == "ssm":
        if not return_cache:
            return (x + ssm_lib.ssm_block(lp["ssm"], h, cfg, use_kernel=use_kernel),
                    out_cache, None)
        out, (out_cache["conv"], out_cache["state"]) = ssm_lib.ssm_block(
            lp["ssm"], h, cfg, return_cache=True, use_kernel=use_kernel)
        return x + out, out_cache, None
    if return_cache:
        attn_out, (out_cache["k"], out_cache["v"]) = lyr.attn_block(
            lp["attn"], h, cfg, positions, return_cache=True, max_cache_len=max_cache_len,
            use_kernel=use_kernel)
    else:
        attn_out = lyr.attn_block(lp["attn"], h, cfg, positions, use_kernel=use_kernel)
    if cfg.hybrid:
        if return_cache:
            s_out, (out_cache["conv"], out_cache["state"]) = ssm_lib.ssm_block(
                lp["ssm"], h, cfg, return_cache=True, use_kernel=use_kernel)
        else:
            s_out = ssm_lib.ssm_block(lp["ssm"], h, cfg, use_kernel=use_kernel)
        attn_out = 0.5 * (attn_out + s_out)
    x, aux = _ffn(cfg, lp, x + attn_out)
    return x, out_cache, aux


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int64, device=device)[None].expand(b, s)


def _stack_order(cfg: ModelConfig):
    """The layer stack in order: ("self", stacked row) and, for the VLM,
    ("cross", group) after each group of cross_attn_every - 1 self layers."""
    if not cfg.cross_attn_every:
        return [("self", i) for i in range(cfg.n_layers)]
    per = cfg.cross_attn_every - 1
    order = []
    for g in range(_n_cross(cfg)):
        order += [("self", g * per + j) for j in range(per)] + [("cross", g)]
    return order


def _cross_kv_all(cfg: ModelConfig, params, img_embeds):
    """Project patch embeddings to per-cross-layer K/V: [G, B, I, Hkv, hd]."""
    cross = params["cross"]
    kv = [lyr.cross_attn_kv({"wk": cross["wk"][g], "wv": cross["wv"][g]}, img_embeds, cfg)
          for g in range(_n_cross(cfg))]
    return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])


# ================================================================= programs
def forward(cfg: ModelConfig, params, batch,
            use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward: logits [B,S,(K,)V], the MoE aux loss summed
    over layers (0 without MoE).

    `use_kernel` goes to every attention and SSD scan: None picks the
    hand-written kernels on the card and the plain versions on the CPU;
    False takes the plain versions on any device, which gradients need
    (the kernels have no backward and raise on grad-requiring inputs).
    With `cfg.remat` each self layer runs under
    `torch.utils.checkpoint.checkpoint` (non-reentrant), as the reference
    wraps its scan body in `jax.checkpoint`: its activations are
    recomputed in the backward pass instead of kept, and no value changes.
    """
    x = _embed_tokens(cfg, params, batch)
    b, s = x.shape[:2]
    positions = _positions(b, s, x.device)
    if cfg.cross_attn_every:
        img_k, img_v = _cross_kv_all(cfg, params, batch["image_embeds"].to(x.dtype))

    def self_layer(lp, x):
        y, _, layer_aux = _self_layer(cfg, lp, x, positions, use_kernel=use_kernel)
        return y, layer_aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, i in _stack_order(cfg):
        if kind == "cross":
            x = lyr.cross_attn_block(_layer(params["cross"], i), x, cfg, img_k[i], img_v[i],
                                     use_kernel=use_kernel)
            continue
        lp = _layer(params["layers"], i)
        if cfg.remat:
            x, layer_aux = torch.utils.checkpoint.checkpoint(self_layer, lp, x,
                                                             use_reentrant=False)
        else:
            x, layer_aux = self_layer(lp, x)
        if layer_aux is not None:
            aux = aux + layer_aux
    return _logits(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Shifted next-token cross-entropy in float32 plus `forward`'s aux loss:
    (loss, {"ce", "aux", "loss"}), 0-dim float32 tensors. Codebook logits
    [B, S, K, V] take targets [B, S-1, K]. The forward takes the plain
    attention and scan (`use_kernel=False`), so the loss differentiates on
    any device, as the reference's does."""
    logits, aux = forward(cfg, params, batch, use_kernel=False)
    targets = batch["tokens"][:, 1:].long()
    ce = shard_lib.token_nll(logits[:, :-1], targets).mean()
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}


# ---------------------------------------------------------------- caching
def cache_spec(cfg: ModelConfig, batch_size: int, seq_len: int) -> Dict[str, Any]:
    """Shapes+logical axes of the decode cache for (batch, context length)."""
    w = min(cfg.sliding_window, seq_len) if cfg.sliding_window else seq_len
    n_cross = _n_cross(cfg)
    n_self = cfg.n_layers - n_cross
    spec: Dict[str, Any] = {}
    if cfg.has_attention:
        spec["k"] = PS(
            (n_self, batch_size, w, cfg.n_kv_heads, cfg.hd),
            ("layers", "batch", "kv_seq", "kv_heads", None),
            "zeros",
        )
        spec["v"] = dataclasses.replace(spec["k"])
    if cfg.has_ssm:
        conv_c = cfg.d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state
        spec["conv"] = PS(
            (n_self, batch_size, cfg.ssm_conv_width - 1, conv_c),
            ("layers", "batch", None, None),
            "zeros",
        )
        spec["state"] = PS(
            (n_self, batch_size, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            ("layers", "batch", "ssm_heads", None, "state"),
            "zeros",
        )
    if n_cross:
        spec["img_k"] = PS(
            (n_cross, batch_size, cfg.n_image_tokens, cfg.n_kv_heads, cfg.hd),
            ("stack", "batch", "image", "kv_heads", None),
            "zeros",
        )
        spec["img_v"] = dataclasses.replace(spec["img_k"])
    return spec


def prefill(
    cfg: ModelConfig, params, batch, max_cache_len: int = 0,
    use_kernel: Optional[bool] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process the full prompt; return last-position logits + decode cache.

    `max_cache_len` sizes the full-attention KV cache for subsequent decode
    steps (defaults to prompt length + 1; windowed/SSM caches are fixed-size).
    `use_kernel` as in `forward`.
    Cache entries are stacked over self layers: [L_self, B, ...]; the VLM's
    `img_k` / `img_v` over cross layers: [G, B, I, Hkv, hd].
    """
    x = _embed_tokens(cfg, params, batch)
    b, s = x.shape[:2]
    max_cache_len = max_cache_len or (s + 1)
    positions = _positions(b, s, x.device)
    cache: Dict[str, torch.Tensor] = {}
    if cfg.cross_attn_every:
        cache["img_k"], cache["img_v"] = _cross_kv_all(
            cfg, params, batch["image_embeds"].to(x.dtype))
    per_layer: Dict[str, list] = {}
    for kind, i in _stack_order(cfg):
        if kind == "cross":
            x = lyr.cross_attn_block(_layer(params["cross"], i), x, cfg,
                                     cache["img_k"][i], cache["img_v"][i],
                                     use_kernel=use_kernel)
            continue
        x, entries, _ = _self_layer(cfg, _layer(params["layers"], i), x, positions,
                                    max_cache_len=max_cache_len, return_cache=True,
                                    use_kernel=use_kernel)
        for k, v in entries.items():
            per_layer.setdefault(k, []).append(v)
    cache.update({k: torch.stack(v) for k, v in per_layer.items()})
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params, cache, batch,
                use_kernel: Optional[bool] = None):
    """One-token decode. batch = {"token": [B,1(,K)], "pos": int}.

    Returns (logits [B,1,(K,)V], cache). The cache's tensors are updated in
    place and returned in the same dict (the JAX version returns copies);
    the VLM's `img_k` / `img_v` are read, never written. `use_kernel` goes
    to the cross layers' attention, as in `forward` (the self layers'
    decode attention is always the plain one).
    """
    x = _embed_tokens(cfg, params, {"tokens": batch["token"]})
    pos = int(batch["pos"])
    for kind, i in _stack_order(cfg):
        if kind == "cross":
            x = lyr.cross_attn_block(_layer(params["cross"], i), x, cfg,
                                     cache["img_k"][i], cache["img_v"][i],
                                     use_kernel=use_kernel)
            continue
        lp = _layer(params["layers"], i)
        lc = {k: v[i] for k, v in cache.items() if k not in ("img_k", "img_v")}
        h = lyr.rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.arch_type == "ssm":
            out, _, _ = ssm_lib.ssm_decode(lp["ssm"], h, cfg, lc["conv"], lc["state"])
            x = x + out
            continue
        attn_out, _, _ = lyr.attn_decode(lp["attn"], h, cfg, lc["k"], lc["v"], pos)
        if cfg.hybrid:
            s_out, _, _ = ssm_lib.ssm_decode(lp["ssm"], h, cfg, lc["conv"], lc["state"])
            attn_out = 0.5 * (attn_out + s_out)
        x, _ = _ffn(cfg, lp, x + attn_out)
    return _logits(cfg, params, x), cache
