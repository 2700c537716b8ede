"""Backend model: spec construction + forward / prefill / decode programs.

Counterpart of `repro/models/model.py` for the dense, ssm and hybrid
families. Parameters keep the JAX package's tree: one dict per kind, each
leaf stacked over layers ([L, ...]), so `repro_torch.convert` carries a JAX
tree across as it is. A Python loop over layers replaces `lax.scan`.
Every entry point raises `NotImplementedError` for moe, vlm and audio
configs, whose layers are not ported yet (ROADMAP.md queue 1, item 8),
and `loss_fn` waits for the training slice.

Program surface:
  init(cfg, generator, device)                 — params
  forward(cfg, params, batch)                  — logits [B,S,V], aux loss
  prefill(cfg, params, batch) -> (logits, cache)
  decode_step(cfg, params, cache, batch)       — updates `cache` in place
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import torch

from repro_torch.models import layers as lyr
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec as PS
from repro_torch.models.params import init_params

__all__ = [
    "make_specs",
    "init",
    "attention_at_d_model_fan_in",
    "forward",
    "prefill",
    "decode_step",
    "cache_spec",
    "check_supported",
]


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for the families the port does not run yet."""
    if cfg.arch_type not in ("dense", "ssm") or cfg.cross_attn_every or cfg.n_codebooks:
        raise NotImplementedError(
            f"{cfg.name}: arch_type {cfg.arch_type!r} (MoE, cross-attention and "
            f"codebook layers) is not ported to repro_torch yet; see ROADMAP.md "
            f"queue 1, item 8"
        )


# ============================================================ spec building
def _attn_specs(cfg: ModelConfig, n: int) -> Dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = {
        "wq": PS((n, d, h, hd), ("layers", "embed", "heads", None)),
        "wk": PS((n, d, hkv, hd), ("layers", "embed", "kv_heads", None)),
        "wv": PS((n, d, hkv, hd), ("layers", "embed", "kv_heads", None)),
        "wo": PS((n, h, hd, d), ("layers", "heads", None, "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = PS((n, h, hd), ("layers", "heads", None), "zeros")
        s["bk"] = PS((n, hkv, hd), ("layers", "kv_heads", None), "zeros")
        s["bv"] = PS((n, hkv, hd), ("layers", "kv_heads", None), "zeros")
    return s


def _mlp_specs(cfg: ModelConfig, n: int):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": PS((n, d, f), ("layers", "embed", "ff")),
        "w_up": PS((n, d, f), ("layers", "embed", "ff")),
        "w_down": PS((n, f, d), ("layers", "ff", "embed")),
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


def make_specs(cfg: ModelConfig) -> Dict[str, Any]:
    check_supported(cfg)
    d, v, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    specs: Dict[str, Any] = {
        "embed": PS((v, d), ("vocab", "embed"), "embed"),
        "ln_f": PS((d,), (None,), "ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = PS((d, v), ("embed", "vocab"))

    layer: Dict[str, Any] = {"ln1": PS((L, d), ("layers", None), "ones")}
    if cfg.arch_type == "ssm":
        layer["ssm"] = _ssm_specs(cfg, L)
    else:
        layer["attn"] = _attn_specs(cfg, L)
        layer["ln2"] = PS((L, d), ("layers", None), "ones")
        layer["mlp"] = _mlp_specs(cfg, L)
        if cfg.hybrid:
            layer["ssm"] = _ssm_specs(cfg, L)
    specs["layers"] = layer
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
    (ROADMAP.md queue 3). This returns a new tree with unit-scale logits;
    the other leaves are shared. Works on a tree of torch tensors or of
    numpy / JAX arrays, so a parity test can rescale the JAX tree before
    carrying it across.
    """
    if "attn" not in params["layers"]:
        return params
    attn = dict(params["layers"]["attn"])
    for name in ("wq", "wk", "wv"):
        attn[name] = attn[name] * (attn[name].shape[-2] / cfg.d_model) ** 0.5
    return {**params, "layers": {**params["layers"], "attn": attn}}


def _layer(tree: Any, i: int) -> Any:
    """Layer `i`'s views of a tree of layer-stacked tensors."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ============================================================== embedding
def _embed_tokens(cfg: ModelConfig, params, batch) -> torch.Tensor:
    return params["embed"][batch["tokens"].long()]


def _logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    x = lyr.rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,dv->bsv", x, head)


# =============================================================== layer body
def _self_layer(cfg: ModelConfig, lp, x, positions, max_cache_len: int = 0,
                return_cache: bool = False):
    """One decoder layer over the full sequence; (x, cache entries or {})."""
    out_cache: Dict[str, torch.Tensor] = {}
    h = lyr.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.arch_type == "ssm":
        if not return_cache:
            return x + ssm_lib.ssm_block(lp["ssm"], h, cfg), out_cache
        out, (out_cache["conv"], out_cache["state"]) = ssm_lib.ssm_block(
            lp["ssm"], h, cfg, return_cache=True)
        return x + out, out_cache
    if return_cache:
        attn_out, (out_cache["k"], out_cache["v"]) = lyr.attn_block(
            lp["attn"], h, cfg, positions, return_cache=True, max_cache_len=max_cache_len)
    else:
        attn_out = lyr.attn_block(lp["attn"], h, cfg, positions)
    if cfg.hybrid:
        if return_cache:
            s_out, (out_cache["conv"], out_cache["state"]) = ssm_lib.ssm_block(
                lp["ssm"], h, cfg, return_cache=True)
        else:
            s_out = ssm_lib.ssm_block(lp["ssm"], h, cfg)
        attn_out = 0.5 * (attn_out + s_out)
    x = x + attn_out
    h = lyr.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + lyr.swiglu(lp["mlp"], h), out_cache


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int64, device=device)[None].expand(b, s)


# ================================================================= programs
def forward(cfg: ModelConfig, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward: logits [B,S,V], aux loss (0: no MoE here)."""
    check_supported(cfg)
    x = _embed_tokens(cfg, params, batch)
    b, s = x.shape[:2]
    positions = _positions(b, s, x.device)
    for i in range(cfg.n_layers):
        x, _ = _self_layer(cfg, _layer(params["layers"], i), x, positions)
    return _logits(cfg, params, x), torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------- caching
def cache_spec(cfg: ModelConfig, batch_size: int, seq_len: int) -> Dict[str, Any]:
    """Shapes+logical axes of the decode cache for (batch, context length)."""
    check_supported(cfg)
    w = min(cfg.sliding_window, seq_len) if cfg.sliding_window else seq_len
    n_self = cfg.n_layers
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
    return spec


def prefill(
    cfg: ModelConfig, params, batch, max_cache_len: int = 0
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process the full prompt; return last-position logits + decode cache.

    `max_cache_len` sizes the full-attention KV cache for subsequent decode
    steps (defaults to prompt length + 1; windowed/SSM caches are fixed-size).
    Cache entries are stacked over layers: [L, B, ...].
    """
    check_supported(cfg)
    x = _embed_tokens(cfg, params, batch)
    b, s = x.shape[:2]
    max_cache_len = max_cache_len or (s + 1)
    positions = _positions(b, s, x.device)
    per_layer: Dict[str, list] = {}
    for i in range(cfg.n_layers):
        x, entries = _self_layer(cfg, _layer(params["layers"], i), x, positions,
                                 max_cache_len=max_cache_len, return_cache=True)
        for k, v in entries.items():
            per_layer.setdefault(k, []).append(v)
    cache = {k: torch.stack(v) for k, v in per_layer.items()}
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params, cache, batch):
    """One-token decode. batch = {"token": [B,1], "pos": int}.

    Returns (logits [B,1,V], cache). The cache's tensors are updated in
    place and returned in the same dict (the JAX version returns copies).
    """
    check_supported(cfg)
    x = _embed_tokens(cfg, params, {"tokens": batch["token"]})
    pos = int(batch["pos"])
    for i in range(cfg.n_layers):
        lp, lc = _layer(params["layers"], i), _layer(cache, i)
        h = lyr.rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.arch_type == "ssm":
            out, _, _ = ssm_lib.ssm_decode(lp["ssm"], h, cfg, lc["conv"], lc["state"])
            x = x + out
            continue
        attn_out, _, _ = lyr.attn_decode(lp["attn"], h, cfg, lc["k"], lc["v"], pos)
        if cfg.hybrid:
            s_out, _, _ = ssm_lib.ssm_decode(lp["ssm"], h, cfg, lc["conv"], lc["state"])
            attn_out = 0.5 * (attn_out + s_out)
        x = x + attn_out
        h2 = lyr.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + lyr.swiglu(lp["mlp"], h2)
    return _logits(cfg, params, x), cache
