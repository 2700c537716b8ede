"""Model configuration for the backend zoo (a copy of `repro/models/config.py`).

One frozen dataclass covers all six architecture families (dense / moe / ssm /
hybrid / vlm / audio). Family-specific fields are zero/off by default; the
assigned-architecture configs in `repro_torch.configs` set them per the public
sources cited there.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig", "reduced"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False  # qwen2.5-style QKV bias
    attn_bias: bool = False  # bias on o-proj and MLP (stablelm uses none)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # ---- MoE ----
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # expert hidden dim (defaults to d_ff)
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    router_z_weight: float = 1e-3
    load_balance_weight: float = 1e-2
    # ---- SSM (Mamba-2 / SSD, arXiv:2405.21060) ----
    ssm_state: int = 0  # N
    ssm_expand: int = 2
    ssm_head_dim: int = 64  # P
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    ssm_n_groups: int = 1
    # ---- hybrid (hymba, arXiv:2411.13676): parallel attn + SSM heads ----
    hybrid: bool = False
    # ---- VLM (llama-3.2-vision): gated cross-attn every Nth layer ----
    cross_attn_every: int = 0  # 0 = no cross-attn layers
    n_image_tokens: int = 0  # patch embeddings from the (stubbed) vision tower
    # ---- audio (musicgen): decoder over EnCodec tokens ----
    n_codebooks: int = 0  # frontend codec is stubbed; tokens arrive directly
    # ---- attention variant ----
    sliding_window: int = 0  # 0 = full causal; >0 = ring-buffer window
    # ---- numerics ----
    dtype: str = "bfloat16"
    # ---- remat ----
    remat: bool = False
    # ---- dry-run probes: fully unroll scans so XLA cost analysis is exact ----
    scan_unroll: bool = False
    # ---- MoE dispatch impl: "gspmd" (baseline scatter) | "shard_map" (§Perf) ----
    moe_impl: str = "gspmd"
    # ---- §Perf: repeat KV to all H heads so attention shards over "model"
    # even when kv_heads doesn't divide the axis (costs kv-activation memory) ----
    repeat_kv: bool = False
    # ---- §Perf: decode attention over a seq-sharded KV cache (flash-decoding
    # shard_map; use with sharding policy "tp_kvs") ----
    decode_attn: str = "gspmd"  # gspmd | seq_shard

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def q_groups(self) -> int:
        assert self.n_heads % max(self.n_kv_heads, 1) == 0
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        assert self.d_inner % self.ssm_head_dim == 0
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def has_attention(self) -> bool:
        return self.arch_type != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.arch_type == "ssm" or self.hybrid

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: native for SSM/hybrid, via window otherwise."""
        return self.has_ssm or self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline sanity)."""
        d, v, L = self.d_model, self.vocab_size, self.n_layers
        hd, H, Hkv = self.hd, self.n_heads, self.n_kv_heads
        kb = self.n_codebooks or 1  # musicgen: K codebook embeddings + heads
        n = kb * v * d  # embed
        if not self.tie_embeddings:
            n += d * kb * v  # lm head
        n += d  # final norm
        if self.arch_type == "ssm":
            per = self._ssm_params() + d
            return n + L * per
        attn = d * H * hd + 2 * d * Hkv * hd + H * hd * d
        if self.qkv_bias:
            attn += (H + 2 * Hkv) * hd
        mlp = 3 * d * self.d_ff  # swiglu
        per = attn + 2 * d  # + norms
        if self.arch_type == "moe":
            moe = self.n_experts * 3 * d * self.expert_ff + d * self.n_experts
            per += moe + (mlp if self.dense_residual else 0)
        else:
            per += mlp
        if self.hybrid:
            per += self._ssm_params()
        n_cross = L // self.cross_attn_every if self.cross_attn_every else 0
        total = n + (L - n_cross) * per
        if n_cross:
            # n_layers counts BOTH self and cross layers (e.g. 100 = 80 + 20);
            # the vision tower itself is stubbed and not counted (DESIGN.md §5)
            cross = (
                d * H * hd + 2 * d * Hkv * hd + H * hd * d + 3 * d * self.d_ff + 2 * d + 2
            )
            total += n_cross * cross
        return total

    def _ssm_params(self) -> int:
        d, di, N = self.d_model, self.d_inner, self.ssm_state
        H = self.ssm_heads
        G = self.ssm_n_groups
        in_proj = d * (2 * di + 2 * G * N + H)
        conv = (di + 2 * G * N) * self.ssm_conv_width
        return in_proj + conv + 3 * H + di * d + di  # + A_log, D, dt_bias, out_proj, norm

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if self.arch_type != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        inactive = (self.n_experts - self.experts_per_token) * 3 * d * self.expert_ff
        return self.param_count() - L * inactive


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test variant of the same family: 2 layers, d_model<=512, <=4 experts."""
    d_model = min(cfg.d_model, 256)
    hd = 64
    n_heads = max(d_model // hd, 2)
    n_kv = max(min(cfg.n_kv_heads, n_heads), 1)
    while n_heads % n_kv:
        n_kv -= 1
    changes = dict(
        name=cfg.name + "-smoke",
        n_layers=2 if not cfg.cross_attn_every else 2 * cfg.cross_attn_every,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=hd,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        n_experts=min(cfg.n_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        moe_d_ff=min(cfg.expert_ff, 256) if cfg.n_experts else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.has_ssm else cfg.ssm_head_dim,
        ssm_chunk=32,
        n_image_tokens=min(cfg.n_image_tokens, 16) if cfg.n_image_tokens else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        dtype="float32",
    )
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
