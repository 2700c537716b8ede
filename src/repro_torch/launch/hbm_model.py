"""Analytic HBM-traffic model per (arch x shape): the roofline memory floor.

Counterpart of `repro/launch/hbm_model.py`, the same arithmetic on the
config, so its numbers are the reference's to the byte. The dry-run's
`bytes accessed` (`common.meshctx.cost_analysis_dict`) sums the input and
output bytes of every eager op: every intermediate is counted at every
op, an upper bound well above the card's HBM traffic, where fused kernels
keep intermediates in shared memory and registers. For the roofline's
memory term the dry-run therefore uses this floor (the bytes that MUST
move through HBM given perfect fusion) and records the op-level sum as the
no-fusion upper bound. The card sits between the two.

Model (per device, per step; dtype = 2 bytes bf16):
  weights     r_w reads of the device's weight working set
              (active_params / model_shards: FSDP gathers materialize the
              full "model"-shard slice on every device regardless of the
              data-axis shard)
  optimizer   train only: adamw 3x fp32 state r/w + grad write
  activations residual-stream saves: ~n_saves per layer of [T_local, d]
  kv cache    decode: full read + 1-token write; prefill: full write
  ssm state   decode: read + write of [H, P, N] per layer
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig

__all__ = ["analytic_hbm_bytes"]

BF16 = 2
F32 = 4


def analytic_hbm_bytes(
    cfg: ModelConfig,
    kind: str,  # train | prefill | decode
    global_batch: int,
    seq_len: int,
    chips: int,
    model_shards: int,
    optimizer: str = "adamw",
    weight_bytes: float = BF16,  # 1.0 for int8-quantized serving
) -> Dict[str, float]:
    p_active = cfg.active_param_count()
    p_total = cfg.param_count()
    # per-device weight working set (TP slice; FSDP all-gather materializes it)
    w_dev = p_active / model_shards * weight_bytes
    w_dev_total = p_total / chips * BF16  # true resident shard (FSDP+TP)

    t_local = global_batch * (seq_len if kind != "decode" else 1) / chips
    d = cfg.d_model
    L = cfg.n_layers

    out: Dict[str, float] = {}
    if kind == "train":
        # fwd read + remat re-read + bwd read; grads written once (f32)
        out["weights"] = 3 * w_dev
        out["grads"] = p_total / chips * F32
        if optimizer == "adamw":
            out["opt_state"] = p_total / chips * F32 * 4  # mu,nu read+write
        else:  # adafactor: factored stats ~ negligible vs params
            out["opt_state"] = p_total / chips * F32 * 0.1
        out["param_update"] = w_dev_total * 2  # read + write
        # remat saves: residual stream + a few per-layer boundaries
        n_saves = 2
        out["activations"] = t_local * d * L * BF16 * n_saves * 2  # write + read
    elif kind == "prefill":
        out["weights"] = w_dev
        n_flows = 4  # residual r/w at block boundaries (flash-fused attention)
        out["activations"] = t_local * d * L * BF16 * n_flows
        out["kv_write"] = _cache_bytes(cfg, global_batch, seq_len, chips, model_shards)
    else:  # decode
        out["weights"] = w_dev
        cache = _cache_bytes(cfg, global_batch, seq_len, chips, model_shards)
        out["cache_read"] = cache
        out["cache_write"] = t_local * L * _cache_row_bytes(cfg, model_shards)
        out["activations"] = t_local * d * L * BF16 * 4
    out["total"] = sum(out.values())
    return out


def _cache_row_bytes(cfg: ModelConfig, model_shards: int) -> float:
    """Per-token per-layer cache bytes on one device."""
    b = 0.0
    if cfg.has_attention:
        if cfg.decode_attn == "seq_shard":
            kv_shards = model_shards  # cache seq dim sharded (tp_kvs policy)
        else:
            kv_shards = model_shards if cfg.n_kv_heads % model_shards == 0 else 1
        b += 2 * cfg.n_kv_heads * cfg.hd / kv_shards * BF16
    return b


def _cache_bytes(
    cfg: ModelConfig, global_batch: int, seq_len: int, chips: int, model_shards: int
) -> float:
    """Total per-device cache bytes for the full context."""
    data_shards = max(chips // model_shards, 1)
    b_local = max(global_batch / data_shards, 1)
    total = 0.0
    if cfg.has_attention:
        w = min(cfg.sliding_window, seq_len) if cfg.sliding_window else seq_len
        total += b_local * cfg.n_layers * w * _cache_row_bytes(cfg, model_shards)
    if cfg.has_ssm:
        h_shards = model_shards if cfg.ssm_heads % model_shards == 0 else 1
        state = cfg.ssm_heads / h_shards * cfg.ssm_head_dim * cfg.ssm_state * BF16
        total += 2 * b_local * cfg.n_layers * state  # read + write
    if cfg.cross_attn_every:
        n_cross = cfg.n_layers // cfg.cross_attn_every
        kv_shards = model_shards if cfg.n_kv_heads % model_shards == 0 else 1
        total += (
            2 * b_local * n_cross * cfg.n_image_tokens
            * cfg.n_kv_heads * cfg.hd / kv_shards * BF16
        )
    return total
