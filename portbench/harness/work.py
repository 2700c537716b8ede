"""The yardstick's arithmetic: the H100's peaks, the least time of a piece
of work, and the FLOPs and bytes that a model step and each hand-written
kernel need for the shapes the benchmark passed.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, 700 W), as the
program's `chip_smoke.py` keeps them. A kernel's bound counts each input
byte read once and each output byte written once, against the peak of
its arithmetic; work that depends on the data (a causal or windowed mask)
is counted as these inputs need it.

Model FLOPs count the matrix products only (projections, the attention
products over the live query-key pairs, the SSD recurrence's state update
and read-out, the head), as `torch.utils.flop_counter.FlopCounterMode`
counts them on the plain reference; norms, activations, rotary embedding,
softmax and the depthwise convolution are left out.
"""
from __future__ import annotations

import math
from typing import Mapping

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
PEAK_BF16_FLOP_PER_S = 989e12

# topk_sim's wgmma route (TF32 filter on the tensor cores), as the program
# picks it: tables over 6,144 rows, 9 <= Q <= 64 and Q * k <= 320
_TOPK_WGMMA = dict(min_t=6145, min_q=9, max_q=64, max_qk=320)


def bound_s(nbytes: float, flops: float, peak_flop_per_s: float) -> float:
    """The least time for this work: the larger of its bytes at the memory
    rate and its operations at the arithmetic's peak."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / peak_flop_per_s)


def live_pairs(s: int, window: int) -> int:
    """Query-key pairs a causal (window 0) or sliding-window self-attention
    over s positions attends: sum over i of min(i + 1, window)."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


# ---------------------------------------------------------------- kernels
def flash_bound_s(m: Mapping, s: int) -> float:
    """One flash-attention launch of a prefill over s tokens: q and the
    output [H, s, hd], k and v [Hkv, s, hd] in bf16; 4 * hd FLOPs a live
    pair and head."""
    hd = head_dim(m)
    nbytes = 2 * (2 * m["n_heads"] + 2 * m["n_kv_heads"]) * s * hd
    flops = 4 * hd * m["n_heads"] * live_pairs(s, m.get("sliding_window", 0))
    return bound_s(nbytes, flops, PEAK_BF16_FLOP_PER_S)


def ssd_bound_s(m: Mapping, s: int) -> float:
    """One `ssd_scan` call (its three launches) of a prefill over s tokens:
    x read and y written in bf16 [s, H, P], dt float32 [s, H], B and C bf16
    [s, G, N], the final state float32 [H, P, N] written; 4 * P * N float32
    FLOPs a position and head (the state update and the read-out)."""
    h, p, n, g = ssm_heads(m), m.get("ssm_head_dim", 64), m["ssm_state"], m.get("ssm_n_groups", 1)
    nbytes = 2 * 2 * s * h * p + 4 * s * h + 2 * 2 * s * g * n + 4 * h + 4 * h * p * n
    return bound_s(nbytes, ssd_flops(m, s), PEAK_F32_FLOP_PER_S)


def topk_peak(n_q: int, n_t: int, k: int) -> float:
    """The arithmetic's peak on the route the program takes: TF32 on the
    wgmma route, float32 FMAs on the split and cluster routes."""
    w = _TOPK_WGMMA
    wgmma = n_t >= w["min_t"] and w["min_q"] <= n_q <= w["max_q"] and n_q * k <= w["max_qk"]
    return PEAK_TF32_FLOP_PER_S if wgmma else PEAK_F32_FLOP_PER_S


def topk_bound_s(n_q: int, n_t: int, d: int, k: int) -> float:
    """One `topk_sim` call (its launches): float32 queries [Q, D] and table
    [T, D] read once, float32 scores and int64 indices [Q, k] written;
    2 * Q * T * D FLOPs."""
    nbytes = 4 * (n_q * d + n_t * d) + n_q * k * (4 + 8)
    return bound_s(nbytes, 2 * n_q * n_t * d, topk_peak(n_q, n_t, k))


# ------------------------------------------------------------ model FLOPs
def head_dim(m: Mapping) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def ssm_heads(m: Mapping) -> int:
    return m.get("ssm_expand", 2) * m["d_model"] // m.get("ssm_head_dim", 64)


def ssd_flops(m: Mapping, s: int) -> int:
    return 4 * s * ssm_heads(m) * m.get("ssm_head_dim", 64) * m["ssm_state"]


def layer_matmul_params(m: Mapping) -> int:
    """Weights of one layer's matrix products: q, k, v, o; gate, up, down;
    a hybrid layer's Mamba-2 in_proj and out_proj."""
    d, hd = m["d_model"], head_dim(m)
    n = d * hd * (2 * m["n_heads"] + 2 * m["n_kv_heads"]) + 3 * d * m["d_ff"]
    if m.get("hybrid"):
        di = m.get("ssm_expand", 2) * d
        gn = m.get("ssm_n_groups", 1) * m["ssm_state"]
        n += d * (2 * di + 2 * gn + ssm_heads(m)) + di * d
    return n


def seq_mixer_flops(m: Mapping, s: int) -> int:
    """Attention products and the SSD recurrence of one layer over s tokens."""
    f = 4 * head_dim(m) * m["n_heads"] * live_pairs(s, m.get("sliding_window", 0))
    if m.get("hybrid"):
        f += ssd_flops(m, s)
    return f


def prefill_flops(m: Mapping, s: int) -> int:
    """One prefill of s tokens at batch 1: every layer over s positions, the
    head at the last position only (as `prefill` computes its logits)."""
    per_layer = 2 * s * layer_matmul_params(m) + seq_mixer_flops(m, s)
    return m["n_layers"] * per_layer + 2 * m["d_model"] * m["vocab_size"]


def train_step_flops(m: Mapping, batch: int, s: int) -> int:
    """Forward and backward of one step over [batch, s]: 6 FLOPs a matrix
    weight and token (the head over every position included), and three
    times the forward's attention and SSD work."""
    n = m["n_layers"] * layer_matmul_params(m) + m["d_model"] * m["vocab_size"]
    return batch * (6 * n * s + 3 * m["n_layers"] * seq_mixer_flops(m, s))


def share_pct(flops: float, seconds: float, peak: float = PEAK_BF16_FLOP_PER_S) -> float:
    """flops / (seconds * peak) in percent."""
    return 100.0 * flops / (seconds * peak) if seconds > 0 else math.nan
