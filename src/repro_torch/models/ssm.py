"""Mamba-2 SSD (state-space duality) blocks — arXiv:2405.21060.

Counterpart of `repro/models/ssm.py`, with the same shapes and casts:
chunked SSD for prefill, exact O(1)-state recurrent decode. The JAX
package's `lax.scan` over chunk states is a loop here. `ssm_block` computes the scan through
`kernels.ssd_scan.ops.ssd_scan` (the hand-written kernel on the card);
`ssd_chunked` is the plain version that the op serves on the CPU.

Shapes follow the paper: x [B,S,H,P], dt [B,S,H], A [H] (log-parametrized),
B/C [B,S,G,N] with G groups broadcast over heads.

The reference's two sharding constraints (the scan's input over
"ssm_heads", the block's output over the batch) are
`common.sharding.logical_constraint` calls: no-ops on plain tensors.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.sharding import logical_constraint as shard
from repro_torch.common.sharding import DTensor, Replicate, blockwise, project, project_groups
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.obs.trace import span

__all__ = ["ssd_chunked", "ssm_block", "ssm_decode", "xbc_raw_tail"]


def _repeat_groups(t: torch.Tensor, h: int) -> torch.Tensor:
    """[B,S,G,N] -> [B,S,H,N] broadcasting groups over heads."""
    g = t.shape[2]
    if g == h:
        return t
    return t.repeat_interleave(h // g, dim=2)


def ssd_chunked(
    x: torch.Tensor,  # [B, S, H, P] (pre-discretization input)
    dt: torch.Tensor,  # [B, S, H] softplus'd step sizes
    a_log: torch.Tensor,  # [H]
    b_mat: torch.Tensor,  # [B, S, G, N]
    c_mat: torch.Tensor,  # [B, S, G, N]
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y [B,S,H,P], final_state [B,H,P,N])."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    assert s % chunk == 0, f"seq {s} not divisible by chunk {chunk}"
    nc = s // chunk
    a = -torch.exp(a_log.float())  # [H], negative

    xd = (x * dt[..., None]).float()  # discretized input
    adt = (a * dt.float()).reshape(bsz, nc, chunk, h)  # log decays
    xd = xd.reshape(bsz, nc, chunk, h, p)
    bh = _repeat_groups(b_mat, h).reshape(bsz, nc, chunk, h, n).float()
    ch = _repeat_groups(c_mat, h).reshape(bsz, nc, chunk, h, n).float()

    a_cum = torch.cumsum(adt, dim=2)  # [B,nc,l,H] within-chunk cumulative decay

    # ---- intra-chunk (diagonal blocks): quadratic attention-like form
    li = a_cum[:, :, :, None, :]  # query position l
    lj = a_cum[:, :, None, :, :]  # key position s
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    # exponent is <=0 in the causal region; clamp to avoid inf in masked slots
    l_mat = torch.where(causal, torch.exp(torch.clamp(li - lj, max=0.0)), 0.0)
    scores = torch.einsum("bclhn,bcshn->bclsh", ch, bh)
    y_diag = torch.einsum("bclsh,bcshp->bclhp", scores * l_mat, xd)

    # ---- chunk summary states: contribution of each chunk to the carried state
    seg_decay = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # [B,nc,l,H]
    states = torch.einsum("bclhn,bclh,bclhp->bchpn", bh, seg_decay, xd)

    # ---- inter-chunk recurrence over nc chunks
    chunk_decay = torch.exp(a_cum[:, :, -1, :])  # [B,nc,H]
    if init_state is None:
        carry = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    else:
        carry = init_state.float()
    prev = []  # the state *entering* each chunk
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)  # [B,nc,H,P,N]

    # ---- off-diagonal: carried state read out at each position
    state_decay = torch.exp(a_cum)  # [B,nc,l,H]
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", ch, prev, state_decay)

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y.to(x.dtype), carry


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. xbc: [B,S,C]; w: [K,C]; b: [C]."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1]] * w[i] for i in range(k))
    return F.silu(out + b)


def _in_groups(cfg: ModelConfig) -> tuple:
    """in_proj's column groups for `project_groups`: z, x, B, C and dt. z
    and x (d_inner = H·P: a block of whole heads is a block of columns)
    split over the SSM heads; B and C (G·N each) whole, as the scan reads
    them, and dt (H) whole beside them, one product with them, so that a
    rank computes as many of in_proj's columns as it would of the one
    product (dt is then cut to its heads locally)."""
    heads, rows = ("batch", None, "ssm_heads"), ("batch", None, None)
    di, gn, p = cfg.d_inner, cfg.ssm_n_groups * cfg.ssm_state, cfg.ssm_head_dim
    return ((di, p, heads), (di, p, heads), (gn, 1, rows), (gn, 1, rows),
            (cfg.ssm_heads, 1, rows))


def _conv_parts(p: dict, parts: Sequence[torch.Tensor]) -> tuple:
    """The causal conv of xBC's channel parts (x, B, C), each in the
    layout it comes in. On plain tensors one conv of the channels joined.
    Where x comes with its channels split (over the SSM heads), each rank
    convolves its blocks of each part (`blockwise`: the conv is depthwise,
    so a block of channels needs only its own weights), x over the heads,
    B and C whole; where they are whole, DTensor's own ops convolve each
    part as it lies."""
    w, bias = p["conv_w"], p["conv_b"]
    x = parts[0]
    if not isinstance(x, DTensor):
        xbc = _causal_conv(torch.cat(parts, dim=-1), w, bias)
        return tuple(xbc.split([t.shape[-1] for t in parts], dim=-1))
    split = any(pl.is_shard(x.dim() - 1) for pl in x.placements)
    out, at = [], 0
    for t, heads in zip(parts, ("ssm_heads", None, None)):
        c = t.shape[-1]
        args = (t, w[:, at:at + c], bias[at:at + c])
        out.append(blockwise(_causal_conv, args, (("batch", None, heads), (None, heads), (heads,)),
                             (("batch", None, heads),)) if split else _causal_conv(*args))
        at += c
    return tuple(out)


def _window_conv(p: dict, window: torch.Tensor, parts: tuple) -> tuple:
    """silu of the conv over a decode step's window [B, K, C] of whole
    channels (the cache's), cut into xBC's parts [B, c] (x, B, C). On plain
    tensors one product of the channels joined, and a view of each part.
    On DTensors a product a part, each part of the window first laid out
    as its part of the new row (`parts`, from in_proj) is: x over the SSM
    heads where they split (a slice of the whole window, no collective).
    A cut of the one product's output at channels off its shards' edges
    would gather it, three times a layer."""
    w, bias = p["conv_w"], p["conv_b"]
    if not isinstance(window, DTensor):
        out = F.silu(project("bkc,kc->bc", window, w) + bias)
        return tuple(out.split([t.shape[-1] for t in parts], dim=-1))
    out, at = [], 0
    for t in parts:
        c = t.shape[-1]
        placed = [Replicate() if pl.is_partial() else pl for pl in t.placements]
        part = window[..., at:at + c].redistribute(window.device_mesh, placed)
        out.append(F.silu(project("bkc,kc->bc", part, w[:, at:at + c]) + bias[at:at + c]))
        at += c
    return tuple(out)


def _whole_channels(parts: tuple) -> torch.Tensor:
    """xBC's channel parts joined, its channels whole (the decode cache's
    layout)."""
    return torch.cat([shard(t, "batch", None, None) for t in parts], dim=-1)


_HEADS = ("batch", None, "ssm_heads", None)
_ROWS = ("batch", None, None, None)


def _scan(xs, dt, a_log, b_mat, c_mat, cfg: ModelConfig, use_kernel):
    """`ssd_scan` of one block of rows and SSM heads (the whole scan on
    plain tensors). B and C stay whole: with one group every head reads it."""
    if b_mat.shape[2] > 1 and xs.shape[2] != cfg.ssm_heads:
        raise ValueError("the SSD scan splits its heads only with one B/C group")
    return ssd_ops.ssd_scan(xs, dt, a_log, b_mat, c_mat, cfg.ssm_chunk, use_kernel=use_kernel)


def ssm_block(
    p: dict,
    x: torch.Tensor,  # [B, S, D] (already normed)
    cfg: ModelConfig,
    return_cache: bool = False,
    use_kernel: Optional[bool] = None,
):
    """Full-sequence Mamba-2 block (train / prefill). `use_kernel` goes to
    `ssd_scan`: None picks the path by device, False the plain version
    (training's, which carries gradients)."""
    bsz, s, _ = x.shape
    di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_groups
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim

    z, *xbc, dt = project_groups("bsd,de->bse", x, p["in_proj"], _in_groups(cfg))
    xs, b_mat, c_mat = _conv_parts(p, xbc)
    xs = shard(xs.reshape(bsz, s, h, pdim), "batch", None, "ssm_heads", None)
    b_mat = b_mat.reshape(bsz, s, g, n)
    c_mat = c_mat.reshape(bsz, s, g, n)
    dt = F.softplus(shard(dt, "batch", None, "ssm_heads").float() + p["dt_bias"])  # [B,S,H]

    # pad to a chunk multiple with dt=0 positions: exp(0)=1 decay and zero
    # input make padding an exact identity on the carried state
    pad = (-s) % cfg.ssm_chunk
    xs_p, b_p, c_p, dt_p = xs, b_mat, c_mat, dt
    if pad:
        xs_p = F.pad(xs, (0, 0, 0, 0, 0, pad))
        b_p = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_p = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
        dt_p = F.pad(dt, (0, 0, 0, pad))

    with span("model.ssm.scan"):
        y, final_state = blockwise(
            lambda *a: _scan(*a, cfg, use_kernel), (xs_p, dt_p, p["a_log"], b_p, c_p),
            (_HEADS, ("batch", None, "ssm_heads"), ("ssm_heads",), _ROWS, _ROWS),
            (_HEADS, ("batch", "ssm_heads", None, None)))
    if pad:
        y = y[:, :s]
    y = y + xs * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, di)
    y = rms_norm(y, p["norm"], cfg.norm_eps) * F.silu(z)
    out = shard(project("bse,ed->bsd", y, p["out_proj"]), "batch", "act_seq", None)
    if not return_cache:
        return out
    conv_state = xbc_raw_tail(xbc, cfg, s)
    return out, (conv_state, final_state.to(x.dtype))


def xbc_raw_tail(xbc: Sequence[torch.Tensor], cfg: ModelConfig, s: int) -> torch.Tensor:
    """Last (conv_width-1) pre-conv xBC rows — the decode conv cache —
    of xBC's channel parts (x, B, C), its channels whole. A copy, as JAX's
    slice is: a view would keep the layer's whole projection alive in the
    cache."""
    k = cfg.ssm_conv_width
    return _whole_channels(tuple(t[:, s - (k - 1):] for t in xbc))


def _state_step(st, dt, a, b_h, c_h, xs):
    """One token's state update and read-out, per row and SSM head."""
    da = torch.exp(dt * a)  # [B,H]
    st = st * da[:, :, None, None] + torch.einsum("bh,bhn,bhp->bhpn", dt, b_h, xs)
    return torch.einsum("bhn,bhpn->bhp", c_h, st), st


def ssm_decode(
    p: dict,
    x: torch.Tensor,  # [B, 1, D] (already normed)
    cfg: ModelConfig,
    conv_state: torch.Tensor,  # [B, K-1, C]
    ssd_state: torch.Tensor,  # [B, H, P, N]
):
    """One-token recurrent decode: O(1) in sequence length.

    The new conv window and state are written into `conv_state` /
    `ssd_state` in place (the JAX version returns updated copies); both are
    returned.
    """
    bsz = x.shape[0]
    di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_groups
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim

    z, *xbc_new, dt = project_groups("bsd,de->bse", x, p["in_proj"], _in_groups(cfg))
    # a token's xBC row, its channels whole as the cache keeps them
    window = torch.cat([conv_state, _whole_channels(xbc_new)], dim=1)  # [B, K, C]
    x_conv, b_conv, c_conv = _window_conv(p, window, xbc_new)
    xs = x_conv.reshape(bsz, h, pdim)
    # B and C whole here, as every head reads them: [B, G·N], not yet
    # repeated over the heads or in float32
    b_mat = shard(b_conv, "batch", None).reshape(bsz, g, n)
    c_mat = shard(c_conv, "batch", None).reshape(bsz, g, n)
    rep = h // g
    b_h = b_mat.repeat_interleave(rep, dim=1)  # [B,H,N]
    c_h = c_mat.repeat_interleave(rep, dim=1)
    dt = F.softplus(shard(dt, "batch", None, "ssm_heads").float() + p["dt_bias"]).reshape(bsz, h)
    a = -torch.exp(p["a_log"].float())
    heads, state = ("batch", "ssm_heads", None), ("batch", "ssm_heads", None, None)
    y, st = blockwise(_state_step, (ssd_state.float(), dt, a, b_h.float(), c_h.float(),
                                    xs.float()),
                      (state, heads[:2], heads[1:2], heads, heads, heads), (heads, state))
    y = y.to(x.dtype) + xs * p["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, di)
    y = rms_norm(y, p["norm"], cfg.norm_eps) * F.silu(z)
    out = project("bse,ed->bsd", y, p["out_proj"])
    conv_state.copy_(window[:, 1:])
    ssd_state.copy_(st)
    return out, conv_state, ssd_state
