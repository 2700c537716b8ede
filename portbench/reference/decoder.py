"""The decoder that a configuration describes, in plain PyTorch.

The equations are those of the port's `ModelConfig` for a dense model and
for a hybrid one (parallel attention and Mamba-2 heads, averaged): RMSNorm
(float32, eps), rotary embedding on the halves of each head, grouped-query
attention under a causal or sliding-window mask, SwiGLU, and the Mamba-2
block (in_proj into z, x, B, C and dt; a causal depthwise conv with SiLU
over x, B and C; dt = softplus(dt + dt_bias); the SSD recurrence with
A = -exp(a_log); y + D * x; RMSNorm(y) * SiLU(z); out_proj), a final norm
and the (tied) head. Written from those equations; it imports nothing of
the program.

All arithmetic is float32. Every matrix product goes through one function,
`Precision.mm`: float32 with TF32 off for the reference, or a lower
precision for its control. Weights arrive in the program's layout (any
dtype) and are cast a layer at a time, so a model larger than what fits
in float32 is run a layer at a time.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

E4M3_MAX = 448.0


E5M2_MAX = 57344.0


def fp8_round(x: torch.Tensor, dtype=torch.float8_e4m3fn, top: float = E4M3_MAX) -> torch.Tensor:
    """x through a float8 type with one scale a tensor (its absolute
    maximum at the type's largest value), back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8MatMul(torch.autograd.Function):
    """a @ b with both operands rounded through e4m3, and in the backward
    pass the incoming gradient through e5m2 (the usual fp8 training
    recipe: e4m3 for weights and activations, e5m2 for gradients); the
    products are summed in float32."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = fp8_round(a.detach()), fp8_round(b.detach())
        ctx.save_for_backward(a8, b8)
        return torch.matmul(a8, b8)

    @staticmethod
    def backward(ctx, grad):
        a8, b8 = ctx.saved_tensors
        g8 = fp8_round(grad, torch.float8_e5m2, E5M2_MAX)
        ga = torch.matmul(g8, b8.transpose(-1, -2))
        gb = torch.matmul(a8.transpose(-1, -2), g8)
        # undo broadcasting over leading dimensions
        while gb.dim() > b8.dim():
            gb = gb.sum(0)
        return ga, gb


class Precision:
    """How the reference multiplies matrices: "float32" (TF32 off) or
    "fp8" (`_Fp8MatMul`): the control's precision for a bf16
    configuration."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            return _Fp8MatMul.apply(a, b)
        return torch.matmul(a, b)


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, hd] at positions 0..S-1: the two halves of each head
    rotated by position * theta^(-i / half)."""
    s, half = x.shape[-3], x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, window: int, prec: Precision, block: int = 1024):
    """q [S, H, hd] over k, v [S, Hkv, hd]; query head h reads KV head
    h // (H / Hkv). Key j is live for query i when j <= i and, with a
    window, i - j < window. Computed a block of queries at a time over the
    keys that block can see."""
    s, h, hd = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)  # [H, S, hd]
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    q = q.transpose(0, 1)
    out = []
    for i0 in range(0, s, block):
        i1 = min(i0 + block, s)
        lo = max(0, i0 - window + 1) if window else 0
        qpos = torch.arange(i0, i1, device=q.device)[:, None]
        kpos = torch.arange(lo, i1, device=q.device)[None, :]
        live = kpos <= qpos
        if window:
            live &= kpos > qpos - window
        logits = prec.mm(q[:, i0:i1], k[:, lo:i1].transpose(1, 2)) / math.sqrt(hd)
        probs = torch.softmax(logits.masked_fill(~live, float("-inf")), dim=-1)
        out.append(prec.mm(probs, v[:, lo:i1]))
    return torch.cat(out, dim=1).transpose(0, 1)  # [S, H, hd]


def ssd(x, dt, a, b, c, chunk: int):
    """The SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t, over x [S, H, P], dt [S, H], A [H], B and C [S, H, N]
    (groups already repeated over heads), in its chunked form: exact in
    float32, a chunk's outputs from the products inside it plus the state
    carried into it. Returns y [S, H, P]."""
    s, h, p = x.shape
    n = b.shape[-1]
    pad = (-s) % chunk
    if pad:  # dt = 0 rows: no decay, no input
        x, dt, b, c = (F.pad(t, (0, 0) * (t.dim() - 1) + (0, pad)) for t in (x, dt, b, c))
    nc = x.shape[0] // chunk
    xd = (x * dt[..., None]).reshape(nc, chunk, h, p)
    acum = torch.cumsum((a * dt).reshape(nc, chunk, h), dim=1)  # [nc, l, H]
    bb, cc = b.reshape(nc, chunk, h, n), c.reshape(nc, chunk, h, n)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    decay = torch.exp((acum[:, :, None, :] - acum[:, None, :, :]).clamp(max=0.0))
    decay = torch.where(causal[None, :, :, None], decay, 0.0)  # [nc, l, s, H]
    scores = torch.einsum("clhn,cshn->clsh", cc, bb) * decay
    y = torch.einsum("clsh,cshp->clhp", scores, xd)
    states = torch.einsum("clhn,clh,clhp->chpn", bb, torch.exp(acum[:, -1:] - acum), xd)
    carry = torch.zeros(h, p, n, dtype=x.dtype, device=x.device)
    entering = []
    for i in range(nc):
        entering.append(carry)
        carry = carry * torch.exp(acum[i, -1])[:, None, None] + states[i]
    y = y + torch.einsum("clhn,chpn,clh->clhp", cc, torch.stack(entering), torch.exp(acum))
    return y.reshape(nc * chunk, h, p)[:s]


def ssd_recurrent(x, dt, a, b, c):
    """The same recurrence a step at a time (for checks at small sizes)."""
    s, h, p = x.shape
    st = torch.zeros(h, p, b.shape[-1], dtype=x.dtype, device=x.device)
    ys = []
    for t in range(s):
        st = st * torch.exp(dt[t] * a)[:, None, None] + torch.bmm(
            (x[t] * dt[t][:, None])[:, :, None], b[t][:, None, :])
        ys.append(torch.bmm(st, c[t][:, :, None])[..., 0])
    return torch.stack(ys)


class Decoder:
    """The forward of model sizes `m` (the port's `ModelConfig` fields)."""

    def __init__(self, m: Mapping, prec: Optional[Precision] = None,
                 attn_block: int = 1024, ssm: str = "chunked"):
        self.m = dict(m)
        self.prec = prec or Precision()
        self.attn_block = attn_block
        self.ssm = ssm
        self.hd = m.get("head_dim") or m["d_model"] // m["n_heads"]

    # ---------------------------------------------------------- one layer
    def _mamba(self, lp, h):
        m, mm = self.m, self.prec.mm
        s, d = h.shape
        di = m.get("ssm_expand", 2) * d
        gn = m.get("ssm_n_groups", 1) * m["ssm_state"]
        p = m.get("ssm_head_dim", 64)
        hs = di // p
        zxbcdt = mm(h, lp["in_proj"])
        z, xbc, dt = zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * gn], zxbcdt[:, 2 * di + 2 * gn:]
        kw = lp["conv_w"].shape[0]
        padded = F.pad(xbc, (0, 0, kw - 1, 0))
        conv = sum(padded[i:i + s] * lp["conv_w"][i] for i in range(kw)) + lp["conv_b"]
        xbc = F.silu(conv)
        xs = xbc[:, :di].reshape(s, hs, p)
        g = m.get("ssm_n_groups", 1)
        bm = xbc[:, di:di + gn].reshape(s, g, -1).repeat_interleave(hs // g, dim=1)
        cm = xbc[:, di + gn:].reshape(s, g, -1).repeat_interleave(hs // g, dim=1)
        dt = F.softplus(dt + lp["dt_bias"])
        a = -torch.exp(lp["a_log"])
        if self.ssm == "chunked":
            y = ssd(xs, dt, a, bm, cm, m.get("ssm_chunk", 256))
        else:
            y = ssd_recurrent(xs, dt, a, bm, cm)
        y = (y + xs * lp["d_skip"][:, None]).reshape(s, di)
        y = rms_norm(y, lp["norm"], m.get("norm_eps", 1e-5)) * F.silu(z)
        return mm(y, lp["out_proj"])

    def layer(self, lp: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """One layer over x [S, d]; lp holds the layer's float32 leaves
        under their paths below "layers/"."""
        m, mm = self.m, self.prec.mm
        s, d = x.shape
        eps, theta = m.get("norm_eps", 1e-5), m.get("rope_theta", 10000.0)
        h = rms_norm(x, lp["ln1"], eps)
        hq, hkv, hd = m["n_heads"], m["n_kv_heads"], self.hd
        q = rope(mm(h, lp["attn/wq"].reshape(d, -1)).reshape(s, hq, hd), theta)
        k = rope(mm(h, lp["attn/wk"].reshape(d, -1)).reshape(s, hkv, hd), theta)
        v = mm(h, lp["attn/wv"].reshape(d, -1)).reshape(s, hkv, hd)
        o = attention(q, k, v, m.get("sliding_window", 0), self.prec, self.attn_block)
        mix = mm(o.reshape(s, hq * hd), lp["attn/wo"].reshape(hq * hd, d))
        if m.get("hybrid"):
            mix = 0.5 * (mix + self._mamba({n[4:]: t for n, t in lp.items()
                                            if n.startswith("ssm/")}, h))
        x = x + mix
        h = rms_norm(x, lp["ln2"], eps)
        ff = F.silu(mm(h, lp["mlp/w_gate"])) * mm(h, lp["mlp/w_up"])
        return x + mm(ff, lp["mlp/w_down"])

    def head(self, top: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, top["ln_f"], self.m.get("norm_eps", 1e-5))
        w = top["lm_head"] if "lm_head" in top else top["embed"].T
        return self.prec.mm(x, w)

    # ------------------------------------------------------------ programs
    @staticmethod
    def _layer_leaves(flat: Dict[str, torch.Tensor], i: int, cast: Callable) -> Dict:
        return {p[len("layers/"):]: cast(t[i]) for p, t in flat.items()
                if p.startswith("layers/")}

    @torch.no_grad()
    def last_logits(self, flat: Dict[str, torch.Tensor],
                    prompts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Logits [V] at each prompt's last position; `flat` maps leaf
        paths to the weights (cast to float32 a layer at a time)."""
        f32 = lambda t: t.to(torch.float32)  # noqa: E731
        xs = [f32(flat["embed"][p]) for p in prompts]
        for i in range(self.m["n_layers"]):
            lp = self._layer_leaves(flat, i, f32)
            xs = [self.layer(lp, x) for x in xs]
            del lp
        top = {k: f32(flat[k]) for k in ("ln_f", "embed", "lm_head") if k in flat}
        return [self.head(top, x[-1:])[0] for x in xs]

    def loss(self, flat32: Dict[str, torch.Tensor], tokens: torch.Tensor,
             checkpoint: bool = True) -> torch.Tensor:
        """Mean next-token cross-entropy over tokens [B, S], differentiable
        in the float32 leaves `flat32`; each layer recomputed in the
        backward pass when `checkpoint`."""
        names = [p for p in flat32 if p.startswith("layers/")]
        total = []
        for row in tokens:
            x = flat32["embed"][row]
            for i in range(self.m["n_layers"]):
                leaves = [flat32[p][i] for p in names]

                def run(x, *leaves):
                    return self.layer(dict(zip((p[len("layers/"):] for p in names), leaves)), x)

                x = (torch.utils.checkpoint.checkpoint(run, x, *leaves, use_reentrant=False)
                     if checkpoint else run(x, *leaves))
            top = {k: flat32[k] for k in ("ln_f", "embed", "lm_head") if k in flat32}
            logits = self.head(top, x)[:-1]  # the head over every position, as trained
            total.append(F.cross_entropy(logits, row[1:].long(), reduction="sum"))
        return torch.stack(total).sum() / (tokens.shape[0] * (tokens.shape[1] - 1))
