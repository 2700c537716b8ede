"""Expert-parallel MoE over a mesh's "model" axis.

Counterpart of `repro/models/moe_shard_map.py`, whose `shard_map` body this
runs on each rank (the port is SPMD: one process a rank):

  * the residual stream is sharded over the data axes ("pod", "data") and
    the same on every "model" rank: `x` is this rank's rows of the batch;
  * each "model" rank owns E/m experts and holds only their `w_gate`,
    `w_up`, `w_down` (`shard_expert_params` cuts a model's params so, as the
    reference's in_specs P("model", ...) hand each program its block), and
    scatters only the assignments routed to them into a local [E/m, C, D]
    buffer (no collective);
  * the expert FFN runs on the local slice; the combine is one all-reduce
    (sum) over "model".

Capacity is the reference's per data shard: C = ceil(t_local * k / E * cf)
with t_local this rank's tokens, so it differs from `layers.moe_block`'s
over the whole batch once the data axes hold more than one rank. The aux
loss is the reference's global router pass over every data shard's tokens:
its token and probability sums are all-reduced over the data axes.

The dispatch is forward-only (prefill, decode, evaluation): its collectives
carry no gradient, so grad-requiring inputs raise, as the kernel ops do.
Training takes `moe_impl="gspmd"`.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.common import meshctx, sharding
from repro_torch.core.retrieval import stable_topk
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

__all__ = ["moe_block_shard_map", "shard_expert_params", "init_expert_parallel",
           "EXPERT_WEIGHTS"]

EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")  # [E, ...] a layer, experts major


def _batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def shard_expert_params(cfg: ModelConfig, params: dict, mesh: meshctx.Mesh) -> dict:
    """`params` with each layer's expert weights cut to this rank's E/m
    experts along "model" (copied where cut, so the full tensors can be
    freed; the forward writes no param); the other leaves are the same
    tensors. Raises when "model" does not divide E."""
    m = mesh.shape["model"] if "model" in mesh.axis_names else 1
    if cfg.n_experts % m:
        raise ValueError(f"experts {cfg.n_experts} must divide over the model axis {m}")
    moe = dict(params["layers"]["moe"])
    for n in EXPERT_WEIGHTS:  # stacked over layers: [L, E, ...]
        w = moe[n]
        moe[n] = sharding.local_shard(w, (None, "model") + (None,) * (w.dim() - 2),
                                      mesh).contiguous()
    return {**params, "layers": {**params["layers"], "moe": moe}}


def init_expert_parallel(cfg: ModelConfig, generator: torch.Generator, mesh: meshctx.Mesh,
                         device=None) -> dict:
    """`model.init(cfg, generator, device)` as `shard_expert_params` cuts
    it, without holding it whole: each expert weight is drawn whole from
    `generator` (the stream one device draws) and cut to this rank's E/m
    experts before its cast, so a rank holds at most one leaf's float32
    draw beyond its own params."""
    from repro_torch.models.model import make_specs
    from repro_torch.models.params import init_params

    m = mesh.shape["model"] if "model" in mesh.axis_names else 1
    if cfg.n_experts % m:
        raise ValueError(f"experts {cfg.n_experts} must divide over the model axis {m}")

    def cut(spec, x):
        if "experts" not in spec.axes:
            return x
        spec_m = tuple("model" if a == "experts" else None for a in spec.axes)
        return sharding.local_shard(x, spec_m, mesh)

    return init_params(make_specs(cfg), generator, dtype=cfg.dtype, device=device, cut=cut)


def moe_block_shard_map(p: dict, x: torch.Tensor,
                        cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in replacement for `layers.moe_block` under an active mesh with
    a "model" axis; `layers.moe_block` itself without one. `x` [B_l, S, D]
    is this rank's rows; `p`'s expert weights hold this rank's E/m experts
    (`shard_expert_params`) or all E, of which it takes its block. Returns
    (y [B_l, S, D], aux)."""
    mesh = meshctx.current_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return layers.moe_block(p, x, cfg)  # no TP axis
    if torch.is_grad_enabled() and (x.requires_grad or any(
            w.requires_grad for w in p.values())):
        raise ValueError("moe_block_shard_map is forward-only: its collectives carry no "
                         "gradient (train with moe_impl='gspmd', or run under no_grad)")

    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    m = mesh.shape["model"]
    if e % m:
        raise ValueError(f"experts {e} must divide over the model axis {m}")
    e_local = e // m
    held = p["w_gate"].shape[0]
    if held not in (e, e_local):
        raise ValueError(f"expert weights hold {held} experts: neither all {e} nor this "
                         f"rank's {e_local}")
    t = b * s
    cap = layers.moe_capacity(t, cfg)  # over this rank's tokens

    xt = x.reshape(t, d)
    logits = torch.einsum("td,de->te", xt, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)

    # aux losses from the router pass over every data shard's tokens
    baxes = _batch_axes(mesh)
    top1 = torch.argmax(probs, dim=-1)  # the first of equal maxima, as jnp.argmax
    sums = torch.cat([F.one_hot(top1, e).sum(0).float(), probs.sum(0),
                      (torch.logsumexp(logits, dim=-1) ** 2).sum()[None],
                      torch.tensor([float(t)], device=x.device)])
    if baxes:
        sums = mesh.psum(sums, baxes)
    n_tok = sums[-1]
    frac_tokens, frac_probs = sums[:e] / n_tok, sums[e:2 * e] / n_tok
    lb = e * (frac_tokens * frac_probs).sum() * cfg.load_balance_weight
    aux = lb + sums[2 * e] / n_tok * cfg.router_z_weight

    top_w, top_e = stable_topk(probs, k)  # ties to the lowest expert, as lax.top_k
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    lo = mesh.axis_index("model") * e_local
    flat_e = top_e.reshape(-1)  # [T*k] global expert ids
    mine = (flat_e >= lo) & (flat_e < lo + e_local)
    local_e = torch.where(mine, flat_e - lo, 0)
    # position within the expert's buffer, counting only this rank's assignments
    onehot = F.one_hot(local_e, e_local) * mine[:, None]
    pos = torch.cumsum(onehot, dim=0) - onehot
    slot = torch.gather(pos, 1, local_e[:, None])[:, 0]
    keep = mine & (slot < cap)
    target = torch.where(keep, local_e * cap + slot, e_local * cap)

    data = xt.repeat_interleave(k, dim=0) * keep[:, None].to(x.dtype)
    buffers = torch.zeros((e_local * cap + 1, d), dtype=x.dtype, device=x.device)
    buffers.index_add_(0, target, data)
    buf = buffers[: e_local * cap].reshape(e_local, cap, d)

    wg, wu, wd = (p[n] if held == e_local else p[n][lo:lo + e_local] for n in EXPERT_WEIGHTS)
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, wg)) * torch.einsum("ecd,edf->ecf", buf, wu)
    out_buf = torch.einsum("ecf,efd->ecd", h, wd).reshape(e_local * cap, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, d))], dim=0)

    gathered = out_buf[target]
    w = (top_w.reshape(-1) * keep).to(x.dtype)
    y = (gathered * w[:, None]).reshape(t, k, d).sum(dim=1)
    y = mesh.psum(y, "model")  # combine every expert shard's contributions
    return y.reshape(b, s, d), aux
