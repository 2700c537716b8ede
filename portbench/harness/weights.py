"""Seeded weights in the program's parameter layout, made on the device.

The layout is the one `repro_torch.models.model.make_specs` gives a dense
or hybrid model without MoE, cross layers or QKV bias: a dict a kind,
each leaf stacked over layers. The benchmark makes the weights and hands
the same tensors to the program and to the reference.

Every matrix is drawn at the fan-in of the axes its product contracts
(1/sqrt(d_model) for q, k, v, gate, up and in_proj; 1/sqrt(heads * hd)
for o, 1/sqrt(d_ff) for down, 1/sqrt(d_inner) for out_proj), the
embedding at 0.02. The Mamba-2 leaves take Mamba-2's own init: A = -U(1,
16) (as a_log), dt_bias the inverse softplus of dt = exp(U(ln 1e-3,
ln 1e-1)), D and the norms 1, the conv bias 0.

All matrices come from one normal draw on the device, in the dtype they
are served in, cut into views and scaled a group at a time, so a model
of 8 billion parameters takes a few large calls.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch

from portbench.harness.work import head_dim, ssm_heads

_CHUNK = 1 << 30  # elements a draw call


def layout(m: Mapping) -> Dict[str, Tuple[tuple, str, float]]:
    """{leaf path: (shape, kind, scale)}; kind is normal | ones | zeros |
    a_log | dt_bias."""
    L, d, v, f = m["n_layers"], m["d_model"], m["vocab_size"], m["d_ff"]
    h, hkv, hd = m["n_heads"], m["n_kv_heads"], head_dim(m)
    out = {
        "embed": ((v, d), "normal", 0.02),
        "ln_f": ((d,), "ones", 1.0),
        "layers/ln1": ((L, d), "ones", 1.0),
        "layers/ln2": ((L, d), "ones", 1.0),
        "layers/attn/wq": ((L, d, h, hd), "normal", d ** -0.5),
        "layers/attn/wk": ((L, d, hkv, hd), "normal", d ** -0.5),
        "layers/attn/wv": ((L, d, hkv, hd), "normal", d ** -0.5),
        "layers/attn/wo": ((L, h, hd, d), "normal", (h * hd) ** -0.5),
        "layers/mlp/w_gate": ((L, d, f), "normal", d ** -0.5),
        "layers/mlp/w_up": ((L, d, f), "normal", d ** -0.5),
        "layers/mlp/w_down": ((L, f, d), "normal", f ** -0.5),
    }
    if not m.get("tie_embeddings"):
        out["lm_head"] = ((d, v), "normal", d ** -0.5)
    if m.get("hybrid"):
        di = m.get("ssm_expand", 2) * d
        gn = m.get("ssm_n_groups", 1) * m["ssm_state"]
        hs, k = ssm_heads(m), m.get("ssm_conv_width", 4)
        out.update({
            "layers/ssm/in_proj": ((L, d, 2 * di + 2 * gn + hs), "normal", d ** -0.5),
            "layers/ssm/conv_w": ((L, k, di + 2 * gn), "normal", k ** -0.5),
            "layers/ssm/conv_b": ((L, di + 2 * gn), "zeros", 0.0),
            "layers/ssm/a_log": ((L, hs), "a_log", 0.0),
            "layers/ssm/d_skip": ((L, hs), "ones", 1.0),
            "layers/ssm/dt_bias": ((L, hs), "dt_bias", 0.0),
            "layers/ssm/norm": ((L, di), "ones", 1.0),
            "layers/ssm/out_proj": ((L, di, d), "normal", di ** -0.5),
        })
    return dict(sorted(out.items()))


def _nest(flat: Dict[str, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def make_weights(m: Mapping, seed: int, device) -> Dict:
    """The weight tree for model sizes `m` (its "dtype"), drawn from `seed`
    with a generator on `device`."""
    dtype = getattr(torch, m.get("dtype", "bfloat16"))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    spec = layout(m)
    normal = sorted((p for p, (_, kind, _) in spec.items() if kind == "normal"),
                    key=lambda p: (spec[p][2], p))
    total = sum(math.prod(spec[p][0]) for p in normal)
    flat = torch.empty(total, dtype=dtype, device=device)
    for at in range(0, total, _CHUNK):
        flat[at:at + _CHUNK].normal_(generator=gen)
    leaves: Dict[str, torch.Tensor] = {}
    at, group_start, group_scale = 0, 0, None
    for p in normal:  # contiguous by scale: one multiply a scale
        shape, _, scale = spec[p]
        if scale != group_scale:
            if group_scale is not None:
                flat[group_start:at].mul_(group_scale)
            group_start, group_scale = at, scale
        n = math.prod(shape)
        leaves[p] = flat[at:at + n].view(shape)
        at += n
    if group_scale is not None:
        flat[group_start:at].mul_(group_scale)
    for p, (shape, kind, _) in spec.items():
        if kind in ("ones", "zeros"):
            leaves[p] = torch.full(shape, float(kind == "ones"), dtype=dtype, device=device)
        elif kind == "a_log":
            u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
            leaves[p] = torch.log(1.0 + 15.0 * u).to(dtype)
        elif kind == "dt_bias":
            u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
            dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
            leaves[p] = (dt + torch.log(-torch.expm1(-dt))).to(dtype)  # softplus^-1
    return _nest(dict(sorted(leaves.items())))


def leaf_paths(tree: Dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs in sorted-path order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += leaf_paths(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]
    return out
