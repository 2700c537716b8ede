"""Parity of the port's backend model with the JAX reference.

For reduced hymba-1.5b (parallel attention + Mamba-2 in every layer; the
window cut to 16 so that prompts run past it and the ring cache is
rolled), hymba with 2 kv-heads (grouped-query attention inside the
hybrid), qwen2.5-3b (dense, GQA, QKV bias), granite-3-8b (GQA, tied
embeddings), stablelm-3b (full multi-head attention), command-r-plus-104b
(rope_theta 7.5e7), mamba2-2.7b (attention-free), dbrx-132b (MoE, 4 experts top-2), arctic-480b (MoE beside a dense
residual MLP), llama-3.2-vision-90b (10 layers: two groups of four self
layers and a gated cross layer, 16 image tokens) and musicgen-medium (4
codebooks summed at the input, 4 heads), one JAX parameter tree is
carried across with `convert` and the same token batch goes through both
packages: `forward` (logits and the MoE aux loss), `prefill` (the logits
and every cache entry, the VLM's `img_k` / `img_v` too) and 4
`decode_step`s. On the CPU the port's `attn_block`, `cross_attn_block`
and `ssm_block` run the kernels' plain versions. Tolerances (atol =
rtol): 1e-4 on the attention-only models, 1e-3 where an SSD scan is on
the path (the tolerance of `tests/test_kernels.py` for the scan). The
copied configs and the spec trees must equal the JAX ones for every
architecture.

The VLM's gates `gate_attn` / `gate_ffn` are zeros at init, which makes
every cross layer the identity, and zero image embeddings make its
attention output zero: the fixture opens the gates to seeded values on
the JAX tree (`M.open_cross_gates`) and the batches carry seeded nonzero
image embeddings. `moe_block` is also held against the JAX one where a
router is driven past capacity (the same assignments dropped), where
router probabilities tie (the lowest experts win, as `lax.top_k` picks)
and at the batcher's decode shape (T = n_slots tokens of one position);
`cross_attn_block` at open gates.

The JAX init scales the [d, heads, hd] projections by the fan-in of the
heads axis, which at reduced width gives attention logits of magnitude
~100: the softmax is then one-hot up to near-ties, and float32 summation
order alone moves the JAX package's own jit and eager results apart by
~2e-4. The fixture rescales wq, wk and wv to a d_model fan-in on the JAX
tree (`M.attention_at_d_model_fan_in`) before carrying it across, so both
packages get the same well-conditioned weights.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES as JAX_ARCHITECTURES
from repro.models import layers as jax_layers
from repro.models import model as JM
from repro.models.config import reduced as jax_reduced
from repro.models.params import ParamSpec as JaxParamSpec
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import layers, model as M, ssm
from repro_torch.models.config import reduced
from repro_torch.models.params import init_params, param_count, tree_leaves

CPU = "cpu"
CASES = {
    "hymba": ("hymba-1.5b", dict(sliding_window=16), 1e-3),
    "hymba-gqa": ("hymba-1.5b", dict(sliding_window=16, n_kv_heads=2), 1e-3),
    "qwen": ("qwen2.5-3b", {}, 1e-4),
    "granite": ("granite-3-8b", {}, 1e-4),
    "stablelm": ("stablelm-3b", {}, 1e-4),
    "command-r-plus": ("command-r-plus-104b", {}, 1e-4),
    "mamba2": ("mamba2-2.7b", {}, 1e-3),
    "dbrx": ("dbrx-132b", {}, 1e-4),
    "arctic": ("arctic-480b", {}, 1e-4),
    "vlm": ("llama-3.2-vision-90b", {}, 1e-4),
    "musicgen": ("musicgen-medium", {}, 1e-4),
}
B, S, PROMPT, MAX_LEN = 2, 40, 36, 48


@pytest.fixture(scope="module")
def pairs():
    """name -> (cfg, JAX params, port params), built once per module."""
    out = {}
    for name, (arch, over, _) in CASES.items():
        cfg = reduced(ARCHITECTURES[arch], **over)
        jcfg = jax_reduced(JAX_ARCHITECTURES[arch], **over)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        jp = M.open_cross_gates(cfg, M.attention_at_d_model_fan_in(
            cfg, JM.init(jcfg, jax.random.PRNGKey(0))))
        out[name] = (cfg, jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), CPU))
    return out


def _tokens(cfg, seed=0):
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _batches(cfg, tokens, seed=0):
    """The same batch for both packages; a VLM's with seeded image embeddings."""
    jb, tb = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens)}
    if cfg.cross_attn_every:
        img = np.random.default_rng(seed + 100).normal(
            size=(tokens.shape[0], cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
        jb["image_embeds"], tb["image_embeds"] = jnp.asarray(img), torch.from_numpy(img)
    return jb, tb


def _close(got, ref, tol, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("arch", sorted(JAX_ARCHITECTURES))
def test_configs_and_specs_match_jax(arch):
    cfg, jcfg = get_config(arch), JAX_ARCHITECTURES[arch]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    jax_specs = jax.tree.flatten_with_path(
        JM.make_specs(jcfg), is_leaf=lambda x: isinstance(x, JaxParamSpec))[0]
    ours = list(tree_leaves(M.make_specs(cfg)))
    assert [("/".join(k.key for k in path), s.shape, s.axes, s.init)
            for path, s in jax_specs] == [(p, s.shape, s.axes, s.init) for p, s in ours]
    assert param_count(M.make_specs(cfg)) == sum(int(np.prod(s.shape)) for _, s in jax_specs)
    specs = M.cache_spec(cfg, 3, 100)
    jspecs = JM.cache_spec(jcfg, 3, 100)
    assert {k: v.shape for k, v in specs.items()} == {k: v.shape for k, v in jspecs.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(pairs, case):
    cfg, jcfg, jp, tp = pairs[case]
    tol = CASES[case][2]
    jb, tb = _batches(cfg, _tokens(cfg))
    jl, jaux = JM.forward(jcfg, jp, jb)
    tl, aux = M.forward(cfg, tp, tb)
    assert tl.shape == (B, S) + ((cfg.n_codebooks,) if cfg.n_codebooks else ()) + (
        cfg.vocab_size,)
    assert (float(aux) != 0.0) == (cfg.arch_type == "moe")
    _close(tl, jl, tol, "logits")
    _close(aux, jaux, tol, "aux loss")


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_decode_match_jax(pairs, case):
    cfg, jcfg, jp, tp = pairs[case]
    tol = CASES[case][2]
    toks = _tokens(cfg, seed=1)
    jb, tb = _batches(cfg, toks[:, :PROMPT], seed=1)
    jl, jc = JM.prefill(jcfg, jp, jb, max_cache_len=MAX_LEN)
    tl, tc = M.prefill(cfg, tp, tb, max_cache_len=MAX_LEN)
    _close(tl, jl, tol, "prefill logits")
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape
        _close(tc[k], jc[k], tol, f"prefill cache {k}")
    for step in range(S - PROMPT):
        pos = PROMPT + step
        tok = toks[:, pos:pos + 1]
        jl, jc = JM.decode_step(jcfg, jp, jc, {"token": jnp.asarray(tok),
                                              "pos": jnp.asarray(pos, jnp.int32)})
        tl, tc = M.decode_step(cfg, tp, tc, {"token": torch.from_numpy(tok), "pos": pos})
        _close(tl, jl, tol, f"decode {step} logits")
    for k in jc:
        _close(tc[k], jc[k], tol, f"cache {k} after decode")


def test_prefill_runs_each_kernel_once_per_layer(pairs, monkeypatch):
    """What chip_smoke counts on the card: one rope_heads, one
    flash_attention and one ssd_scan call per hybrid layer of a prefill; on
    the VLM one rope_heads and one causal flash call per self layer and one
    flash call with causal=False per cross layer, in the stack's order, and
    in each decode step the cross layers' flash calls alone."""
    calls = {"flash": [], "ssd": 0, "rope": 0}
    flash, scan, rope_heads = layers.flash_attention, ssm.ssd_ops.ssd_scan, layers.rope_heads

    # the kernel path (the card's choice by device) forced with use_kernel=True;
    # the counted ops then serve the plain versions, as the CPU has no kernel
    def counted_flash(q, k, v, causal=True, **kw):
        calls["flash"].append(causal)
        return flash(q, k, v, causal=causal, **{**kw, "use_kernel": False})

    def counted_scan(*a, **kw):
        calls["ssd"] += 1
        return scan(*a, **{**kw, "use_kernel": False})

    def counted_rope(*a, **kw):
        calls["rope"] += 1
        return rope_heads(*a, **{**kw, "use_kernel": False})

    monkeypatch.setattr(layers, "flash_attention", counted_flash)
    monkeypatch.setattr(layers, "rope_heads", counted_rope)
    monkeypatch.setattr(ssm.ssd_ops, "ssd_scan", counted_scan)
    cfg, _, _, tp = pairs["hymba"]
    M.prefill(cfg, tp, {"tokens": torch.from_numpy(_tokens(cfg)[:1])}, use_kernel=True)
    assert calls == {"flash": [True] * cfg.n_layers, "ssd": cfg.n_layers, "rope": cfg.n_layers}

    cfg, _, _, tp = pairs["vlm"]
    calls["flash"], calls["rope"] = [], 0
    _, tb = _batches(cfg, _tokens(cfg)[:1, :PROMPT])
    _, cache = M.prefill(cfg, tp, tb, max_cache_len=MAX_LEN, use_kernel=True)
    per = cfg.cross_attn_every - 1
    assert calls["flash"] == ([True] * per + [False]) * (cfg.n_layers // cfg.cross_attn_every)
    assert calls["rope"] == per * (cfg.n_layers // cfg.cross_attn_every)
    calls["flash"], calls["rope"] = [], 0
    M.decode_step(cfg, tp, cache, {"token": torch.from_numpy(_tokens(cfg)[:1, :1]),
                                   "pos": PROMPT}, use_kernel=True)
    assert calls["flash"] == [False] * (cfg.n_layers // cfg.cross_attn_every)
    assert calls["rope"] == 0  # decode ropes its one token with the plain `rope`


def test_params_from_jax_carries_bf16():
    """numpy's bf16 (ml_dtypes) does not go through torch.from_numpy."""
    x = jnp.asarray(np.random.default_rng(0).normal(size=(3, 5)), jnp.bfloat16)
    t = params_from_jax({"w": x}, CPU)["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x, np.float32))


@pytest.mark.parametrize("b", [1, 2])
def test_attention_inputs_reach_the_kernel_contiguous(b):
    """The kernel takes contiguous [B*H, S, hd] rows only; at batch 1 a
    permute + reshape would hand it a strided view."""
    x = torch.randn(b, 5, 3, 8)
    rows = layers._heads_major(x)
    assert rows.is_contiguous() and rows.shape == (b * 3, 5, 8)
    assert torch.equal(rows.view(b, 3, 5, 8).permute(0, 2, 1, 3), x)


def test_init_params_kinds_and_scales():
    cfg = reduced(ARCHITECTURES["hymba-1.5b"])
    gen = torch.Generator().manual_seed(0)
    p = M.init(cfg, gen, device=CPU)
    assert all(v.dtype == torch.float32 for _, v in tree_leaves(p))
    assert torch.equal(p["layers"]["ln1"], torch.ones_like(p["layers"]["ln1"]))
    assert not p["layers"]["ssm"]["a_log"].any()
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    wq = p["layers"]["attn"]["wq"]  # [L, d, heads, hd]: fan-in is dim -2, as in JAX
    assert abs(float(wq.std()) * np.sqrt(cfg.n_heads) - 1.0) < 0.05
    again = M.init(cfg, torch.Generator().manual_seed(0), device=CPU)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(p), tree_leaves(again)))
    bf = init_params(M.make_specs(cfg), torch.Generator().manual_seed(0), "bfloat16", CPU)
    assert bf["embed"].dtype == torch.bfloat16
    assert torch.equal(bf["embed"], p["embed"].to(torch.bfloat16))


def _moe_pair(arch="dbrx-132b"):
    """One reduced MoE layer's params in both packages and a matching config."""
    cfg, jcfg = reduced(ARCHITECTURES[arch]), jax_reduced(JAX_ARCHITECTURES[arch])
    jp = jax.tree.map(lambda t: t[0], JM.init(jcfg, jax.random.PRNGKey(0))["layers"]["moe"])
    return cfg, jcfg, {k: np.array(v) for k, v in jp.items()}


def _moe_both(cfg, jcfg, p, x):
    """(port y, port aux, port keep) and (JAX y, JAX aux) of one moe_block."""
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ty, taux = layers.moe_block(tp, torch.from_numpy(x), cfg)
    keep = layers.moe_route(tp, torch.from_numpy(x).reshape(-1, x.shape[-1]), cfg)[4]
    jy, jaux = jax_layers.moe_block({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                    jcfg)
    return (ty, taux, keep), (jy, jaux)


@pytest.mark.parametrize("arch", ["dbrx-132b", "arctic-480b"])
def test_moe_block_past_capacity_drops_as_jax(arch):
    """A router biased toward expert 0 overflows its buffer: the same
    (token, slot) assignments must be dropped, token-major, as in JAX; a
    dropped assignment contributes nothing."""
    cfg, jcfg, p = _moe_pair(arch)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    p["router"] = p["router"].copy()
    p["router"][:, 0] += 0.5 * np.sign(x.reshape(-1, cfg.d_model).mean(0))
    (ty, taux, keep), (jy, jaux) = _moe_both(cfg, jcfg, p, x)
    cap = layers.moe_capacity(48, cfg)
    assert 0 < int((~keep).sum()) and int(keep.sum()) <= cfg.n_experts * cap
    # the first `cap` assignments to expert 0, token-major, are the kept ones
    top_e = layers.moe_route({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x).reshape(-1, cfg.d_model), cfg)[3].reshape(-1)
    to0 = torch.nonzero(top_e == 0)[:, 0]
    assert keep[to0[:cap]].all() and not keep[to0[cap:]].any()
    _close(ty, jy, 1e-5, "y")
    _close(taux, jaux, 1e-5, "aux")


def test_moe_block_ties_pick_the_lowest_experts():
    """A zero router gives every expert the same probability: lax.top_k
    takes experts 0..k-1 for every token, each weighted 1/k."""
    cfg, jcfg, p = _moe_pair()
    p["router"] = np.zeros_like(p["router"])
    x = np.random.default_rng(1).normal(size=(1, 6, cfg.d_model)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _, _, top_w, top_e, _, _ = layers.moe_route(tp, torch.from_numpy(x)[0], cfg)
    k = cfg.experts_per_token
    assert torch.equal(top_e, torch.arange(k).expand(6, k))
    assert torch.allclose(top_w, torch.full((6, k), 1.0 / k))
    (ty, taux, _), (jy, jaux) = _moe_both(cfg, jcfg, p, x)
    _close(ty, jy, 1e-5, "y")
    _close(taux, jaux, 1e-5, "aux")


def test_moe_block_at_the_batchers_decode_shape():
    """The batcher's decode runs [n_slots, 1, D] through the experts, pad
    slots too: T = n_slots sets the capacity (one slot an expert here)."""
    cfg, jcfg, p = _moe_pair()
    n_slots = 3
    x = np.random.default_rng(2).normal(size=(n_slots, 1, cfg.d_model)).astype(np.float32)
    x[2] = 0.0  # an empty slot's row still takes its experts' capacity
    assert layers.moe_capacity(n_slots, cfg) == 2
    (ty, taux, keep), (jy, jaux) = _moe_both(cfg, jcfg, p, x)
    assert keep.numel() == n_slots * cfg.experts_per_token
    _close(ty, jy, 1e-5, "y")
    _close(taux, jaux, 1e-5, "aux")


def test_cross_attn_block_with_open_gates_matches_jax(pairs):
    """One cross layer, gates open, over seeded image K/V: the text stream
    moves (the block is not the identity) as the reference moves it."""
    cfg, jcfg, jp, tp = pairs["vlm"]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, 5, cfg.d_model)).astype(np.float32)
    img = rng.normal(size=(B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    jcross = jax.tree.map(lambda t: t[1], jp["cross"])
    tcross = M._layer(tp["cross"], 1)
    jk, jv = jax_layers.cross_attn_kv(jcross, jnp.asarray(img), jcfg)
    tk, tv = layers.cross_attn_kv(tcross, torch.from_numpy(img), cfg)
    _close(tk, jk, 1e-5, "img_k")
    _close(tv, jv, 1e-5, "img_v")
    jy = jax_layers.cross_attn_block(jcross, jnp.asarray(x), jcfg, jk, jv)
    ty = layers.cross_attn_block(tcross, torch.from_numpy(x), cfg, tk, tv)
    assert float((ty - torch.from_numpy(x)).abs().max()) > 0.1
    _close(ty, jy, 1e-4, "cross layer")
