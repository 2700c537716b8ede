"""Parity of the port's backend model with the JAX reference.

For reduced hymba-1.5b (parallel attention + Mamba-2 in every layer; the
window cut to 16 so that prompts run past it and the ring cache is
rolled), hymba with 2 kv-heads (grouped-query attention inside the
hybrid), qwen2.5-3b (dense, GQA, QKV bias) and mamba2-2.7b (attention-
free), one JAX parameter tree is carried across with `convert` and the
same token batch goes through both packages: `forward`, `prefill` (the
logits and every cache entry) and 4 `decode_step`s. On the CPU the port's
`attn_block` and `ssm_block` run the kernels' plain versions. Tolerances
(atol = rtol): 1e-4 on the attention-only model, 1e-3 where an SSD scan is
on the path (the tolerance of `tests/test_kernels.py` for the scan). The
copied configs and the spec trees must equal the JAX ones for every
architecture; the families the port does not run yet must raise.

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
from repro.models import model as JM
from repro.models.config import reduced as jax_reduced
from repro.models.params import ParamSpec as JaxParamSpec
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import layers, model as M, ssm
from repro_torch.models.config import reduced
from repro_torch.models.params import init_params, param_count, tree_leaves
from repro_torch.router.scheduler import ContinuousBatcher

CPU = "cpu"
CASES = {
    "hymba": ("hymba-1.5b", dict(sliding_window=16), 1e-3),
    "hymba-gqa": ("hymba-1.5b", dict(sliding_window=16, n_kv_heads=2), 1e-3),
    "qwen": ("qwen2.5-3b", {}, 1e-4),
    "mamba2": ("mamba2-2.7b", {}, 1e-3),
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
        jp = M.attention_at_d_model_fan_in(cfg, JM.init(jcfg, jax.random.PRNGKey(0)))
        out[name] = (cfg, jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), CPU))
    return out


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(got, ref, tol, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("arch", sorted(JAX_ARCHITECTURES))
def test_configs_and_specs_match_jax(arch):
    cfg, jcfg = get_config(arch), JAX_ARCHITECTURES[arch]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    if cfg.arch_type not in ("dense", "ssm"):
        return  # their specs raise: test_unported_families_raise
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
    toks = _tokens(cfg)
    jl, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, aux = M.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (B, S, cfg.vocab_size) and float(aux) == 0.0
    _close(tl, jl, tol, "logits")


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_decode_match_jax(pairs, case):
    cfg, jcfg, jp, tp = pairs[case]
    tol = CASES[case][2]
    toks = _tokens(cfg, seed=1)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :PROMPT])}, max_cache_len=MAX_LEN)
    tl, tc = M.prefill(cfg, tp, {"tokens": torch.from_numpy(toks[:, :PROMPT])},
                       max_cache_len=MAX_LEN)
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
    """What chip_smoke counts on the card: one flash_attention and one
    ssd_scan call per hybrid layer of a prefill."""
    cfg, _, _, tp = pairs["hymba"]
    calls = {"flash": 0, "ssd": 0}
    flash, scan = layers.flash_attention, ssm.ssd_ops.ssd_scan

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(layers, "flash_attention", counted("flash", flash))
    monkeypatch.setattr(ssm.ssd_ops, "ssd_scan", counted("ssd", scan))
    M.prefill(cfg, tp, {"tokens": torch.from_numpy(_tokens(cfg)[:1])})
    assert calls == {"flash": cfg.n_layers, "ssd": cfg.n_layers}


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


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama-3.2-vision-90b", "musicgen-medium"])
def test_unported_families_raise(arch):
    cfg = reduced(ARCHITECTURES[arch])
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64)}
    for call in (
        lambda: M.make_specs(cfg),
        lambda: M.cache_spec(cfg, 1, 8),
        lambda: M.init(cfg, torch.Generator(), device=CPU),
        lambda: M.forward(cfg, {}, batch),
        lambda: M.prefill(cfg, {}, batch),
        lambda: M.decode_step(cfg, {}, {}, {"token": batch["tokens"][:, :1], "pos": 0}),
        lambda: ContinuousBatcher(cfg, {}, device=CPU),
    ):
        with pytest.raises(NotImplementedError, match="queue 1, item 8"):
            call()
