"""The port's `ContinuousBatcher` against the JAX one, each routing through
its own package's `SemanticRouter`.

Both batchers get the same requests (prompts and `query_tokens` from the
`small_bench` benchmark, made from a seed), the same model weights (one
JAX tree carried across with `convert`) and the same tool table. The port
routes through the `fused` backend (its plain version on the CPU), the JAX
batcher through `dense`. Greedy tokens, tools, table versions and the
admission and retirement ticks must be identical. Reduced qwen2.5-3b has
full attention; reduced hymba-1.5b (window cut to 16, prompts longer than
it, as the JAX batcher needs: ROADMAP.md queue 3) runs both kernels'
plain versions in every prefill; reduced mamba2-2.7b's cache is the SSM's
state alone (no KV), spliced a slot at a time, and reduced granite-3-8b
ties its embeddings. Reduced dbrx-132b runs its decode ticks
through the experts at T = n_slots tokens (pad slots take capacity, as in
the reference), reduced llama-3.2-vision-90b prefills each request with
zero image embeddings and splices its image K/V per slot, and reduced
musicgen-medium's prompts and tokens are frames of 4 codebook ids. As in
`tests/test_torch_models.py`, the attention projections are rescaled to a
d_model fan-in on the JAX tree (`M.attention_at_d_model_fan_in`) so that
float32 summation order cannot flip a near-tie, and the VLM's gates are
opened (`M.open_cross_gates`).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES as JAX_ARCHITECTURES
from repro.embedding.bag_encoder import BagEncoder as JaxBagEncoder
from repro.models import model as JM
from repro.models.config import reduced as jax_reduced
from repro.router.gateway import SemanticRouter as JaxRouter
from repro.router.scheduler import ContinuousBatcher as JaxBatcher
from repro.router.scheduler import Request as JaxRequest
from repro.router.tooldb import ToolRecord as JaxToolRecord
from repro.router.tooldb import ToolsDatabase as JaxToolsDatabase
from repro_torch.configs import ARCHITECTURES
from repro_torch.convert import params_from_jax
from repro_torch.embedding.bag_encoder import BagEncoder
from repro_torch.models import model as M
from repro_torch.models.config import reduced
from repro_torch.router.gateway import SemanticRouter
from repro_torch.router.scheduler import ContinuousBatcher, Request
from repro_torch.router.tooldb import ToolRecord, ToolsDatabase

CPU = "cpu"
# name -> (arch, overrides, prompt lengths [lo, hi), max_len)
POOLS = {
    "qwen": ("qwen2.5-3b", {}, (4, 12), 32),
    "hymba": ("hymba-1.5b", dict(sliding_window=16), (18, 30), 48),
    "mamba2": ("mamba2-2.7b", {}, (4, 12), 32),
    "granite": ("granite-3-8b", {}, (4, 12), 32),
    "dbrx": ("dbrx-132b", {}, (4, 12), 32),
    "vlm": ("llama-3.2-vision-90b", {}, (4, 12), 32),
    "musicgen": ("musicgen-medium", {}, (4, 12), 32),
}


def _models(name):
    arch, over, _, _ = POOLS[name]
    cfg, jcfg = reduced(ARCHITECTURES[arch], **over), jax_reduced(JAX_ARCHITECTURES[arch], **over)
    jp = M.open_cross_gates(cfg, M.attention_at_d_model_fan_in(
        cfg, JM.init(jcfg, jax.random.PRNGKey(0))))
    return cfg, jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), CPU)


def _routers(bench):
    n = bench.n_tools
    table = JaxBagEncoder(bench.vocab).encode(bench.desc_tokens)
    jenc, tenc = JaxBagEncoder(bench.vocab), BagEncoder(bench.vocab, device=CPU)
    jdb = JaxToolsDatabase([JaxToolRecord(i, f"tool_{i}", bench.desc_tokens[i],
                                          int(bench.tool_category[i])) for i in range(n)], table)
    tdb = ToolsDatabase([ToolRecord(i, f"tool_{i}", bench.desc_tokens[i],
                                    int(bench.tool_category[i])) for i in range(n)], table)
    return (JaxRouter(jdb, embed_fn=jenc.encode_one, embed_batch_fn=jenc.encode, k=5,
                      backend="dense", metrics=False),
            SemanticRouter(tdb, embed_fn=tenc.encode_one, embed_batch_fn=tenc.encode, k=5,
                           backend="fused", metrics=False, device=CPU))


def _requests(cfg, bench, lengths, n=7, max_new=5, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        shape = (int(rng.integers(*lengths)),) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
        prompt = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        out.append(dict(request_id=i, prompt=prompt, max_new_tokens=max_new,
                        query_tokens=bench.query_tokens[i]))
    return out


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_batcher_with_router_matches_jax(small_bench, pool):
    cfg, jcfg, jp, tp = _models(pool)
    _, _, lengths, max_len = POOLS[pool]
    jrouter, trouter = _routers(small_bench)
    jb = JaxBatcher(jcfg, jp, n_slots=3, max_len=max_len, router=jrouter)
    tb = ContinuousBatcher(cfg, tp, n_slots=3, max_len=max_len, router=trouter, device=CPU)
    for spec in _requests(cfg, small_bench, lengths):
        jb.submit(JaxRequest(**spec))
        tb.submit(Request(**spec))
    jdone = {r.request_id: r for r in jb.run_until_drained(max_ticks=100)}
    tdone = {r.request_id: r for r in tb.run_until_drained(max_ticks=100)}
    assert sorted(tdone) == sorted(jdone) == list(range(7))
    assert tb.tick_count == jb.tick_count
    for rid, j in jdone.items():
        t = tdone[rid]
        assert t.generated == j.generated, rid
        assert len(t.generated) == t.max_new_tokens
        if cfg.n_codebooks:
            assert all(len(tok) == cfg.n_codebooks for tok in t.generated)
        assert t.tools == j.tools and len(t.tools) == 5
        assert t.route_result.table_version == j.route_result.table_version
        assert (t.admitted_at_tick, t.finished_at_tick) == (j.admitted_at_tick,
                                                            j.finished_at_tick)


def test_batcher_overlaps_and_matches_sequential_decode():
    """Four requests in four slots finish in a few ticks, and a lone request
    through the batcher equals a plain prefill + decode loop."""
    cfg, _, _, tp = _models("qwen")
    rng = np.random.default_rng(2)
    b = ContinuousBatcher(cfg, tp, n_slots=4, max_len=32, device=CPU)
    for i in range(4):
        b.submit(Request(request_id=i, prompt=rng.integers(0, cfg.vocab_size, (8,)),
                         max_new_tokens=6))
    assert b.tick()["active"] == 4  # all admitted in one tick
    assert len(b.run_until_drained(max_ticks=100)) == 4 and b.tick_count <= 12

    prompt = rng.integers(0, cfg.vocab_size, (8,)).astype(np.int32)
    b = ContinuousBatcher(cfg, tp, n_slots=2, max_len=32, device=CPU)
    b.submit(Request(request_id=0, prompt=prompt, max_new_tokens=5))
    (done,) = b.run_until_drained()
    logits, cache = M.prefill(cfg, tp, {"tokens": torch.from_numpy(prompt[None])},
                              max_cache_len=32)
    ref = [int(logits[0, -1].argmax())]
    for pos in range(len(prompt), len(prompt) + 4):
        logits, cache = M.decode_step(cfg, tp, cache, {"token": torch.tensor([[ref[-1]]]),
                                                       "pos": pos})
        ref.append(int(logits[0, -1].argmax()))
    assert done.generated == ref
