"""Parity of the port's embedding and learned serving stages with JAX.

The encoder (ragged numpy and padded torch paths), the adapter head with a
non-zero second layer, the [7,64,32,1] MLP, the re-ranker with invalid
slots, the param converter, and the benchmark generator. Params and inputs
are made with numpy from a seed and given to both packages. Adapter and MLP
outputs match at atol=1e-5, rtol=1e-5 (float32; CPU BLAS adds in another
order); re-ranked indices must be exactly equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reranker as jax_reranker
from repro.core.adapter import adapter_apply as jax_adapter_apply
from repro.data import benchmarks as jax_benchmarks
from repro.embedding.bag_encoder import BagEncoder as JaxBagEncoder
from repro.embedding.bag_encoder import pad_token_lists as jax_pad_token_lists
from repro.router.stages import StageSet as JaxStageSet
from repro_torch import convert
from repro_torch.core import reranker
from repro_torch.core.adapter import DIM, HIDDEN, adapter_apply
from repro_torch.core.features import N_FEATURES
from repro_torch.core.retrieval import NEG_INF
from repro_torch.data import benchmarks
from repro_torch.embedding.bag_encoder import BagEncoder, pad_token_lists

CPU = "cpu"
TOL = dict(atol=1e-5, rtol=1e-5)


def _adapter_params(seed=0, w2_scale=0.05):
    rng = np.random.default_rng(seed)
    return {
        "w1": (rng.normal(size=(DIM, HIDDEN)) * np.sqrt(2.0 / DIM)).astype(np.float32),
        "b1": (rng.normal(size=(HIDDEN,)) * 0.01).astype(np.float32),
        "w2": (rng.normal(size=(HIDDEN, DIM)) * w2_scale).astype(np.float32),
        "b2": (rng.normal(size=(DIM,)) * 0.01).astype(np.float32),
    }


def _mlp_params(seed=0):
    rng = np.random.default_rng(seed)
    params = {}
    for li, (din, dout) in enumerate(zip(reranker.LAYERS[:-1], reranker.LAYERS[1:])):
        params[f"w{li}"] = (rng.normal(size=(din, dout)) * np.sqrt(2.0 / din)).astype(np.float32)
        params[f"b{li}"] = (rng.normal(size=(dout,)) * 0.1).astype(np.float32)
    return params


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


# --------------------------------------------------------------- encoder
def test_bag_encoder_encode_and_padded_match_jax(small_bench):
    toks = small_bench.query_tokens[:40] + [np.zeros(0, np.int64)]
    jenc = JaxBagEncoder(small_bench.vocab)
    tenc = BagEncoder(small_bench.vocab, device=CPU)
    ragged = tenc.encode(toks)
    np.testing.assert_array_equal(ragged, jenc.encode(toks))  # same numpy code
    ids, mask = pad_token_lists(toks)
    jids, jmask = jax_pad_token_lists(toks)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    padded = tenc.encode_padded(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(
        padded, np.asarray(jenc.encode_padded(jnp.asarray(ids), jnp.asarray(mask))), **TOL
    )
    np.testing.assert_allclose(padded[:-1], ragged[:-1], **TOL)
    assert np.all(padded[-1] == 0.0)  # empty query: zero vector, no NaN


# --------------------------------------------------------------- adapter
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_adapter_apply_matches_jax_with_nonzero_w2(scale):
    params = _adapter_params()
    q = _unit(np.random.default_rng(1).normal(size=(13, DIM))).astype(np.float32)
    ref = np.asarray(jax_adapter_apply({k: jnp.asarray(v) for k, v in params.items()},
                                       jnp.asarray(q), scale))
    out = adapter_apply(convert.params_from_jax(params, CPU), torch.from_numpy(q), scale)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert np.abs(ref - q).max() > 1e-2  # the head really moves the queries
    np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=1), 1.0, atol=1e-5)


def test_stage_set_adapt_queries_matches_jax():
    params = _adapter_params(seed=2)
    q = _unit(np.random.default_rng(3).normal(size=(8, DIM))).astype(np.float32)
    jstages = JaxStageSet(adapter_params={k: jnp.asarray(v) for k, v in params.items()},
                          adapter_scale=0.7)
    tstages = convert.stages_from_jax(adapter_params=params, adapter_scale=0.7, device=CPU)
    assert tstages.active == jstages.active == frozenset({"adapter"})
    out = tstages.adapt_queries(q)
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    np.testing.assert_allclose(out, jstages.adapt_queries(q), **TOL)
    bare = convert.stages_from_jax(device=CPU)
    assert bare.adapt_queries(q) is q and not bare.active


# ------------------------------------------------------------- re-ranker
def test_mlp_forward_matches_jax():
    params = _mlp_params()
    x = np.random.default_rng(4).normal(size=(6, 25, N_FEATURES)).astype(np.float32)
    ref = np.asarray(jax_reranker.mlp_forward({k: jnp.asarray(v) for k, v in params.items()},
                                              jnp.asarray(x)))
    out = reranker.mlp_forward(convert.params_from_jax(params, CPU), torch.from_numpy(x))
    assert out.shape == (6, 25)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("k", [3, 5])
def test_rerank_topk_scored_with_invalid_slots_matches_jax(k):
    params = _mlp_params(seed=5)
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(7, 10, N_FEATURES)).astype(np.float32)
    cand = rng.permutation(100)[:70].reshape(7, 10).astype(np.int64)
    valid = np.ones((7, 10), bool)
    valid[0, 2:] = False  # fewer valid slots than k
    valid[1, :] = False  # no valid slot: all NEG_INF, tie order decides
    valid[2, ::2] = False
    feats[~valid] = 0.0  # the featurizer zeroes invalid slots
    jidx, jscore = jax_reranker.rerank_topk_scored(
        {kk: jnp.asarray(v) for kk, v in params.items()}, jnp.asarray(feats),
        jnp.asarray(cand), k, valid=jnp.asarray(valid),
    )
    tidx, tscore = reranker.rerank_topk_scored(
        convert.params_from_jax(params, CPU), torch.from_numpy(feats),
        torch.from_numpy(cand), k, valid=torch.from_numpy(valid),
    )
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tscore.numpy(), np.asarray(jscore), **TOL)
    assert (tscore.numpy()[1] == np.float32(NEG_INF)).all()
    np.testing.assert_array_equal(
        reranker.rerank_topk(convert.params_from_jax(params, CPU), torch.from_numpy(feats),
                             torch.from_numpy(cand), k, valid=torch.from_numpy(valid)).numpy(),
        np.asarray(jidx),
    )


# ------------------------------------------------------------- converter
def test_params_from_jax_round_trips(small_bench):
    tree = {"adapter": _adapter_params(), "mlp": _mlp_params(), "scale": np.float32(0.5)}
    out = convert.params_from_jax(tree, CPU)
    for group in ("adapter", "mlp"):
        for name, arr in tree[group].items():
            t = out[group][name]
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            assert t.dtype == torch.float32 and tuple(t.shape) == arr.shape
            np.testing.assert_array_equal(t.numpy(), arr)  # a copy, never a transpose
    assert float(out["scale"]) == 0.5
    # the table and the vocab's word vectors cross as plain leaves
    wv = convert.params_from_jax(small_bench.vocab.word_vecs, CPU)
    np.testing.assert_array_equal(wv.numpy(), small_bench.vocab.word_vecs)
    src = _mlp_params()
    t = convert.params_from_jax(src, CPU)
    t["w0"].zero_()  # the converted params own their memory
    assert np.abs(src["w0"]).sum() > 0


# ------------------------------------------------------------ benchmarks
@pytest.mark.parametrize(
    "maker,kwargs",
    [("make_metatool_like", dict(seed=3, n_tools=40, n_queries=200)),
     ("make_toolbench_like", dict(seed=4, n_tools=150, n_queries=60))],
)
def test_make_benchmark_is_token_identical(maker, kwargs):
    jb = getattr(jax_benchmarks, maker)(**kwargs)
    tb = getattr(benchmarks, maker)(**kwargs)
    assert jb.n_tools == tb.n_tools and jb.n_queries == tb.n_queries
    for a, b in zip(jb.desc_tokens, tb.desc_tokens):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jb.query_tokens, tb.query_tokens):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jb.relevant, tb.relevant):
        np.testing.assert_array_equal(a, b)
    assert (jb.candidates is None) == (tb.candidates is None)
    for a, b in zip(jb.candidates or [], tb.candidates or []):
        np.testing.assert_array_equal(a, b)
    for field in ("tool_category", "subtask", "train_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(jb, field), getattr(tb, field))
    np.testing.assert_array_equal(jb.vocab.word_vecs, tb.vocab.word_vecs)
    table = BagEncoder(tb.vocab, device=CPU).encode(tb.desc_tokens)
    np.testing.assert_array_equal(
        benchmarks.scale_tool_corpus(table, 500, seed=2),
        jax_benchmarks.scale_tool_corpus(table, 500, seed=2),
    )
