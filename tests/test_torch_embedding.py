"""The port's text front end against the JAX package's.

`HashTokenizer` (a copy) must give the reference's ids for the same text,
registered tool names included. The MiniLM-shaped encoder, at a small
geometry and at the default all-MiniLM-L6-v2 one, must agree with the
reference within 1e-5 on the same parameters (one JAX tree carried across
with `convert`) over padded batches: rows of different lengths whose
padding the key mask hides and the mean-pool skips.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.embedding import transformer as jax_transformer
from repro.embedding.tokenizer import HashTokenizer as JaxHashTokenizer
from repro.embedding.vocab import make_vocab as jax_make_vocab
from repro_torch.convert import params_from_jax
from repro_torch.embedding import transformer
from repro_torch.embedding.tokenizer import HashTokenizer
from repro_torch.embedding.vocab import make_vocab

CPU = "cpu"
TEXTS = ["Find me the weather in Paris tomorrow!", "", "convert 100 USD to EUR, please",
         "search_flights from SFO to JFK", "tool_3 and tool_17 then tool_3 again"]


def test_tokenizer_ids_equal_the_references():
    topics = np.arange(30) % 5
    jv = jax_make_vocab(tool_topic=topics, n_topics=5, seed=0)
    tv = make_vocab(tool_topic=topics, n_topics=5, seed=0)
    jtok, ttok = JaxHashTokenizer(jv), HashTokenizer(tv)
    names = [f"tool_{i}" for i in range(20)] + ["search_flights"]
    jtok.register_tool_names(names)
    ttok.register_tool_names(names)
    for text in TEXTS:
        ours, theirs = ttok.encode(text), jtok.encode(text)
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs), text
    assert ttok.encode("tool_3")[0] == tv.name_token(3)


@pytest.mark.parametrize("cfg_kwargs", [
    dict(vocab_size=500, n_layers=2, d_model=64, n_heads=4, d_ff=128, max_len=32), {}])
def test_encoder_matches_jax_over_padded_batches(cfg_kwargs):
    jcfg = jax_transformer.EncoderConfig(**cfg_kwargs)
    cfg = transformer.EncoderConfig(**cfg_kwargs)
    jp = jax_transformer.init_encoder(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), CPU)
    assert transformer.encoder_param_count(tp) == jax_transformer.encoder_param_count(jp)
    rng = np.random.default_rng(0)
    lengths = [16, 3, 9, 1]
    ids = rng.integers(0, cfg.vocab_size, (len(lengths), 16)).astype(np.int32)
    mask = (np.arange(16)[None] < np.array(lengths)[:, None]).astype(np.int32)
    ids[mask == 0] = 0  # the pad id
    theirs = np.asarray(jax_transformer.encode(jp, jnp.asarray(ids), jnp.asarray(mask),
                                               n_heads=cfg.n_heads))
    ours = transformer.encode(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                              n_heads=cfg.n_heads)
    assert ours.shape == (len(lengths), cfg.d_model)
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(ours.numpy(), axis=1), 1.0, atol=1e-5)
    # padding is invisible: a row alone, unpadded, encodes the same
    alone = transformer.encode(tp, torch.from_numpy(ids[1:2, :3]), torch.ones((1, 3)),
                               n_heads=cfg.n_heads)
    np.testing.assert_allclose(alone.numpy(), ours[1:2].numpy(), atol=1e-5, rtol=1e-5)


def test_init_encoder_geometry_and_device():
    cfg = transformer.EncoderConfig()
    p = transformer.init_encoder(torch.Generator().manual_seed(0), cfg, device=CPU)
    n = transformer.encoder_param_count(p)
    assert 22e6 < n < 24e6  # ~22M, the paper's encoder
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in p.values())
    assert abs(float(p["tok_emb"].std()) - 0.02) < 1e-3
    assert abs(float(p["wqkv"].std()) * np.sqrt(cfg.d_model) - 1.0) < 0.02
