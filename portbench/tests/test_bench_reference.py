"""The plain reference agrees with the port, here on the CPU at small
sizes in float32: a granite-shaped dense model and a hymba-shaped hybrid,
for the gateway's top-5, the prefill's last-position logits, the loss and
one AdamW step."""
from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness import toolcorpus
from portbench.harness.weights import leaf_paths, make_weights
from portbench.reference import decoder as ref_decoder
from portbench.reference import route as ref_route
from portbench.reference.adamw import AdamW

DATA = Path(__file__).resolve().parent / "data"
FAMILIES = ("tiny-dense", "tiny-hybrid")


def sizes(name: str) -> dict:
    m = json.loads((DATA / f"{name}.json").read_text())["model"]
    return {**m, "dtype": "float32"}


@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_logits_match_the_port(family):
    from repro_torch.models import model as M
    from repro_torch.models.config import ModelConfig

    m = sizes(family)
    w = make_weights(m, 3, "cpu")
    rng = np.random.default_rng(0)
    # lengths past the window (16) and off the SSD chunk (16)
    prompts = [torch.as_tensor(rng.integers(0, m["vocab_size"], size=s)) for s in (7, 40)]
    ref = ref_decoder.Decoder(m, attn_block=8).last_logits(dict(leaf_paths(w)), prompts)
    for p, r in zip(prompts, ref):
        with torch.no_grad():
            logits, _ = M.prefill(ModelConfig(**m), w, {"tokens": p[None]})
        torch.testing.assert_close(logits[0, -1], r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", FAMILIES)
def test_loss_and_one_adamw_step_match_the_port(family):
    from repro_torch.models.config import ModelConfig
    from repro_torch.training.train_step import TrainConfig, make_train_step

    m = sizes(family)
    tc = dict(learning_rate=1e-3, warmup_steps=0, total_steps=100, weight_decay=0.1,
              grad_clip=1.0)
    params = make_weights(m, 5, "cpu")
    flat0 = {k: v.clone() for k, v in leaf_paths(params)}
    for _, leaf in leaf_paths(params):
        leaf.requires_grad_()
    step, opt = make_train_step(ModelConfig(**m), TrainConfig(**tc, optimizer="adamw"))
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, m["vocab_size"], (2, 24)))
    new, _, met = step(params, opt.init(params), {"tokens": tokens})

    p32 = {k: v.clone().requires_grad_() for k, v in flat0.items()}
    loss = ref_decoder.Decoder(m).loss(p32, tokens)
    torch.testing.assert_close(float(met["loss"]), float(loss.detach()), rtol=1e-5, atol=0)
    grads = torch.autograd.grad(loss, list(p32.values()))
    ref_new = AdamW(tc).update(flat0, dict(zip(p32, grads)))
    for k, v in leaf_paths(new):
        torch.testing.assert_close(v.detach(), ref_new[k], rtol=1e-4, atol=2e-6)


def test_route_top5_matches_the_port():
    from repro_torch.embedding.bag_encoder import BagEncoder
    from repro_torch.router.gateway import SemanticRouter
    from repro_torch.router.tooldb import ToolRecord, ToolsDatabase

    corpus = toolcorpus.toolbench_like(9, 80, 40, 49)
    base = toolcorpus.bag_encode(corpus.vocab.word_vecs, corpus.desc_tokens)
    table = toolcorpus.scale_tool_corpus(base, 2000, 4, 0.02)
    db = ToolsDatabase([ToolRecord(i, str(i), corpus.desc_tokens[i % 80], 0)
                        for i in range(2000)], table)
    enc = BagEncoder(corpus.vocab, device="cpu")
    router = SemanticRouter(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                            backend="fused", metrics=False, device="cpu")
    queries = corpus.query_tokens[:37]
    res = router.route_batch(queries)
    q = ref_route.encode(torch.as_tensor(corpus.vocab.word_vecs), queries)
    err, per_query = ref_route.route_error(q, torch.as_tensor(table),
                                           np.array([r.tools for r in res]),
                                           np.array([r.scores for r in res]))
    assert err <= 1e-6 and len(per_query) == 37
    # a wrong answer is seen: a repeated id, and a tool off the top-5
    bad = np.array([r.tools for r in res])
    bad[0, 1] = bad[0, 0]
    assert ref_route.route_error(q, torch.as_tensor(table), bad,
                                 np.array([r.scores for r in res]))[0] == float("inf")
    bad = np.array([r.tools for r in res])
    bad[3, 4] = int(np.argmin((q[3:4] @ torch.as_tensor(table).T).numpy()))
    assert ref_route.route_error(q, torch.as_tensor(table), bad,
                                 np.array([r.scores for r in res]))[0] > 0.1


def test_chunked_ssd_equals_the_recurrence():
    g = torch.Generator().manual_seed(0)
    s, h, p, n = 37, 3, 4, 5
    x, b, c = (torch.randn(s, h, k, generator=g) for k in (p, n, n))
    dt = torch.nn.functional.softplus(torch.randn(s, h, generator=g))
    a = -torch.rand(h, generator=g) * 4
    torch.testing.assert_close(ref_decoder.ssd(x, dt, a, b, c, 8),
                               ref_decoder.ssd_recurrent(x, dt, a, b, c), rtol=1e-5, atol=1e-5)


def test_weights_are_made_from_the_seed_alone():
    m = sizes("tiny-hybrid")
    a, b = make_weights(m, 11, "cpu"), make_weights(m, 11, "cpu")
    c = make_weights(copy.deepcopy(m), 12, "cpu")
    for (k, x), (_, y), (_, z) in zip(leaf_paths(a), leaf_paths(b), leaf_paths(c)):
        assert torch.equal(x, y)
        if "ln" not in k and "norm" not in k and k.split("/")[-1] not in ("d_skip", "conv_b"):
            assert not torch.equal(x, z), k
