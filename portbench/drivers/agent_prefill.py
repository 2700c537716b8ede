"""Agents' tool-selection turns: route over the gateway, prefill, first token.

A closed loop of `agents` agents, each with one request outstanding and
no think time: an agent sends its next request the moment its previous
one has its first token. Admission works as the program's
`ContinuousBatcher._admit` does it: the queued requests not yet routed go
through one `SemanticRouter.route_batch`, then each is prefilled alone
(`repro_torch.models.model.prefill`, batch 1) and its first token taken
greedily to the host. A prompt starts with the routed tools' ids (the
tool schemas it would carry) and goes on with seeded Zipf tokens.

Request i's query, prompt length and prompt tokens are fixed by the seed
before the window. Prompt lengths come in blocks: each block is the same
`length_block` log-spaced lengths from `prompt_min` to `prompt_max`, in
an order drawn from the seed, so every seed serves the same set of sizes.

Samples: ttft_s a request, route_s a route_batch call. Counts:
prompt_tokens, route_score_ms (the router's own score-phase mean). Work
(and, in a traced segment, trace_work): prefill (prompt lengths), route
(queries a call), gateway (the table's shape).
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import Dict, List

import numpy as np
import torch

from portbench.harness.runner import TRACE_SHARE, Run, seed_of
from portbench.harness.toolcorpus import bag_encode, scale_tool_corpus, toolbench_like
from portbench.harness.streams import ZipfQueries
from portbench.harness.trace import Recorder, traced
from portbench.harness.weights import leaf_paths, make_weights
from portbench.reference import decoder as ref_decoder
from portbench.reference import route as ref_route


class _Request:
    __slots__ = ("i", "query", "sent", "tools", "scores")

    def __init__(self, i, query, sent):
        self.i, self.query, self.sent = i, query, sent
        self.tools = self.scores = None


def _lengths(mix: Dict, n: int, seed: int) -> np.ndarray:
    lo, hi, block = mix["prompt_min"], mix["prompt_max"], mix["length_block"]
    base = np.round(np.exp(np.linspace(math.log(lo), math.log(hi), block))).astype(np.int64)
    rng = np.random.default_rng(seed)
    return np.concatenate([base[rng.permutation(block)] for _ in range(-(-n // block))])[:n]


def _intents(corpus, mix: Dict, seed: int) -> List[np.ndarray]:
    """The pool's intents: the corpus's queries, each cut or topped up with
    stop words to a length drawn from [query_min, query_max]."""
    rng = np.random.default_rng(seed)
    stops = corpus.vocab.stop_words()
    out = []
    for q in corpus.query_tokens:
        n = int(rng.integers(mix["query_min"], mix["query_max"] + 1))
        out.append(q[:n] if len(q) >= n else
                   np.concatenate([q, rng.choice(stops, size=n - len(q))]).astype(np.int64))
    return out


def setup(cell, seed: int, device: torch.device, run: Run):
    from repro_torch.embedding.bag_encoder import BagEncoder
    from repro_torch.models import model as M
    from repro_torch.models.config import ModelConfig
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.router.gateway import SemanticRouter
    from repro_torch.router.tooldb import ToolRecord, ToolsDatabase

    mix, gw, m = cell.mix, cell.gateway, cell.model
    cfg = ModelConfig(**m)
    weights = make_weights(m, seed_of(seed, 1), device)

    corpus = toolbench_like(seed_of(seed, 2), gw["base_tools"], mix["intents"],
                            gw["categories"])
    base = bag_encode(corpus.vocab.word_vecs, corpus.desc_tokens)
    table = scale_tool_corpus(base, gw["tools"], seed_of(seed, 3), gw["clone_noise"])
    n_base = len(corpus.desc_tokens)
    db = ToolsDatabase([ToolRecord(i, f"tool_{i}", corpus.desc_tokens[i % n_base],
                                   int(corpus.tool_category[i % n_base]))
                        for i in range(gw["tools"])], table)
    registry = MetricsRegistry()
    encoder = BagEncoder(corpus.vocab, device=device)
    router = SemanticRouter(db, embed_fn=encoder.encode_one, embed_batch_fn=encoder.encode,
                            k=gw["k"], backend=gw["backend"], metrics=registry, device=device)

    n_max = mix["max_requests"]
    queries = ZipfQueries(_intents(corpus, mix, seed_of(seed, 4)), mix["zipf_s"],
                          mix["intents"], mix["paraphrase_p"], mix["jitter"],
                          corpus.vocab.size, seed_of(seed, 5))
    query_list = [queries.next() for _ in range(n_max)]
    lengths = _lengths(mix, n_max, seed_of(seed, 6))
    rng = np.random.default_rng(seed_of(seed, 7))
    zipf = 1.0 / np.arange(1, m["vocab_size"] + 1) ** mix["token_zipf_a"]
    stream = rng.choice(m["vocab_size"], size=mix["token_stream"], p=zipf / zipf.sum())
    offsets = rng.integers(0, mix["token_stream"] - mix["prompt_max"], size=n_max)

    state = dict(cfg=cfg, M=M, weights=weights, router=router, registry=registry,
                 table=table, word_vecs=corpus.vocab.word_vecs, queries=query_list,
                 lengths=lengths, stream=stream, offsets=offsets, device=device,
                 m=m, mix=mix, gw=gw, seed=seed, done=[], issued=0)

    # warm-up: each route bucket a batch of 1 to `agents` queries pads to,
    # and the longest and shortest prompts
    router.index.warm(mix["agents"], [gw["k"]])
    for n in range(1, mix["agents"] + 1):
        router.route_batch(query_list[:n])
    for s in (mix["prompt_max"], mix["prompt_min"], mix["prompt_max"]):
        _prefill(state, _prompt(state, 0, s, [0] * gw["k"]), Recorder(False))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.work["gateway"] = [dict(tools=gw["tools"], dim=table.shape[1], k=gw["k"])]
    return state


def _prompt(state, i: int, length: int, tools) -> np.ndarray:
    k = len(tools)
    body = state["stream"][state["offsets"][i]:state["offsets"][i] + length - k]
    return np.concatenate([np.asarray(tools, np.int64) % state["m"]["vocab_size"], body])


def _prefill(state, prompt: np.ndarray, rec: Recorder):
    """The timed path: prefill at batch 1, the greedy first token on the
    host. (logits [V] on the device, token)."""
    M, cfg = state["M"], state["cfg"]
    with torch.no_grad():
        with rec.span("prefill"):
            batch = {"tokens": torch.as_tensor(prompt[None], device=state["device"])}
            logits, cache = M.prefill(cfg, state["weights"], batch)
            del cache
        with rec.span("first_token"):
            tok = int(torch.argmax(logits[:, -1], dim=-1).cpu()[0])
    return logits[0, -1], tok


def _loop(state, seconds: float, rec: Recorder, work: Dict, samples: Dict) -> float:
    """The closed loop until the first admission cycle that ends past
    `seconds`; the seconds from the first request sent to the last first
    token. Every request of every cycle finishes and counts."""
    mix, router = state["mix"], state["router"]
    lengths, queries = state["lengths"], state["queries"]
    t0 = time.perf_counter()
    deadline = t0 + seconds
    queue = deque()
    for _ in range(mix["agents"]):
        queue.append(_Request(state["issued"], queries[state["issued"]], t0))
        state["issued"] += 1
    while True:
        pending = list(queue)
        queue.clear()
        with rec.span("route"):
            ta = time.perf_counter()
            results = router.route_batch([r.query for r in pending])
            samples.setdefault("route_s", []).append(time.perf_counter() - ta)
        work.setdefault("route", []).append(len(pending))
        for r, res in zip(pending, results):
            r.tools, r.scores = res.tools, res.scores
            prompt = _prompt(state, r.i, int(lengths[r.i]), r.tools)
            logits, tok = _prefill(state, prompt, rec)
            now = time.perf_counter()
            samples.setdefault("ttft_s", []).append(now - r.sent)
            work.setdefault("prefill", []).append(len(prompt))
            state["done"].append(dict(r=r, prompt=prompt, logits=logits, token=tok))
            if state["issued"] >= len(lengths):
                raise RuntimeError(f"the mix's max_requests ({len(lengths)}) ran out")
            queue.append(_Request(state["issued"], queries[state["issued"]], now))
            state["issued"] += 1
        if now >= deadline:
            return now - t0


def window(state, seconds: float, trace: bool, run: Run) -> None:
    """The measured window, untraced; with `trace`, then a traced segment of
    TRACE_SHARE of its length (its work under run.trace_work)."""
    score = state["registry"].histogram("route_phase_ms", phase="score")
    n0, sum0 = score.count(), score.mean() * score.count()  # the warm-up's
    run.window_s = _loop(state, seconds, Recorder(False), run.work, run.samples)
    n1 = score.count()
    run.counts["route_score_ms"] = ((score.mean() * n1 - sum0) / (n1 - n0) if n1 > n0
                                    else math.nan)
    run.counts["prompt_tokens"] = float(sum(run.work["prefill"]))
    if trace:
        run.trace_work["gateway"] = run.work["gateway"]
        with traced(state["device"]) as rec:
            rec.window_s = _loop(state, seconds * TRACE_SHARE, rec, run.trace_work, {})
        run.trace = rec.trace
    run.attempted = len(state["done"])


def release(state) -> None:
    """Free the program's state; the benchmark's inputs (weights, table,
    word vectors, prompts) and the program's outputs stay."""
    state["router"].close()
    for key in ("router", "registry", "cfg", "M"):
        state.pop(key, None)


def _sample(state) -> List[int]:
    """The requests whose first token is checked: the longest finished and
    others drawn from the seed, `check_requests` in all."""
    done = state["done"]
    rng = np.random.default_rng(seed_of(state["seed"], 8))
    longest = int(np.argmax([len(d["prompt"]) for d in done]))
    others = [int(i) for i in rng.permutation(len(done)) if i != longest]
    return [longest] + others[:state["mix"]["check_requests"] - 1]


def _reference_logits(state, sample: List[int], precision: str) -> List[torch.Tensor]:
    flat = dict(leaf_paths(state["weights"]))
    dec = ref_decoder.Decoder(state["m"], ref_decoder.Precision(precision))
    prompts = [torch.as_tensor(state["done"][i]["prompt"], device=state["device"])
               for i in sample]
    return dec.last_logits(flat, prompts)


def check(state, run: Run) -> Dict[str, float]:
    """route_err: every routed query's answer against the exact top-k
    (`reference.route.route_error`); over the sample (`_sample`),
    logit_gap: by how much the served token's reference logit lies below
    the reference's best, and logit_err: the largest |program - reference|
    last-position logit over the reference's largest |logit|."""
    device, done = state["device"], state["done"]
    table = torch.as_tensor(state["table"], device=device)
    word_vecs = torch.as_tensor(state["word_vecs"], device=device)
    q = ref_route.encode(word_vecs, [d["r"].query for d in done])
    ids = np.array([d["r"].tools for d in done], dtype=np.int64)
    got = np.array([d["r"].scores for d in done], dtype=np.float32)
    route_err, _ = ref_route.route_error(q, table, ids, got)
    del table, q
    sample = _sample(state)
    gap, err = 0.0, 0.0
    for i, lr in zip(sample, _reference_logits(state, sample, "float32")):
        d = done[i]
        gap = max(gap, float(lr.max() - lr[d["token"]]))
        err = max(err, float((d["logits"].float() - lr).abs().max() / lr.abs().max()))
    run.counts["checked_requests"] = len(sample)
    return {"route_err": route_err, "logit_gap": gap, "logit_err": err}


def control(state, run: Run) -> Dict[str, float]:
    """The numbers with the control in the program's place: the routes'
    top-k of TF32 scores, and the sample's logits from the reference with
    fp8 products (its greedy token served)."""
    device, done = state["device"], state["done"]
    table = torch.as_tensor(state["table"], device=device)
    word_vecs = torch.as_tensor(state["word_vecs"], device=device)
    q = ref_route.encode(word_vecs, [d["r"].query for d in done])
    ids, vals = ref_route.control_answers(q, table, state["gw"]["k"])
    for d, i, v in zip(done, ids, vals):
        d["r"].tools, d["r"].scores = i.tolist(), v.tolist()
    del table, q
    sample = _sample(state)
    for i, low in zip(sample, _reference_logits(state, sample, "fp8")):
        done[i]["logits"], done[i]["token"] = low, int(torch.argmax(low))
    return check(state, run)
