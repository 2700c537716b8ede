"""The gateway's tool corpus: a ToolBench-like table scaled to registry size.

A frozen copy of the program's generators (`repro_torch.embedding.vocab.
make_vocab`, `repro_torch.data.benchmarks.make_benchmark` as
`make_toolbench_like` calls it, and `scale_tool_corpus`), kept here so that
a change to the program cannot move the yardstick. What the benchmark needs
of them is kept: the word vectors, the tools' description tokens, the
queries, and the scaled table. Candidate pools and the train/test split are
left out (no route here masks candidates).

Everything is deterministic in `seed`.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

EMBED_DIM = 384  # all-MiniLM-L6-v2's width, the paper's encoder


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def _perturb(rng: np.random.Generator, base: np.ndarray, sigma: float, n: int) -> np.ndarray:
    """n unit vectors at cosine ~1/sqrt(1+sigma^2) from `base`."""
    g = _unit(rng.normal(size=(n, base.shape[-1])))
    return _unit(base[None, :] + sigma * g)


@dataclasses.dataclass
class Vocab:
    """Word-id blocks: topic description words, topic query words, tool
    description words, tool query words, generic words, stop words, tool
    names; `word_vecs` [V, 384] float32 unit rows."""

    word_vecs: np.ndarray
    n_topics: int
    n_tools: int
    topic_words: int
    tool_desc_words: int
    tool_query_words: int
    n_generic: int
    n_stop: int

    @property
    def topic_query_block(self) -> int:
        return self.n_topics * self.topic_words

    @property
    def tool_desc_block(self) -> int:
        return self.topic_query_block + self.n_topics * self.topic_words

    @property
    def tool_query_block(self) -> int:
        return self.tool_desc_block + self.n_tools * self.tool_desc_words

    @property
    def generic_block(self) -> int:
        return self.tool_query_block + self.n_tools * self.tool_query_words

    @property
    def stop_block(self) -> int:
        return self.generic_block + self.n_generic

    @property
    def name_block(self) -> int:
        return self.stop_block + self.n_stop

    @property
    def size(self) -> int:
        return self.name_block + self.n_tools

    def topic_desc_words(self, topic: int) -> np.ndarray:
        b = topic * self.topic_words
        return np.arange(b, b + self.topic_words)

    def topic_query_words(self, topic: int) -> np.ndarray:
        b = self.topic_query_block + topic * self.topic_words
        return np.arange(b, b + self.topic_words)

    def desc_words(self, tool: int) -> np.ndarray:
        b = self.tool_desc_block + tool * self.tool_desc_words
        return np.arange(b, b + self.tool_desc_words)

    def query_words(self, tool: int) -> np.ndarray:
        b = self.tool_query_block + tool * self.tool_query_words
        return np.arange(b, b + self.tool_query_words)

    def generic_words(self) -> np.ndarray:
        return np.arange(self.generic_block, self.generic_block + self.n_generic)

    def stop_words(self) -> np.ndarray:
        return np.arange(self.stop_block, self.stop_block + self.n_stop)

    def name_token(self, tool: int) -> int:
        return self.name_block + tool


def make_vocab(tool_topic: np.ndarray, n_topics: int, *, topic_words=12, tool_desc_words=8,
               tool_query_words=8, n_generic=160, n_stop=64, function_spread=0.9,
               topic_word_noise=0.50, tool_word_noise=0.45, generic_noise=0.40,
               seed: int = 0) -> Vocab:
    rng = np.random.default_rng(seed)
    n_tools = len(tool_topic)
    centroids = _unit(rng.normal(size=(n_topics, EMBED_DIM)))
    generic = _unit(rng.normal(size=(EMBED_DIM,)))
    function = np.stack([_perturb(rng, centroids[tool_topic[i]], function_spread, 1)[0]
                         for i in range(n_tools)])
    blocks = [_perturb(rng, centroids[t], topic_word_noise, topic_words) for t in range(n_topics)]
    blocks += [_perturb(rng, centroids[t], topic_word_noise, topic_words) for t in range(n_topics)]
    blocks += [_perturb(rng, function[i], tool_word_noise, tool_desc_words) for i in range(n_tools)]
    blocks += [_perturb(rng, function[i], tool_word_noise, tool_query_words)
               for i in range(n_tools)]
    blocks.append(_perturb(rng, generic, generic_noise, n_generic))
    blocks.append(_unit(rng.normal(size=(n_stop, EMBED_DIM))))
    blocks.append(_perturb(rng, generic, generic_noise, n_tools))  # opaque tool names
    return Vocab(np.concatenate(blocks).astype(np.float32), n_topics, n_tools, topic_words,
                 tool_desc_words, tool_query_words, n_generic, n_stop)


@dataclasses.dataclass
class Corpus:
    vocab: Vocab
    desc_tokens: List[np.ndarray]  # per tool
    tool_category: np.ndarray  # [T]
    query_tokens: List[np.ndarray]  # per query


def _description(rng, vocab: Vocab, topic, tool, opacity, length, decoy_topic, tool_word_frac):
    toks = [vocab.name_token(tool)]
    n_body = max(length - 1, 4)
    n_func = max(int(round(n_body * (1.0 - opacity))), 1)
    n_generic = n_body - n_func
    n_tool = int(round(n_func * tool_word_frac))
    n_topic = n_func - n_tool
    if n_tool > 0:
        toks.extend(rng.choice(vocab.desc_words(tool), size=n_tool, replace=True))
    if n_topic > 0:
        toks.extend(rng.choice(vocab.topic_desc_words(topic), size=n_topic, replace=True))
    if decoy_topic is not None and n_func >= 2:
        n_swap = max(1, int(0.4 * n_func))
        swap = rng.choice(vocab.topic_desc_words(decoy_topic), size=n_swap, replace=True)
        toks[1:1 + n_swap] = [int(w) for w in swap]
    if n_generic > 0:
        toks.extend(rng.choice(vocab.generic_words(), size=n_generic, replace=True))
    toks.extend(rng.choice(vocab.stop_words(), size=2, replace=True))
    return np.array(toks, dtype=np.int64)


def _query(rng, vocab: Vocab, desc_tokens, tool_topic, gt, lexical_overlap, topic_word_frac,
           name_mention_p, length, noise_words, hard):
    toks: List[int] = []
    per_tool = max(length // max(len(gt), 1), 3)
    for t in gt:
        t = int(t)
        topic = int(tool_topic[t])
        n_copy = int(rng.binomial(per_tool, lexical_overlap))
        n_topic = int(rng.binomial(per_tool, topic_word_frac))
        n_sem = max(per_tool - n_copy - n_topic, 1)
        if n_copy > 0:
            toks.extend(rng.choice(desc_tokens[t], size=n_copy, replace=True))
        if n_topic > 0:
            toks.extend(rng.choice(vocab.topic_desc_words(topic), size=n_topic, replace=True))
        bank = vocab.topic_query_words(topic) if hard else vocab.query_words(t)
        toks.extend(rng.choice(bank, size=n_sem, replace=True))
        if rng.random() < name_mention_p:
            toks.append(vocab.name_token(t))
    if noise_words > 0:
        toks.extend(rng.choice(vocab.stop_words(), size=noise_words, replace=True))
    return np.array(toks, dtype=np.int64)


def toolbench_like(seed: int, n_tools: int, n_queries: int, n_categories: int) -> Corpus:
    """`make_toolbench_like`'s settings: topics of ~8 tools, API-quoting
    queries (lexical overlap 0.18), a third of them over 2-3 tools."""
    rng = np.random.default_rng(seed)
    n_topics = max(n_tools // 8, 4)
    tool_topic = rng.integers(0, n_topics, size=n_tools)
    vocab = make_vocab(tool_topic, n_topics, function_spread=0.9, tool_word_noise=0.40,
                       topic_word_noise=0.50, seed=seed + 1)
    topic_category = rng.integers(0, n_categories, size=n_topics)
    opacity = rng.beta(1.2, 3.0, size=n_tools)
    is_decoy = rng.random(n_tools) < 0.20
    decoy_topic = np.where(is_decoy, rng.integers(0, n_topics, size=n_tools), -1)
    desc = []
    for i in range(n_tools):
        d = int(decoy_topic[i]) if 0 <= decoy_topic[i] != tool_topic[i] else None
        desc.append(_description(rng, vocab, int(tool_topic[i]), i, float(opacity[i]),
                                 12 + int(rng.integers(-2, 3)), d, 0.65))
    subtask_mix = np.array([0.17, 0.33, 0.17, 0.33])  # similar, scenario, reliability, multi
    subtask = rng.choice(4, size=n_queries, p=subtask_mix)
    queries = []
    for j in range(n_queries):
        gt = (rng.choice(n_tools, size=int(rng.integers(2, 4)), replace=False)
              if subtask[j] == 3 else np.array([int(rng.integers(0, n_tools))]))
        noise = 1 + (4 if subtask[j] == 2 else 0)
        queries.append(_query(rng, vocab, desc, tool_topic, gt, 0.18, 0.10, 0.05,
                              9 + int(rng.integers(-2, 3)), noise, bool(rng.random() < 0.27)))
    return Corpus(vocab, desc, topic_category[tool_topic].astype(np.int64), queries)


def scale_tool_corpus(table: np.ndarray, n_tools: int, seed: int, noise: float) -> np.ndarray:
    """Row i is source row i % T; rows past T get iid gaussian noise
    (`noise` a dimension) and are normalised again."""
    base = np.asarray(table, np.float32)
    t = base.shape[0]
    if n_tools < t:
        raise ValueError(f"cannot scale {t} tools down to {n_tools}")
    big = np.tile(base, (-(-n_tools // t), 1))[:n_tools].copy()
    rng = np.random.default_rng(seed)
    clones = big[t:]
    clones += noise * rng.standard_normal(size=clones.shape).astype(np.float32)
    clones /= np.maximum(np.linalg.norm(clones, axis=-1, keepdims=True), 1e-9)
    return big


def bag_encode(word_vecs: np.ndarray, token_lists) -> np.ndarray:
    """Mean of the word vectors, L2-normalised (the bag encoder's ragged
    numpy path); an empty list gives a zero row."""
    out = np.zeros((len(token_lists), word_vecs.shape[1]), dtype=np.float32)
    for i, toks in enumerate(token_lists):
        if len(toks):
            v = word_vecs[np.asarray(toks)].mean(axis=0)
            out[i] = v / max(np.linalg.norm(v), 1e-9)
    return out
