"""Topic/tool-structured synthetic vocabulary with frozen word vectors.

The offline container has neither MetaTool/ToolBench nor all-MiniLM-L6-v2, so
we reproduce the *geometry class* the paper's analysis relies on (DESIGN.md §2).

Latent structure:
  * topics: unit centroids c_t (function families, e.g. "meeting transcripts");
  * tools: per-tool function vector f_i = unit(c_topic(i) + spread * g_i) —
    each tool occupies a resolvable sub-region of its topic;
  * words: every word vector sits near one of {topic centroid, tool function
    vector, generic-SaaS centroid, isotropic noise}.

Word id layout (contiguous blocks):
  [0, n_topics*topic_words)                 topic-shared description words
  [.., + n_topics*topic_words)              topic-shared query-side words
  [.., + n_tools*tool_desc_words)           tool-specific description words
  [.., + n_tools*tool_query_words)          tool-specific query-side words
  [.., + n_generic)                         generic/brand/marketing words
  [.., + n_stop)                            stopwords (scattered)
  [.., + n_tools)                           unique tool-name tokens (opaque)

Tool-specific *query* words are token-disjoint from description words: they
model paraphrase — semantically adjacent (same f_i neighbourhood) but with no
lexical overlap, which is what separates dense retrieval from BM25.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Vocab", "make_vocab"]

EMBED_DIM = 384  # all-MiniLM-L6-v2 dimension (paper §5.5)


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def _perturb(rng: np.random.Generator, base: np.ndarray, sigma: float, n: int) -> np.ndarray:
    """n unit vectors at controlled angular distance from `base`:
    unit(base + sigma * unit(g)) => cos(base, out) ~= 1/sqrt(1+sigma^2).

    The noise *norm* is sigma (not sigma per coordinate) — in 384-d,
    per-coordinate Gaussian noise would have norm sigma*sqrt(384) and swamp
    the unit centroid entirely.
    """
    g = _unit(rng.normal(size=(n, base.shape[-1])))
    return _unit(base[None, :] + sigma * g)


@dataclasses.dataclass
class Vocab:
    """Frozen synthetic vocabulary."""

    word_vecs: np.ndarray  # [V, 384] float32, unit rows
    n_topics: int
    n_tools: int
    topic_words: int
    tool_desc_words: int
    tool_query_words: int
    n_generic: int
    n_stop: int
    topic_centroids: np.ndarray  # [n_topics, 384]
    tool_function: np.ndarray  # [n_tools, 384] latent f_i (analysis only)
    generic_centroid: np.ndarray  # [384]

    # ---- block offsets -------------------------------------------------
    @property
    def topic_block(self) -> int:
        return 0

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

    # ---- word-id accessors ----------------------------------------------
    def topic_desc_words(self, topic: int) -> np.ndarray:
        b = self.topic_block + topic * self.topic_words
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
        assert tool < self.n_tools
        return self.name_block + tool


def make_vocab(
    *,
    tool_topic: np.ndarray,  # [n_tools] topic assignment
    n_topics: int,
    topic_words: int = 12,
    tool_desc_words: int = 8,
    tool_query_words: int = 8,
    n_generic: int = 160,
    n_stop: int = 64,
    function_spread: float = 0.9,  # tool sub-region spread within its topic (angular)
    topic_word_noise: float = 0.50,
    tool_word_noise: float = 0.45,
    generic_noise: float = 0.40,
    seed: int = 0,
) -> Vocab:
    """Build the frozen vocabulary + word-vector table."""
    rng = np.random.default_rng(seed)
    n_tools = len(tool_topic)
    centroids = _unit(rng.normal(size=(n_topics, EMBED_DIM)))
    generic_centroid = _unit(rng.normal(size=(EMBED_DIM,)))
    tool_function = np.stack(
        [
            _perturb(rng, centroids[tool_topic[i]], function_spread, 1)[0]
            for i in range(n_tools)
        ]
    )

    blocks = []
    # topic-shared description words
    for t in range(n_topics):
        blocks.append(_perturb(rng, centroids[t], topic_word_noise, topic_words))
    # topic-shared query-side words (paraphrase at topic granularity: used by
    # ambiguous queries that name the function family but not the tool)
    for t in range(n_topics):
        blocks.append(_perturb(rng, centroids[t], topic_word_noise, topic_words))
    # tool-specific description words (near f_i)
    for i in range(n_tools):
        blocks.append(_perturb(rng, tool_function[i], tool_word_noise, tool_desc_words))
    # tool-specific query words: same neighbourhood, disjoint tokens (paraphrase)
    for i in range(n_tools):
        blocks.append(_perturb(rng, tool_function[i], tool_word_noise, tool_query_words))
    # generic/brand words near the generic-SaaS centroid
    blocks.append(_perturb(rng, generic_centroid, generic_noise, n_generic))
    # stopwords: scattered, near-isotropic
    blocks.append(_unit(rng.normal(size=(n_stop, EMBED_DIM))))
    # tool-name tokens: opaque — near the generic centroid (a brand name tells
    # the encoder nothing about function: the `buildbetter` failure mode)
    blocks.append(_perturb(rng, generic_centroid, generic_noise, n_tools))

    word_vecs = np.concatenate(blocks, axis=0).astype(np.float32)
    return Vocab(
        word_vecs=word_vecs,
        n_topics=n_topics,
        n_tools=n_tools,
        topic_words=topic_words,
        tool_desc_words=tool_desc_words,
        tool_query_words=tool_query_words,
        n_generic=n_generic,
        n_stop=n_stop,
        topic_centroids=centroids.astype(np.float32),
        tool_function=tool_function.astype(np.float32),
        generic_centroid=generic_centroid.astype(np.float32),
    )
