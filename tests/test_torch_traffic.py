"""The port's traffic plane: `tests/test_traffic.py`'s cases as port cases
(generator determinism, Zipf concentration, paraphrase proximity under a
bag encoder, hot-set rotation and bursts, the harness's staleness gate and
agreement), and parity with the JAX package's copy: the same config makes
the identical stream in both, and `drive` and `agreement` report the same
on the same results."""
import numpy as np
import pytest

from repro.traffic import TrafficConfig as JaxTrafficConfig
from repro.traffic import ZipfTrafficGenerator as JaxTrafficGenerator
from repro.traffic import agreement as jax_agreement
from repro.traffic import drive as jax_drive
from repro_torch.traffic import (
    TrafficConfig,
    ZipfTrafficGenerator,
    agreement,
    drive,
)

D = 32


def _embed_batch(token_lists):
    out = []
    for t in token_lists:
        v = np.bincount(np.asarray(t, np.int64) % D, minlength=D)
        v = v.astype(np.float32)
        out.append(v / np.linalg.norm(v))
    return np.stack(out)


# --------------------------------------------------------------- generator


def test_same_config_emits_identical_stream():
    cfg = TrafficConfig(pool_size=32, batch_size=8, seed=9, burstiness=0.4,
                        paraphrase_p=0.5)
    a = list(ZipfTrafficGenerator(cfg).stream(12))
    b = list(ZipfTrafficGenerator(cfg).stream(12))
    assert len(a) == len(b)
    for ba, bb in zip(a, b):
        assert len(ba) == len(bb)
        for qa, qb in zip(ba, bb):
            assert np.array_equal(qa, qb)


def test_zipf_exponent_concentrates_the_hot_set():
    def distinct_fraction(s):
        cfg = TrafficConfig(zipf_s=s, pool_size=128, batch_size=32,
                            paraphrase_p=0.0, seed=1)
        gen = ZipfTrafficGenerator(cfg)
        seen = set()
        total = 0
        for batch in gen.stream(20):
            for q in batch:
                seen.add(q.tobytes())
                total += 1
        return len(seen) / total

    # hotter exponent -> fewer distinct intents behind the same volume
    assert distinct_fraction(1.6) < distinct_fraction(0.9)


def test_paraphrase_stays_near_duplicate_under_bag_encoder():
    cfg = TrafficConfig(pool_size=4, batch_size=16, query_len=24,
                        paraphrase_p=1.0, jitter_tokens=1, seed=2)
    gen = ZipfTrafficGenerator(cfg)
    originals = _embed_batch(gen._pool)
    batch = gen.next_batch()
    emb = _embed_batch(batch)
    # every jittered request stays close to SOME pool intent (length is
    # preserved: drop one of 24 tokens, append a fresh one -> cosine ~0.96)
    best = (emb @ originals.T).max(axis=1)
    assert (best > 0.9).all()
    # and the jitter is real: token rows differ from every original
    assert all(
        not any(np.array_equal(q, p) for p in gen._pool) for q in batch
    )


def test_pool_queries_are_cycled_and_validated():
    pool = [np.arange(10, dtype=np.int64), np.arange(50, 62, dtype=np.int64)]
    cfg = TrafficConfig(pool_size=5, batch_size=4, paraphrase_p=0.0, seed=3)
    gen = ZipfTrafficGenerator(cfg, pool=pool)
    assert len(gen._pool) == 5
    assert np.array_equal(gen._pool[0], gen._pool[2])  # cycled modulo 2
    with pytest.raises(AssertionError):
        ZipfTrafficGenerator(
            TrafficConfig(jitter_tokens=2, seed=3),
            pool=[np.arange(3, dtype=np.int64)],  # too short to jitter
        )


def test_hot_set_rotation_changes_the_stream():
    base = dict(zipf_s=1.4, pool_size=64, batch_size=16, paraphrase_p=0.0)
    steady = ZipfTrafficGenerator(TrafficConfig(seed=4, **base))
    rotating = ZipfTrafficGenerator(
        TrafficConfig(seed=4, hot_set_rotate_every=3, **base))
    steady_stream = list(steady.stream(9))
    rotating_stream = list(rotating.stream(9))
    # identical until the first rotation boundary...
    for qa, qb in zip(steady_stream[0], rotating_stream[0]):
        assert np.array_equal(qa, qb)
    # ...then the rank->intent remap makes the streams diverge
    diverged = any(
        not np.array_equal(qa, qb)
        for ba, bb in zip(steady_stream[3:], rotating_stream[3:])
        for qa, qb in zip(ba, bb)
    )
    assert diverged


def test_burstiness_varies_batch_sizes():
    flat = ZipfTrafficGenerator(TrafficConfig(batch_size=16, seed=5))
    sizes = {len(b) for b in flat.stream(10)}
    assert sizes == {16}
    bursty = ZipfTrafficGenerator(
        TrafficConfig(batch_size=16, burstiness=0.6, seed=5))
    burst_sizes = [len(b) for b in bursty.stream(20)]
    assert len(set(burst_sizes)) > 1
    assert min(burst_sizes) >= 1


# ----------------------------------------------------------------- harness


class _Result:
    def __init__(self, tools, tv, sv, cache_hit=False):
        self.tools = tools
        self.scores = [1.0] * len(tools)
        self.table_version = tv
        self.stage_version = sv
        self.cache_hit = cache_hit


class _FakeRouter:
    """Duck-typed router: serves canned versions, optionally stale."""

    def __init__(self, stale_at=None):
        class _Db:
            table_version = 5
        self.db = _Db()
        self.stage_version = 2
        self._stale_at = stale_at
        self._calls = 0

    def route_batch(self, batch):
        self._calls += 1
        tv = self.db.table_version
        if self._stale_at is not None and self._calls == self._stale_at:
            tv = self.db.table_version - 1  # a dead snapshot leaked out
        return [_Result([1], tv, self.stage_version, cache_hit=True)
                for _ in batch]


def _batches(n=4, size=3):
    rng = np.random.default_rng(6)
    return [[rng.integers(0, 50, size=8) for _ in range(size)]
            for _ in range(n)]


def test_drive_reports_clean_run():
    rep = drive(_FakeRouter(), _batches(), record=True)
    assert rep.batches == 4 and rep.queries == 12
    assert rep.stale_serves == 0 and rep.stale_examples == []
    assert rep.hit_rate == 1.0
    assert rep.qps > 0 and rep.p99_ms >= rep.p50_ms >= 0
    assert len(rep.results) == 4


def test_drive_staleness_gate_catches_dead_snapshot():
    rep = drive(_FakeRouter(stale_at=3), _batches())
    assert rep.stale_serves == 3  # every result of the stale batch
    ex = rep.stale_examples[0]
    assert ex["batch"] == 2 and ex["served"] == [4, 2]
    assert ex["window"] == [[5, 2], [5, 2]]


def test_drive_on_batch_hook_sees_version_moves_inside_window():
    router = _FakeRouter()

    def bump(i):
        if i == 2:
            router.db.table_version += 1  # concurrent swap before batch 2

    rep = drive(router, _batches(), on_batch=bump)
    # swap landed BEFORE the window was read -> still a clean run
    assert rep.stale_serves == 0


def test_agreement_compares_top1_per_query():
    a = [[_Result([1, 2], 1, 1), _Result([3], 1, 1)]]
    b = [[_Result([1, 9], 1, 1), _Result([4], 1, 1)]]
    assert agreement(a, a) == 1.0
    assert agreement(a, b) == pytest.approx(0.5)
    empty_a = [[_Result([], 1, 1)]]
    empty_b = [[_Result([], 1, 1)]]
    assert agreement(empty_a, empty_b) == 1.0  # empty agrees with empty
    assert agreement(empty_a, [[_Result([1], 1, 1)]]) == 0.0


# ------------------------------------------------------------------ parity


@pytest.mark.parametrize("cfg", [
    dict(pool_size=32, batch_size=8, seed=9, burstiness=0.4, paraphrase_p=0.5),
    dict(zipf_s=1.1, pool_size=256, query_len=24, batch_size=32, paraphrase_p=0.35,
         jitter_tokens=1, seed=3, hot_set_rotate_every=30),
    dict(zipf_s=1.6, pool_size=16, batch_size=5, paraphrase_p=1.0, jitter_tokens=2, seed=7),
])
def test_stream_matches_jax(cfg):
    pool = [np.arange(i, i + 10 + i % 7, dtype=np.int64) for i in range(40)]
    for kw in ({}, {"pool": pool}):
        ours = list(ZipfTrafficGenerator(TrafficConfig(**cfg), **kw).stream(20))
        theirs = list(JaxTrafficGenerator(JaxTrafficConfig(**cfg), **kw).stream(20))
        assert [len(b) for b in ours] == [len(b) for b in theirs]
        for ba, bb in zip(ours, theirs):
            for qa, qb in zip(ba, bb):
                assert qa.dtype == qb.dtype
                np.testing.assert_array_equal(qa, qb)


def test_drive_and_agreement_match_jax():
    def bump_every_third(router):
        def on_batch(i):
            if i % 3 == 2:
                router.db.table_version += 1
        return on_batch

    reports = []
    for run, agree in ((drive, agreement), (jax_drive, jax_agreement)):
        router = _FakeRouter(stale_at=4)
        rep = run(router, _batches(n=6), on_batch=bump_every_third(router), record=True)
        clean = run(_FakeRouter(), _batches(n=6), record=True)
        reports.append((rep.batches, rep.queries, rep.hit_rate, rep.stale_serves,
                        rep.stale_examples, agree(rep.results, clean.results)))
    assert reports[0] == reports[1]
