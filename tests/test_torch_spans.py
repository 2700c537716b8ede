"""The port's program spans (`repro_torch.obs.trace.span` / `recording`).

The recorder: nesting, parents and roots; per-thread stacks; the capacity
and its drop count; nothing recorded, and one shared no-op returned, while
no recording is open; the clock offset that puts `perf_ns` stamps on
`wall_ns`. The programs, on the reduced dense (granite-3-8b) and hybrid
(hymba-1.5b) configurations: the span tree of a prefill and of a train
step; logits, loss, gradients and updated parameters bitwise equal with
recording on and off; no span synchronises or reads a device value.
`route_batch`: its spans' durations are the `route_phase_ms` samples of
the same batch.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch import optim
from repro_torch.configs import ARCHITECTURES
from repro_torch.models import model as M
from repro_torch.models.config import reduced
from repro_torch.obs import clock, trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import recording, span
from repro_torch.optim.base import tree_leaves
from repro_torch.router.gateway import SemanticRouter
from repro_torch.router.tooldb import ToolRecord, ToolsDatabase
from repro_torch.training.train_step import TrainConfig, make_train_step

CONFIGS = {"dense": ("granite-3-8b", {}), "hybrid": ("hymba-1.5b", dict(sliding_window=16))}
S = 40


@pytest.fixture(scope="module")
def models():
    out = {}
    for kind, (arch, over) in CONFIGS.items():
        cfg = reduced(ARCHITECTURES[arch], **over)
        out[kind] = (cfg, M.init(cfg, torch.Generator().manual_seed(0), device="cpu"))
    return out


def _tokens(cfg, b=1, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (b, S), generator=gen)


def _children(spans, i):
    return [s.name for s in spans if s.parent == i]


# ------------------------------------------------------------------ recorder
def test_spans_nest_with_parent_and_root():
    with recording() as rec:
        with span("a", tokens=7):
            with span("a.b", layer=3):
                with span("a.b.c"):
                    pass
            with span("a.d"):
                pass
        with span("e", queries=2):
            pass
    spans = rec.spans()
    assert [(s.name, s.parent, s.root, s.attrs) for s in spans] == [
        ("a", -1, 0, {"tokens": 7}), ("a.b", 0, 0, {"layer": 3}), ("a.b.c", 1, 0, {}),
        ("a.d", 0, 0, {}), ("e", -1, 4, {"queries": 2})]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert rec.dropped == 0


def test_stacks_are_per_thread():
    started, release = threading.Barrier(2, timeout=10), threading.Event()

    def worker(name):
        with span(name):
            started.wait()
            release.wait(10)
            with span(name + ".inner"):
                pass

    with recording() as rec:
        with span("main"):
            t = threading.Thread(target=worker, args=("thread",))
            t.start()
            started.wait()
            with span("main.inner"):
                release.set()
            t.join(10)
    assert not t.is_alive()
    by = {s.name: (i, s) for i, s in enumerate(rec.spans())}
    assert by["thread"][1].parent == -1 and by["thread"][1].root == by["thread"][0]
    assert by["thread.inner"][1].parent == by["thread"][0]
    assert by["main.inner"][1].parent == by["main"][0]


def test_capacity_bounds_the_spans_and_counts_the_dropped():
    with recording(capacity=3) as rec:
        for _ in range(2):
            with span("outer"):
                with span("inner"):
                    pass
        with span("late"):
            pass
    assert [s.name for s in rec.spans()] == ["outer", "inner", "outer"]
    assert rec.dropped == 2
    with pytest.raises(ValueError):
        with recording(capacity=0):
            pass


def test_off_records_nothing_and_returns_the_shared_noop():
    assert not trace.recording_on()
    a, b = span("x"), span("y", layer=1)
    assert a is b and type(a).__name__ == "_NoSpan"
    with a:
        pass
    trace.record("route.batch", 0.0, 1.0, [("route.embed", 0.0, 1.0)], queries=1)
    with recording() as rec:
        assert trace.recording_on() and span("x") is not a
        with pytest.raises(RuntimeError):
            with recording():
                pass
    assert rec.spans() == [] and not trace.recording_on()
    with span("after"):
        pass
    assert rec.spans() == []


def test_spans_are_read_out_on_the_wall_clock():
    with recording() as rec:
        w0 = clock.wall_ns()
        with span("now"):
            pass
        w1 = clock.wall_ns()
    (s,) = rec.spans()
    assert w0 - 1_000_000 <= s.start_ns <= s.end_ns <= w1 + 1_000_000


def test_a_span_open_when_recording_stops_ends_at_the_stop():
    rec_cm = recording()
    rec = rec_cm.__enter__()
    opened = span("left-open")
    opened.__enter__()
    rec_cm.__exit__(None, None, None)
    opened.__exit__(None, None, None)
    (s,) = rec.spans()
    assert s.end_ns >= s.start_ns


# ------------------------------------------------------------------ programs
@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_prefill_records_the_span_tree(models, kind):
    cfg, params = models[kind]
    with torch.no_grad(), recording() as rec:
        M.prefill(cfg, params, {"tokens": _tokens(cfg)})
    spans = rec.spans()
    assert spans[0].name == "model.prefill" and spans[0].attrs == {"tokens": S}
    assert all(s.root == 0 for s in spans)
    top = _children(spans, 0)
    assert top == ["model.embed"] + ["model.layer"] * cfg.n_layers + ["model.logits"]
    layers = [i for i, s in enumerate(spans) if s.name == "model.layer"]
    assert [spans[i].attrs for i in layers] == [{"layer": n} for n in range(cfg.n_layers)]
    for i in layers:
        want = ["model.attn", "model.ssm", "model.ffn"] if cfg.hybrid else ["model.attn",
                                                                           "model.ffn"]
        assert _children(spans, i) == want
    for i, s in enumerate(spans):
        if s.name == "model.attn":
            assert _children(spans, i) == ["model.attn.core"]
        if s.name == "model.ssm":
            assert _children(spans, i) == ["model.ssm.scan"]
    assert ("model.ssm" in {s.name for s in spans}) == bool(cfg.hybrid)


def _train(cfg, params, n=2):
    step_fn, opt = make_train_step(cfg, TrainConfig(learning_rate=1e-3, warmup_steps=1,
                                                    total_steps=10, optimizer="adamw"))
    params = optim.tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    state = opt.init(params)
    out = []
    for i in range(n):
        batch = {"tokens": _tokens(cfg, b=2, seed=10 + i)}
        loss, _ = M.loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        params, state, met = step_fn(params, state, batch)
        out.append((loss.detach(), [g.detach() for g in grads], met))
    return out, params


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_train_step_records_its_four_parts(models, kind):
    cfg, params = models[kind]
    step_fn, opt = make_train_step(cfg, TrainConfig(optimizer="adamw"))
    params = optim.tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    state = opt.init(params)
    with recording() as rec:
        step_fn(params, state, {"tokens": _tokens(cfg, b=2)})
    spans = rec.spans()
    assert spans[0].name == "train.step" and spans[0].attrs == {"tokens": 2 * S}
    assert _children(spans, 0) == ["train.forward", "train.backward", "train.clip",
                                   "train.update"]
    fwd = [s.name for s in spans].index("train.forward")
    assert _children(spans, fwd) == (["model.embed"] + ["model.layer"] * cfg.n_layers
                                     + ["model.logits"])


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_recording_changes_no_number(models, kind):
    cfg, params = models[kind]
    batch = {"tokens": _tokens(cfg, seed=3)}
    with torch.no_grad():
        off = M.prefill(cfg, params, batch)[0]
    with torch.no_grad(), recording():
        on = M.prefill(cfg, params, batch)[0]
    assert torch.equal(off, on)
    (runs_off, p_off) = _train(cfg, params)
    with recording():
        (runs_on, p_on) = _train(cfg, params)
    for (l0, g0, m0), (l1, g1, m1) in zip(runs_off, runs_on):
        assert torch.equal(l0, l1)
        assert all(torch.equal(a, b) for a, b in zip(g0, g1))
        assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p_off), tree_leaves(p_on)))


def test_spans_never_wait_for_the_device(models, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a span waited for the device")

    cfg, params = models["hybrid"]
    step_fn, opt = make_train_step(cfg, TrainConfig(optimizer="adamw"))
    tparams = optim.tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    state = opt.init(tparams)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    with recording() as rec:
        with torch.no_grad():
            M.prefill(cfg, params, {"tokens": _tokens(cfg)})
        step_fn(tparams, state, {"tokens": _tokens(cfg, b=2)})
    assert {"model.prefill", "train.step"} <= {s.name for s in rec.spans()}


# ------------------------------------------------------------------- gateway
def test_route_spans_are_the_phase_samples_of_the_batch():
    d, n_tools = 16, 40
    table = np.random.default_rng(0).standard_normal((n_tools, d)).astype(np.float32)
    db = ToolsDatabase([ToolRecord(i, f"t{i}", np.arange(3), 0) for i in range(n_tools)],
                       table)

    def embed(tokens):
        return np.bincount(np.asarray(tokens, np.int64) % d, minlength=d).astype(np.float32)

    registry = MetricsRegistry()
    router = SemanticRouter(db, embed, k=3, backend="dense", device="cpu", metrics=registry)
    queries = [np.arange(i, i + 5) for i in range(3)]
    with recording() as rec:
        router.route_batch(queries)
    router.close()
    spans = rec.spans()
    assert spans[0].name == "route.batch" and spans[0].attrs == {"queries": 3}
    assert [s.name for s in spans[1:]] == ["route.embed", "route.adapter", "route.score",
                                           "route.assemble"]
    assert all(s.parent == 0 and s.root == 0 for s in spans[1:])
    for s in spans[1:]:
        h = registry.histogram("route_phase_ms", phase=s.name.split(".")[1])
        assert h.count() == 1
        assert (s.end_ns - s.start_ns) / 1e6 == pytest.approx(h.mean(), abs=1e-5)
    assert spans[0].end_ns - spans[0].start_ns == pytest.approx(
        1e6 * registry.histogram("route_batch_ms").mean(), abs=10)
