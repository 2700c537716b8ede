"""The port's runtime checks (`repro_torch.analysis`) against the JAX
package's: both `LockGraph`s fed one acquisition script record equal edges
and cycles; the port's legs catch their planted faults (an inverted lock
order, an upload and the adapter under a lock through `stages.adapter_apply`,
a probe that grows after warm-up); and both packages' scenarios pass on
the CPU with the same structure."""
import re
import threading
import time

import numpy as np
import pytest
import torch

SCRIPTS = {
    "inverted": [("t1", ["a", "b"]), ("t2", ["b", "a"])],
    "consistent": [("t1", ["a", "b"]), ("t2", ["a", "b"]), ("t3", ["b", "c"])],
    "three-cycle": [("t1", ["a", "b"]), ("t2", ["b", "c"]), ("t3", ["c", "a"])],
    "nested": [("t1", ["a", "b", "c"]), ("t2", ["c"]), ("t3", ["d", "a"])],
}


def _play(lockgraph, script):
    """Run each thread's nested acquisitions, one thread after another."""
    graph = lockgraph.LockGraph()
    locks = {}

    def lock(name):
        return locks.setdefault(name, lockgraph.TrackedLock(graph, name=name))

    def nest(names):
        if names:
            with lock(names[0]):
                nest(names[1:])

    for thread_name, names in script:
        t = threading.Thread(target=nest, args=(names,), name=thread_name)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    return graph


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_lockgraph_matches_reference_on_one_script(script):
    from repro.analysis import lockgraph as jax_lockgraph
    from repro_torch.analysis import lockgraph

    ref = _play(jax_lockgraph, SCRIPTS[script])
    got = _play(lockgraph, SCRIPTS[script])
    assert got.edges == ref.edges
    assert got.cycles() == ref.cycles()
    assert got.report() == ref.report()


def test_lockgraph_catches_inverted_order():
    from repro_torch.analysis.lockgraph import LockGraph, TrackedLock

    graph = LockGraph()
    a, b = TrackedLock(graph, name="lock-a"), TrackedLock(graph, name="lock-b")
    t = threading.Thread(target=lambda: [a.acquire(), b.acquire(), b.release(), a.release()])
    t.start()
    t.join(timeout=10)
    with b:
        with a:
            pass
    cycles = graph.cycles()
    assert cycles and set(cycles[0]) == {"lock-a", "lock-b"}


def test_tracked_lock_supports_condition():
    from repro_torch.analysis.lockgraph import LockGraph, TrackedLock

    graph = LockGraph()
    cond = threading.Condition(TrackedLock(graph, name="cond-lock"))
    hits = []

    def waiter():
        with cond:
            cond.wait(timeout=5)
            hits.append(True)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        cond.notify_all()
    t.join(timeout=5)
    assert not t.is_alive() and hits == [True]
    assert graph.held_locks() == []


def test_patch_threading_scopes_the_monkeypatch():
    from repro_torch.analysis.lockgraph import LockGraph, TrackedLock, patch_threading

    graph = LockGraph()
    with patch_threading(graph):
        inside = threading.Lock()
    with patch_threading(graph, site_filter="repro_torch/"):
        filtered = threading.Lock()  # allocated here, in tests/: not tracked
    outside = threading.Lock()
    assert isinstance(inside, TrackedLock)
    assert not isinstance(filtered, TrackedLock)
    assert not isinstance(outside, TrackedLock)


def test_watch_dispatch_catches_adapter_under_lock_through_stages():
    """The adapter is caught through the name `router/stages.py` imported
    before the patch, with the upload in front of it; the same calls
    without a lock record nothing, and the patch is undone on exit."""
    from repro_torch.analysis.lockgraph import LockGraph, TrackedLock, watch_dispatch
    from repro_torch.core import adapter
    from repro_torch.router import stages
    from repro_torch.router.stages import StageSet

    gen = torch.Generator().manual_seed(0)
    params = adapter.init_adapter(gen)
    stage_set = StageSet(adapter_params=params, adapter_scale=0.1)
    q = np.eye(2, adapter.DIM, dtype=np.float32)
    graph = LockGraph()
    lock = TrackedLock(graph, name="hot-lock")
    orig_to, orig_stage, orig_def = torch.Tensor.to, stages.adapter_apply, adapter.adapter_apply
    with watch_dispatch(graph):
        assert stages.adapter_apply is not orig_stage  # the imported name is wrapped
        stage_set.adapt_queries(q)  # no lock: fine
        assert graph.dispatch_events == []
        with lock:
            out = stage_set.adapt_queries(q)  # the hazard
        torch.ones(2).to(torch.float64)  # a dtype cast names no device
    assert torch.Tensor.to is orig_to and stages.adapter_apply is orig_stage
    assert adapter.adapter_apply is orig_def
    np.testing.assert_allclose(out, stage_set.adapt_queries(q))
    fns = [ev["fn"] for ev in graph.dispatch_events]
    assert "repro_torch.router.stages.adapter_apply" in fns
    assert "Tensor.to" in fns
    assert all(ev["locks"] == ["hot-lock"] for ev in graph.dispatch_events)


def test_watch_dispatch_wraps_kernel_launches_where_ops_bound_them():
    from repro_torch.analysis.lockgraph import LockGraph, watch_dispatch
    from repro_torch.kernels.topk_sim import kernel, ops

    orig = kernel.topk_sim_cuda
    with watch_dispatch(LockGraph()):
        assert ops.topk_sim_cuda is not orig and kernel.topk_sim_cuda is not orig
    assert ops.topk_sim_cuda is orig and kernel.topk_sim_cuda is orig


def test_retrace_monitor_catches_probe_growth_after_warmup(monkeypatch):
    """A route first launched inside the window is a retrace: the probe
    grows past a zero budget."""
    from repro_torch.analysis.retrace import hot_path_monitor
    from repro_torch.kernels.topk_sim import kernel

    monkeypatch.setattr(kernel, "launched_routes", set())
    mon = hot_path_monitor()
    assert mon.unsupported == ["adapter_apply", "rerank_topk_scored"]
    with mon:
        kernel.launched_routes.add("split")
    assert mon.traces() == {"topk_sim": 1}
    violations = mon.check({"topk_sim": 0})
    assert violations and "topk_sim" in violations[0]
    with mon:
        pass
    assert mon.check({"topk_sim": 0}) == []


def test_retrace_monitor_unsupported_degrades():
    from repro_torch.analysis.retrace import RetraceMonitor, supports_cache_size

    def plain(x):
        return x

    assert not supports_cache_size(plain)
    mon = RetraceMonitor()
    assert not mon.track("plain", plain)
    assert mon.unsupported == ["plain"]
    with mon:
        plain(1)
    assert mon.check({"plain": 0}) == []


def test_topk_sim_budget_counts_the_buckets_routes():
    """On the card: the library's load plus each distinct route of the
    sweep's padded buckets (no launch needed to know them); 0 on the CPU."""
    from repro_torch.analysis.retrace import SMOKE_SIZES, topk_sim_budget
    from repro_torch.kernels.topk_sim.kernel import PROBE

    # 100,000 tools at D 384, k 4: buckets 1-8 split, 16 wgmma
    assert {PROBE.route(q, 100_000, 384, 4) for q in (1, 2, 4, 8)} == {"split"}
    assert PROBE.route(16, 100_000, 384, 4) == "wgmma"
    assert topk_sim_budget(SMOKE_SIZES, 100_000, 384, 4, on_card=True) == 3
    assert topk_sim_budget(SMOKE_SIZES, 2413, 384, 4, on_card=True) == 2  # cluster
    assert topk_sim_budget(SMOKE_SIZES, 100_000, 384, 4, on_card=False) == 0
    # what is loaded or launched before the sweep is not budgeted
    assert topk_sim_budget(SMOKE_SIZES, 100_000, 384, 4, on_card=True, loaded=True) == 2
    assert topk_sim_budget(SMOKE_SIZES, 100_000, 384, 4, on_card=True, loaded=True,
                           launched={"split"}) == 1


def test_retrace_budget_fails_one_load_past_the_routes(monkeypatch):
    """The library loaded while the fused backend was built: the sweep's
    budget is its routes alone, so the routes' first launches pass and a
    reload of the library on top of them fails."""
    from repro_torch.analysis.retrace import SMOKE_SIZES, hot_path_monitor, sweep_budget
    from repro_torch.kernels.topk_sim import kernel

    monkeypatch.setattr(kernel, "launched_routes", set())
    monkeypatch.setattr(kernel.LIBRARY, "loads", 1)
    budget = {"topk_sim": sweep_budget(SMOKE_SIZES, 100_000, 384, 4, on_card=True)}
    assert budget == {"topk_sim": 2}
    mon = hot_path_monitor()
    with mon:
        kernel.launched_routes.update({"split", "wgmma"})
    assert mon.traces() == {"topk_sim": 2} and mon.check(budget) == []
    kernel.launched_routes.clear()
    with mon:
        kernel.launched_routes.update({"split", "wgmma"})
        kernel.LIBRARY.loads += 1
    assert mon.traces() == {"topk_sim": 3}
    violations = mon.check(budget)
    assert violations and "topk_sim: 3" in violations[0]


def test_retrace_scenarios_pass_on_cpu_in_both_packages():
    from repro.analysis.retrace import run_scenario as jax_run
    from repro_torch.analysis.retrace import run_scenario

    sizes = [1, 2, 3, 4, 5, 8, 3]
    ref = jax_run(sizes, n_tools=32, dim=12, seed=3)
    got = run_scenario(sizes, n_tools=32, dim=12, seed=3, device="cpu")
    assert ref["violations"] == [] and got["violations"] == [], (ref, got)
    assert got["buckets"] == ref["buckets"] == [1, 2, 4, 8]
    assert got["traces"] == {"topk_sim": 0} and got["second"] == {"topk_sim": 0}
    assert got["budget"]["topk_sim"] == 0
    assert got["unsupported"] == ["adapter_apply", "rerank_topk_scored"]


@pytest.mark.slow
def test_lockgraph_scenarios_pass_on_cpu_in_both_packages():
    from repro.analysis.lockgraph import run_scenario as jax_run
    from repro_torch.analysis.lockgraph import run_scenario

    ref = jax_run(iters=8, seed=1)
    got = run_scenario(iters=8, seed=1, device="cpu")
    for report in (ref, got):
        assert report["errors"] == []
        assert report["cycles"] == []
        assert report["dispatch_under_lock"] == []

    def files(report):  # "control/guard.py -> router/tooldb.py": no package, no line
        return sorted(re.sub(r":\d+", "", re.sub(r"repro(_torch)?/", "", e))
                      for e in report["edges"])

    assert files(got) == files(ref)


def test_retrace_cli_runs_on_cpu(capsys):
    from repro_torch.analysis.retrace import main

    assert main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device: cpu" in out and "retrace check OK" in out


def test_lockgraph_cli_runs_on_cpu(capsys):
    from repro_torch.analysis.lockgraph import main

    assert main(["--smoke", "--device", "cpu", "--iters", "4"]) == 0
    assert "lockgraph check OK" in capsys.readouterr().out
