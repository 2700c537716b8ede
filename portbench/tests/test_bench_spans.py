"""Reading the program's spans against a traced segment
(`portbench/harness/spans.py`, `portbench/span_breakdown.py`).

On a synthetic trace with known gaps and spans, the readings are the known
numbers and `idle_gaps` labels each gap by the innermost program span. On
the CPU, at the tiny twins of the cells (`test_bench_control.TINY`), the
breakdown's segment records the program's spans, and labelling a trace
with them moves no metric the benchmark reads; the benchmark's own runs
(`runner.run_cell`, `--trace 0` and `--trace 1`) open no recording. On
the card (marker `cuda`), a gap the host spends asleep inside a span lies
under that span in the profiler's trace: the program's spans and the
device's events share one clock.
"""
from __future__ import annotations

import ast
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [p for p in (str(ROOT), str(ROOT / "src")) if p not in sys.path]

from portbench import span_breakdown  # noqa: E402
from portbench.harness import runner, spec  # noqa: E402
from portbench.harness import spans as S  # noqa: E402
from portbench.harness.trace import Trace, traced  # noqa: E402
from portbench.tests.test_bench_control import TINY, tiny_cell  # noqa: E402
from repro_torch.obs import trace as program_trace  # noqa: E402
from repro_torch.obs.trace import Span, span  # noqa: E402

MS = 1_000_000  # ns


def _synthetic():
    """Device busy 0-10, 30-40, 70-80 ms; the benchmark's `prefill` range
    over 0-100; one prefill's spans inside it."""
    ops = [("gemm", 0, 10 * MS), ("flash_attention_wgmma", 30 * MS, 40 * MS),
           ("ssd_scan_output", 70 * MS, 80 * MS)]
    trace = Trace(ops, [("prefill", 0, 100 * MS)], 0.1)
    rows = [("model.prefill", 1, 95, -1), ("model.embed", 2, 5, 0), ("model.layer", 5, 60, 0),
            ("model.attn", 6, 35, 2), ("model.attn.core", 20, 33, 3), ("model.ffn", 40, 58, 2),
            ("model.logits", 60, 90, 0)]
    spans = [Span(n, a * MS, b * MS, p, 0, {}) for n, a, b, p in rows]
    return trace, spans


def test_readings_on_a_synthetic_trace():
    trace, spans = _synthetic()
    assert S.host_ms(spans, "model.prefill") == pytest.approx(94.0)
    # idle inside 1-95: 94 ms less busy 9 + 10 + 10
    assert S.idle_ms_per_span(trace, spans, "model.prefill") == pytest.approx(65.0)
    # inside the children: embed 0, layer 55 - 15 = 40, logits 30 - 10 = 20
    assert S.child_idle_share(trace, spans, "model.prefill") == pytest.approx(60 / 65)
    assert S.host_ms(spans, "train.step") is None
    assert S.idle_ms_per_span(trace, spans, "train.step") is None
    assert S.child_idle_share(trace, spans, "train.step") is None
    steps = [Span("train.step", 0, 50 * MS, -1, 0, {}), Span("train.step", 50 * MS, 110 * MS,
                                                             -1, 1, {})]
    assert S.host_ms(steps, "train.step") == pytest.approx(55.0)
    assert S.host_ms_by_name(steps) == {"train.step": [2, pytest.approx(55.0),
                                                       pytest.approx(110.0)]}


def test_idle_gaps_are_labelled_by_the_innermost_program_span():
    trace, spans = _synthetic()
    assert trace.idle_gaps() == [["prefill", pytest.approx(0.05)]]
    # the gap at 10 ms opens inside model.attn (its core starts at 20), the
    # gap at 40 ms inside model.ffn
    got = dict(S.labelled(trace, spans).idle_gaps())
    assert got == {"model.ffn": pytest.approx(0.03), "model.attn": pytest.approx(0.02)}


@pytest.fixture(scope="module")
def tiny_segments():
    out = {}
    for name in sorted(TINY):
        out[name] = span_breakdown.segment(tiny_cell(name), 11, 0.3, torch.device("cpu"))
    return out


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_breakdowns_segment_records_the_programs_spans(tiny_segments, name):
    run, spans, dropped = tiny_segments[name]
    assert dropped == 0 and spans
    names = {s.name for s in spans}
    out = span_breakdown.breakdown(run, spans, dropped)
    if "prefill" in run.trace_work:
        assert sum(s.attrs["tokens"] for s in spans if s.name == "model.prefill") == sum(
            run.trace_work["prefill"])
        assert len([s for s in spans if s.name == "route.batch"]) == len(
            run.trace_work["route"])
        assert ("model.ssm.scan" in names) == bool(run.model.get("hybrid"))
        assert out["readings"]["prefill_host_ms"] > 0
        assert out["readings"]["step_host_ms"] is None
    else:
        assert len([s for s in spans if s.name == "train.step"]) == len(
            run.trace_work["train_step"])
        assert {"train.forward", "train.backward", "train.clip", "train.update"} <= names
        assert out["readings"]["step_host_ms"] > 0
    # the CPU trace holds no device operation: every second inside a span
    # is idle, and its children cover nearly all of it
    share = out["child_idle_share"]["model.prefill" if "prefill" in run.trace_work
                                    else "train.step"]
    assert 0.5 < share <= 1.0


@pytest.mark.parametrize("name", sorted(TINY))
def test_labelling_moves_no_metric(tiny_segments, name):
    run, spans, _ = tiny_segments[name]
    t0 = min(s.start_ns for s in spans)
    ops = [(n, t0 + i * 3 * MS, t0 + (i * 3 + 2) * MS) for i, n in enumerate(
        ["gemm", "flash_attention_wgmma", "ssd_scan_output", "topk_sim_pass1", "elementwise"]
        * 4)]
    base = Trace(ops, run.trace.host, run.trace.window_s)
    bench = spec.load_benchmark()
    readers = {m["name"]: spec.reader(m["name"])
               for m in bench["per_layer"] + bench["end_to_end"]}
    run.trace = base
    before = {k: r(run) for k, r in readers.items()}
    run.trace = S.labelled(base, spans)
    assert {k: r(run) for k, r in readers.items()} == before
    assert run.trace.busy == base.busy and run.trace.ops == base.ops
    assert run.trace.top_ops(10) == base.top_ops(10)


@pytest.mark.parametrize("trace_flag", [False, True])
def test_the_benchmarks_runs_open_no_recording(monkeypatch, trace_flag):
    def refuse(*_a, **_k):
        raise AssertionError("the benchmark opened a span recording")

    monkeypatch.setattr(program_trace, "recording", refuse)
    monkeypatch.setattr(program_trace.SpanRecorder, "__init__", refuse)
    name = "hymba-1.5b.agent-prefill"  # its --trace 0 run traces the window
    result, _ = runner.run_cell(name, 5, 0.3, trace_flag, torch.device("cpu"),
                                time.perf_counter(), cell=tiny_cell(name))
    assert result["attempted"] > 0 and not program_trace.recording_on()


def test_only_the_breakdown_opens_a_recording():
    opens = set()
    for path in sorted((ROOT / "portbench").rglob("*.py")):
        if "tests" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Name) and node.id == "recording":
                opens.add(path.relative_to(ROOT).as_posix())
    assert opens == {"portbench/span_breakdown.py"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the profiler's device events")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_sleep_inside_a_span_is_an_idle_gap_under_it(cuda_device):
    x = torch.randn(2048, 2048, device=cuda_device)
    (x @ x).sum()
    torch.cuda.synchronize()
    segments = []
    with span_breakdown.traced_with_spans(traced, segments)(cuda_device) as rec:
        t0 = time.perf_counter()
        with span("probe"):
            y = x @ x  # ~0.3 ms on the card: it ends once the host is asleep
            time.sleep(0.05)
        with span("launch"):
            z = y @ y
        z.sum()
        torch.cuda.synchronize()
        rec.window_s = time.perf_counter() - t0
    ((rec, spans, _),) = segments
    probe, launch = spans
    # the one long gap: from the first product's end to the second's start
    ((a, b),) = [(end, start) for (_, end), (start, _) in zip(rec.trace.busy, rec.trace.busy[1:])
                 if start - end > 40 * MS]
    where = f"gap {a}-{b}, probe {probe.start_ns}-{probe.end_ns}, launch {launch.start_ns}-" \
            f"{launch.end_ns}"
    # on one clock the gap opens inside `probe` and closes once `launch` has
    # enqueued the second product (the card is idle, so within a few ms)
    assert probe.start_ns <= a <= probe.start_ns + 5 * MS, where
    assert launch.start_ns <= b <= launch.end_ns + 5 * MS, where
    gaps = dict(S.labelled(rec.trace, spans).idle_gaps(20))
    assert gaps["probe"] == pytest.approx((b - a) / 1e9, abs=1e-3), gaps
    assert gaps["probe"] >= 0.045, gaps
