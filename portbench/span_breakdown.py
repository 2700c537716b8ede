"""Where a cell's traced segment leaves the card idle, by the program's spans.

    python3 portbench/span_breakdown.py --workload <name> --seed <n> --seconds <s>

from the root of a checkout, on a machine with the card the cell asks for.
It sets the cell up as `run.py` does and runs its window and then its
traced segment (`--trace 1`'s path), with the program's span recording
(`repro_torch.obs.trace.recording`) open beside the profiler in the
segment only; it checks nothing. The last line of standard output is one
JSON object:

  idle_gaps         the segment's idle device seconds by the innermost span
                    open when each gap began (the program's, or else the
                    benchmark's own ranges)
  readings          prefill_host_ms, prefill_idle_ms (over `model.prefill`
                    spans), step_host_ms (over `train.step` spans), in ms
  child_idle_share  for `model.prefill` and `train.step`: the share of
                    the idle time inside them that falls inside a child
  host_ms           each span name's count, mean and total host ms
  busy_s, window_s, segment_tokens_per_s, spans, dropped
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def traced_with_spans(traced, out: list):
    """A `traced` that also records the program's spans in its block and
    appends (its recorder, the spans, the number dropped) to `out` once
    the block ends."""

    @contextlib.contextmanager
    def wrapped(device):
        from repro_torch.obs.trace import recording

        with recording() as prog, traced(device) as rec:
            yield rec
        out.append((rec, prog.spans(), prog.dropped))

    return wrapped


def segment(cell, seed: int, seconds: float, device):
    """Set the cell up and run its window and traced segment, the
    program's spans recorded in the segment: (the run, the spans, the
    number dropped)."""
    from portbench.harness import runner, spec

    drv = spec.driver(cell.mix)
    segments: list = []
    traced = drv.traced
    drv.traced = traced_with_spans(traced, segments)
    try:
        run = runner.Run(model=cell.model)
        state = drv.setup(cell, seed, device, run)
        print(f"portbench: set-up {time.perf_counter() - T_START:.2f} s", file=sys.stderr)
        drv.window(state, seconds, True, run)
        drv.release(state)
    finally:
        drv.traced = traced
    ((_, spans, dropped),) = segments
    return run, spans, dropped


def breakdown(run, spans, dropped: int) -> dict:
    from portbench.harness import spans as S

    trace, work = run.trace, run.trace_work
    tokens = (sum(work["prefill"]) if "prefill" in work
              else sum(b * s for b, s in work.get("train_step", [])))
    return {
        "busy_s": trace.busy_s, "window_s": trace.window_s,
        "segment_tokens_per_s": tokens / trace.window_s if trace.window_s else None,
        "spans": len(spans), "dropped": dropped,
        "idle_gaps": S.labelled(trace, spans).idle_gaps(12),
        "readings": {"prefill_host_ms": S.host_ms(spans, "model.prefill"),
                     "prefill_idle_ms": S.idle_ms_per_span(trace, spans, "model.prefill"),
                     "step_host_ms": S.host_ms(spans, "train.step")},
        "child_idle_share": {n: S.child_idle_share(trace, spans, n)
                             for n in ("model.prefill", "train.step")},
        "host_ms": S.host_ms_by_name(spans),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    # kernel and extension caches where run.py keeps them
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from portbench.harness import spec

    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available():
        print(f"portbench: {cell.name} needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    run, spans, dropped = segment(cell, args.seed, args.seconds, device)
    out = {"workload": cell.name, "seed": args.seed,
           "device": torch.cuda.get_device_name(device), **breakdown(run, spans, dropped)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
