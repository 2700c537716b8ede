"""One run of one cell: set-up, the measured window, the check of what the
window produced, and the result's last line.

A driver (portbench/drivers/<kind>.py) provides
  setup(cell, seed, device, run) -> state     build and warm the system
  window(state, seconds, trace, run)          the measured window
  release(state)                              free the program's state
  check(state, run) -> {number: value}        what `correct` compares
and fills the `Run`'s samples, counts and work, which the metric readers
(portbench/metrics/<name>.py) turn into metrics.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.harness import spec as spec_lib
from portbench.harness.trace import Trace, traced

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, whole
TRACE_SHARE = 0.25  # a traced segment's length, as a share of the window's


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers' input."""

    model: Dict  # the configuration's model sizes
    setup_s: float = math.nan
    window_s: float = math.nan
    samples: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    work: Dict[str, List] = dataclasses.field(default_factory=dict)
    trace: Optional[Trace] = None  # a traced segment after the window
    trace_work: Dict[str, List] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def seed_of(seed: int, *parts: int) -> int:
    """A 63-bit seed derived from the run's seed and `parts`."""
    ss = np.random.SeedSequence([int(seed) % (1 << 63), *parts])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, cell: Optional[spec_lib.Cell] = None) -> Tuple[Dict, Dict]:
    """(the result object of one run, its checks under "checks", last;
    the numbers the check read and does not compare)."""
    cell = cell or spec_lib.resolve(name)
    drv = spec_lib.driver(cell.mix)
    run = Run(model=cell.model)
    state = drv.setup(cell, seed, device, run)
    run.setup_s = time.perf_counter() - t_start
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t_window = time.perf_counter()  # the window, and the traced segment
    if not trace and any(m["source"] == "device_trace" for m in cell.end_to_end):
        # an end-to-end metric of the device trace: the window itself is traced
        with traced(device) as rec:
            drv.window(state, seconds, False, run)
            rec.window_s = run.window_s
        run.trace, run.trace_work = rec.trace, run.work
    else:
        drv.window(state, seconds, trace, run)
    t_check = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run.counts["peak_mem_bytes"] = peak
    drv.release(state)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = drv.check(state, run)
    print(f"portbench: set-up {run.setup_s:.2f} s, window and trace reading "
          f"{t_check - t_window:.2f} s, check {time.perf_counter() - t_check:.2f} s",
          file=sys.stderr)
    checks = {}
    for key, limit in cell.limits.items():
        value = numbers.get(key, math.inf)
        checks[key] = {"value": float(value), "limit": float(limit)}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and run.failed == 0
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec_lib.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(10),
                               "idle_gaps": run.trace.idle_gaps(10)}
    result["checks"] = checks
    return result, {k: v for k, v in numbers.items() if k not in checks}


def emit(result: Dict, readings: Dict[str, float]) -> None:
    """The readings not compared, then the checks, on standard error (its
    last lines), then the result as the last line of standard output."""
    for key, value in readings.items():
        print(f"reading {key} {value!r}", file=sys.stderr)
    for key, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {key} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
