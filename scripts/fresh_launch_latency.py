#!/usr/bin/env python3
"""Each route batch's milliseconds in a fresh launcher process on the card,
alone or beside the same launcher on the CPU, as chip_smoke.py's phase 11
run (c) starts it.

    python3 scripts/fresh_launch_latency.py MODE[,MODE...]

Run from the root of a checkout on a machine with a card. MODE is "alone"
(the card process by itself) or "pair" (the card process and a CPU one
started together). For each run this prints the health the launcher read,
its selection p50/p99 (a batch's ms over its size) and every
`route_batch_ms` it recorded, with the count above the latency SLO's 10 ms:
two of the 30 batches above it (2/30 > 6 %) burn the SLO's 6x window pair.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def child(argv) -> None:
    """The launcher in this process, each route_batch_ms it records kept."""
    from repro_torch.launch import serve
    from repro_torch.obs import metrics

    kept = []
    record = metrics.LogHistogram.record

    def keep(self, value, *args, **kwargs):
        if self.name == "route_batch_ms":
            kept.append(float(value))
        return record(self, value, *args, **kwargs)

    metrics.LogHistogram.record = keep
    serve.main(argv)
    print("BATCH_MS " + json.dumps([round(v, 3) for v in kept]))


def main() -> int:
    if sys.argv[1] == "--child":
        child(sys.argv[2:])
        return 0
    import chip_smoke

    from repro_torch.launch import serve

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        for i, mode in enumerate(sys.argv[1].split(",")):
            procs = {}
            for where in ("card", "cpu") if mode == "pair" else ("card",):
                procs[where] = subprocess.Popen(
                    [sys.executable, __file__, "--child", *chip_smoke.LAUNCH_FRESH,
                     "--device", "cuda" if where == "card" else "cpu",
                     "--dump-dir", f"{tmp}/{i}-{where}-dumps"],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
            for where, proc in procs.items():
                stdout, stderr = proc.communicate(timeout=300)
                if proc.returncode != 0:
                    print(stderr[-3000:])
                    return 1
                got = serve.printed_results(stdout)
                ms = json.loads(next(line for line in stdout.splitlines()
                                     if line.startswith("BATCH_MS "))[len("BATCH_MS "):])
                print(f"run {i} {mode} {where}: health {got['health']}, selection p50/p99 "
                      f"{got['selection_ms']} ms a query, {sum(v > 10.0 for v in ms)} of "
                      f"{len(ms)} batches over 10 ms, max {max(ms)}; batch ms {ms}", flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"{time.perf_counter() - t0:.1f} s")
    sys.exit(rc)
