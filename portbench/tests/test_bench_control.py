"""The control of `correct`: the reference in the next lower precision
than the configuration states (fp8 products for bf16 weights; TF32 for
the gateway's float32 scores), put in the program's place, has to come out
not correct, while the program comes out correct.

Here on the CPU at a test's size (tiny configurations, tests/data/). On
the card, at the cells' own sizes, `test_control_fails_at_cell_size`
(marker `cuda`), or as a script that prints the readings the limits were
set from, the program's and the control's, a seed a line:

    python3 -m portbench.tests.test_bench_control --workload <name> \\
        --seeds 1,2,3 --control-seeds 1,2,3 --seconds 5
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [p for p in (str(ROOT), str(ROOT / "src")) if p not in sys.path]

from portbench.harness import runner, spec  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
TINY = {  # a tiny twin of each cell: (configuration, mix)
    "granite-3-8b.agent-prefill": ("tiny-dense", "tiny-agent-prefill"),
    "hymba-1.5b.agent-prefill": ("tiny-hybrid", "tiny-agent-prefill"),
    "hymba-1.5b.train-2x1024": ("tiny-hybrid", "tiny-train"),
}


def _json(name: str):
    return json.loads((DATA / f"{name}.json").read_text())


def tiny_cell(name: str) -> spec.Cell:
    """The cell's metrics over its tiny twin, judged by the twin's limits."""
    real = spec.resolve(name)
    config, mix = TINY[name]
    mix = _json(mix)
    return spec.Cell(name=name, config=_json(config), mix=mix,
                     gateway=_json("tiny-gateway") if "gateway" in mix else None,
                     limits=_json(f"tiny-limits-{mix['kind']}"), end_to_end=real.end_to_end,
                     per_layer=real.per_layer, chips=1)


def readings(cell: spec.Cell, seed: int, seconds: float, device, with_control: bool):
    """(the program's numbers, the control's or None, the run's counts) of
    one seed, after a window of `seconds` at the cell's own load."""
    drv = spec.driver(cell.mix)
    run = runner.Run(model=cell.model)
    state = drv.setup(cell, seed, device, run)
    drv.window(state, seconds, False, run)
    drv.release(state)
    prog = drv.check(state, run)
    counts = dict(run.counts)
    ctl = drv.control(state, run) if with_control else None
    return prog, ctl, counts


def _fails(numbers, limits) -> bool:
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.parametrize("name", sorted(TINY))
def test_control_fails_and_program_passes_on_the_cpu(name):
    cell = tiny_cell(name)
    prog, ctl, _ = readings(cell, 7, 0.3, torch.device("cpu"), True)
    assert not _fails(prog, cell.limits), prog
    assert _fails(ctl, cell.limits), ctl


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own sizes")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TINY))
def test_control_fails_at_cell_size(cuda_device, name):
    cell = spec.resolve(name)
    for seed in (11, 12, 13):
        prog, ctl, _ = readings(cell, seed, 5.0, cuda_device, True)
        assert not _fails(prog, cell.limits), (seed, prog)
        assert _fails(ctl, cell.limits), (seed, ctl)


def main(argv=None) -> int:
    from portbench.tests import test_bench_faults as faults

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="", help="a fault of tests/test_bench_faults.py to plant")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    cell = spec.resolve(args.workload)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    seeds += sorted(control - set(seeds))
    with pytest.MonkeyPatch.context() as mp:
        if args.fault:
            getattr(faults, args.fault)(mp)
        for seed in seeds:
            t = time.perf_counter()
            prog, ctl, counts = readings(cell, seed, args.seconds, torch.device("cuda", 0),
                                         seed in control)
            print(json.dumps({"workload": cell.name, "seed": seed, "fault": args.fault or None,
                              "program": prog, "control": ctl, "counts": counts,
                              "seconds": round(time.perf_counter() - t, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
