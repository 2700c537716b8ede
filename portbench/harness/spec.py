"""Resolve a cell of `BENCHMARK.json` to its files, by name.

  configuration  the file `BENCHMARK.json` names for it
  traffic mix    portbench/mixes/<traffic>.json; its "kind" names the driver
                 portbench/drivers/<kind>.py, its "gateway" (if any) the file
                 portbench/gateways/<gateway>.json
  limits         portbench/limits/<cell>.json: each number `correct` compares
  metric         portbench/metrics/<metric>.py, whose read(run) returns the
                 value or None

A later cell, mix, configuration or metric is new files and new entries;
nothing here changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict  # the configuration's file
    mix: Dict  # the traffic mix's file
    gateway: Optional[Dict]
    limits: Dict[str, float]
    end_to_end: List[Dict]  # BENCHMARK.json entries that this cell reports
    per_layer: List[Dict]
    chips: int

    @property
    def model(self) -> Dict:
        return self.config["model"]


def load_benchmark() -> Dict:
    return _json(ROOT / "BENCHMARK.json")


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, bench: Optional[Dict] = None) -> Cell:
    bench = bench or load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    w = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    mix = _json(BENCH_DIR / "mixes" / f"{w['traffic']}.json")
    gateway = (_json(BENCH_DIR / "gateways" / f"{mix['gateway']}.json")
               if "gateway" in mix else None)
    return Cell(
        name=name,
        config=_json(ROOT / config["file"]),
        mix=mix,
        gateway=gateway,
        limits=_json(BENCH_DIR / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        chips=int(w["chips"]),
    )


def driver(mix: Dict):
    """The driver module of the mix's kind."""
    return importlib.import_module(f"portbench.drivers.{mix['kind']}")


def reader(metric: str) -> Callable:
    """read(run) of portbench/metrics/<metric>.py."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
