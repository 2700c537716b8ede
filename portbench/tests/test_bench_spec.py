"""Every cell and metric of BENCHMARK.json resolves to its files, and the
file keeps the benchmark's contract: its keys, names, units, bounds and
the chip time a full check of 24 cells would take."""
from __future__ import annotations

import ast
import re

import pytest

from portbench.harness import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DRIVER_API = ("setup", "window", "release", "check", "control")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    # a full check of 24 cells: 2 + 14 runs a cell, each run_seconds + 60 s,
    # 2 x 90 s a cell to compile, 1,200 s spare, within 43,200 s
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_resolves(cfg):
    from repro_torch.models.config import ModelConfig

    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["file"].startswith("portbench/")
    data = spec._json(spec.ROOT / cfg["file"])
    assert data["name"] == cfg["name"] and data["source"].startswith(cfg["source"])
    assert ModelConfig(**data["model"]).name == cfg["name"]
    assert all(NAME.match(k) for k in cfg["reduced"]) and len(cfg["reduced"]) <= 16
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(name) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    cell = spec.resolve(name)
    drv = spec.driver(cell.mix)
    assert all(callable(getattr(drv, f, None)) for f in DRIVER_API)
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported, (m["name"], m["moves"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_resolves(metric):
    e2e = metric in BENCH["end_to_end"]
    keys = {"name", "unit", "better", "source"} | ({"bound"} if e2e else {"layer", "moves"})
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if e2e:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    path = spec.BENCH_DIR / "metrics" / f"{metric['name']}.py"
    tree = ast.parse(path.read_text())
    assert any(isinstance(n, ast.FunctionDef) and n.name == "read" for n in tree.body)
    assert callable(spec.reader(metric["name"]))


def test_a_share_is_named_as_the_contract_names_it():
    for m in BENCH["per_layer"]:
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["source"] in ("device_trace", "host_clock")
    roofline_moves = {m["moves"] for m in BENCH["per_layer"] if "_roofline" in m["name"]}
    mfu_moves = {m["moves"] for m in BENCH["per_layer"] if "mfu" in m["name"]}
    assert roofline_moves <= mfu_moves
