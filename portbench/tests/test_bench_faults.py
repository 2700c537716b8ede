"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run of a cell's tiny twin on the CPU (the run's
look for a card skipped, everything else as on the card) with one fault
planted in the program, and sees `correct` false: a served token altered
where the logits are produced, a routed answer altered, a train step that
returns its state unchanged, and a step that leaves out half the batch
(the mean over the rest). The cells run on one chip, so no exchange
between chips can be left out. The same run without a fault is correct.
"""
from __future__ import annotations

import time

import pytest
import torch

from portbench.harness import runner
from portbench.tests.test_bench_control import tiny_cell

SERVING = ("granite-3-8b.agent-prefill", "hymba-1.5b.agent-prefill")
TRAINING = "hymba-1.5b.train-2x1024"


def run(name: str) -> dict:
    result, _ = runner.run_cell(name, 2**31 + 77, 0.3, False, torch.device("cpu"),
                                time.perf_counter(), cell=tiny_cell(name))
    return result


def token_altered(monkeypatch):
    from repro_torch.models import model as M

    prefill = M.prefill

    def altered(cfg, params, batch, *a, **kw):
        logits, cache = prefill(cfg, params, batch, *a, **kw)
        logits = logits.clone()
        top = logits[..., -1, :].argmax(dim=-1)
        logits[..., -1, (top + 1) % logits.shape[-1]] = logits[..., -1, :].max() + 1
        return logits, cache

    monkeypatch.setattr(M, "prefill", altered)


def answer_altered(monkeypatch):
    from repro_torch.router.gateway import SemanticRouter

    route_batch = SemanticRouter.route_batch

    def altered(self, queries, *a, **kw):
        out = route_batch(self, queries, *a, **kw)
        out[0].tools = [(out[0].tools[0] + 1) % len(self.db)] + out[0].tools[1:]
        return out

    monkeypatch.setattr(SemanticRouter, "route_batch", altered)


def _train_step_fault(monkeypatch, wrap):
    from repro_torch.training import train_step as ts

    make = ts.make_train_step

    def patched(*a, **kw):
        step, opt = make(*a, **kw)
        return wrap(step), opt

    monkeypatch.setattr(ts, "make_train_step", patched)


def state_unchanged(monkeypatch):
    def wrap(step):
        def unchanged(params, opt_state, batch):
            _, _, met = step(params, opt_state, batch)
            return params, opt_state, met
        return unchanged

    _train_step_fault(monkeypatch, wrap)


def half_batch(monkeypatch):
    def wrap(step):
        def half(params, opt_state, batch):
            rows = batch["tokens"].shape[0] // 2
            return step(params, opt_state, {"tokens": batch["tokens"][:rows]})
        return half

    _train_step_fault(monkeypatch, wrap)


@pytest.mark.parametrize("name,fault", [(n, f) for n in SERVING
                                        for f in (token_altered, answer_altered)]
                         + [(TRAINING, state_unchanged), (TRAINING, half_batch)],
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_fault_makes_the_run_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    result = run(name)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("name", SERVING + (TRAINING,))
def test_the_run_without_a_fault_is_correct(name):
    result = run(name)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    # a CPU run reads no device trace, so it reports the host-clock metrics alone
    e2e = tiny_cell(name).end_to_end
    assert set(result["metrics"]) == {m["name"] for m in e2e if m["source"] == "host_clock"}
    assert list(result)[-1] == "checks"
