"""The benchmark's FLOP counts equal what `FlopCounterMode` counts on the
plain reference at small sizes (attention a query row at a time over its
live keys, the SSD recurrence a step at a time), and the kernels' bounds
count what their inputs need."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import work
from portbench.harness.weights import leaf_paths, make_weights
from portbench.reference import decoder as ref_decoder

DATA = Path(__file__).resolve().parent / "data"
FAMILIES = ("tiny-dense", "tiny-hybrid")


def sizes(name: str) -> dict:
    return {**json.loads((DATA / f"{name}.json").read_text())["model"], "dtype": "float32"}


def exact_decoder(m):
    """The reference computing only the work the counts count."""
    return ref_decoder.Decoder(m, attn_block=1, ssm="recurrent")


@pytest.mark.parametrize("s,window", [(1, 0), (9, 0), (9, 4), (40, 16), (16, 16), (5, 64)])
def test_live_pairs_count_the_mask(s, window):
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    live = (j <= i) & ((i - j < window) if window else True)
    assert work.live_pairs(s, window) == int(live.sum())


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("s", [5, 23])
def test_prefill_flops_equal_the_flop_counter(family, s):
    m = sizes(family)
    flat = dict(leaf_paths(make_weights(m, 1, "cpu")))
    prompt = torch.arange(s) % m["vocab_size"]
    with FlopCounterMode(display=False) as fc:
        exact_decoder(m).last_logits(flat, [prompt])
    assert fc.get_total_flops() == work.prefill_flops(m, s)


@pytest.mark.parametrize("family", FAMILIES)
def test_train_step_flops_equal_the_flop_counter(family):
    m = sizes(family)
    flat = {k: v.requires_grad_() for k, v in leaf_paths(make_weights(m, 1, "cpu"))}
    tokens = torch.arange(2 * 11).reshape(2, 11) % m["vocab_size"]
    with FlopCounterMode(display=False) as fc:
        loss = exact_decoder(m).loss(flat, tokens, checkpoint=False)
        torch.autograd.grad(loss, list(flat.values()))
    assert fc.get_total_flops() == work.train_step_flops(m, 2, 11)


def test_bounds_take_the_larger_of_bytes_and_operations():
    m = sizes("tiny-hybrid")
    assert work.bound_s(work.PEAK_BYTES_PER_S, 0, 1.0) == pytest.approx(1.0)
    assert work.bound_s(0, 2 * work.PEAK_BF16_FLOP_PER_S, work.PEAK_BF16_FLOP_PER_S) == 2.0
    # at 100,000 tools a batch of 4 is bound by reading the table once
    t = work.topk_bound_s(4, 100_000, 384, 5)
    assert t == pytest.approx((4 * (4 * 384 + 100_000 * 384) + 4 * 5 * 12) / work.PEAK_BYTES_PER_S)
    assert work.topk_peak(16, 100_000, 5) == work.PEAK_TF32_FLOP_PER_S
    assert work.topk_peak(4, 100_000, 5) == work.PEAK_F32_FLOP_PER_S
    assert work.flash_bound_s(m, 64) > work.flash_bound_s(m, 32) > 0
    assert work.ssd_bound_s(m, 64) > 0
    assert work.share_pct(work.PEAK_BF16_FLOP_PER_S, 2.0) == pytest.approx(50.0)
