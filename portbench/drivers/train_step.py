"""A fine-tuning job: one `make_train_step` step a call, back to back.

Set-up builds the one train step (`repro_torch.training.train_step.
make_train_step` with the mix's `train` settings) and its optimizer state
over the benchmark's weights, makes `n_batches` token batches from the
seed (rows that all differ), and drives the first `checked_steps` steps
through the same call and feed that the window then uses. Those steps
are what `correct` judges: each step's loss, the clipped gradient of the
first step as the optimizer holds it (its first moment / (1 - b1)), and
the change of every parameter over the checked steps. The window then
runs steps on the following batches (cycling) until the deadline, and
ends at a synchronize.

Counts: steps, tokens_per_step, peak_mem_bytes. Work (and, in a traced
segment, trace_work): train_step ([batch, seq] a step).
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from portbench.harness.runner import TRACE_SHARE, Run, seed_of
from portbench.harness.streams import lm_batches
from portbench.harness.trace import Recorder, traced
from portbench.harness.weights import leaf_paths, make_weights
from portbench.reference import decoder as ref_decoder
from portbench.reference.adamw import AdamW

B1 = 0.9  # AdamW's first-moment decay, the program's default


def setup(cell, seed: int, device: torch.device, run: Run):
    from repro_torch.models.config import ModelConfig
    from repro_torch.training.train_step import TrainConfig, make_train_step

    mix, m = cell.mix, cell.model
    cfg = ModelConfig(**m)
    tc = mix["train"]
    step_fn, opt = make_train_step(cfg, TrainConfig(**tc, optimizer="adamw"))
    params = make_weights(m, seed_of(seed, 1), device)
    for _, leaf in leaf_paths(params):
        leaf.requires_grad_()
    opt_state = opt.init(params)
    host = lm_batches(m["vocab_size"], mix["batch"], mix["seq_len"], seed_of(seed, 2),
                      mix["n_batches"])
    batches = torch.as_tensor(np.stack(host), device=device)
    n_check = mix["checked_steps"]
    p0 = params
    losses, grad1, grad1_at = [], {}, {}
    for i in range(n_check):
        params, opt_state, met = step_fn(params, opt_state, {"tokens": batches[i]})
        losses.append(float(met["loss"]))
        if i == 0:
            mu = leaf_paths(opt_state.mu)
            grad1 = {k: float(v.float().norm()) / (1 - B1) for k, v in mu}
            picks = _picks(mu, seed)
            grad1_at = {k: v.reshape(-1)[picks[k]].float() / (1 - B1) for k, v in mu}
    now = dict(leaf_paths(params))
    change = {k: float((now[k].detach().float() - v.detach().float()).norm())
              for k, v in leaf_paths(p0)}
    del p0, now
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return dict(step_fn=step_fn, params=params, opt_state=opt_state, batches=batches,
                device=device, m=m, mix=mix, tc=tc, seed=seed, losses=losses,
                grad1=grad1, grad1_at=grad1_at, change=change, window_losses=[], next=n_check)


def _loop(state, seconds: float, rec: Recorder):
    """Steps until `seconds` have passed on the host, then a synchronize:
    (steps, seconds to the synchronize's end)."""
    step_fn, batches, device = state["step_fn"], state["batches"], state["device"]
    params, opt_state = state["params"], state["opt_state"]
    losses = state["window_losses"]
    steps = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        with rec.span("step"):
            batch = {"tokens": batches[state["next"] % batches.shape[0]]}
            params, opt_state, met = step_fn(params, opt_state, batch)
        losses.append(met["loss"])
        state["next"] += 1
        steps += 1
    with rec.span("sync"):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    state["params"], state["opt_state"] = params, opt_state
    return steps, time.perf_counter() - t0


def window(state, seconds: float, trace: bool, run: Run) -> None:
    """The measured window, untraced; with `trace`, then a traced segment of
    TRACE_SHARE of its length (its work under run.trace_work)."""
    b, s = state["batches"].shape[1:]
    steps, run.window_s = _loop(state, seconds, Recorder(False))
    run.counts.update(steps=steps, tokens_per_step=float(b * s))
    run.work["train_step"] = [(int(b), int(s))] * steps
    run.attempted = steps
    if trace:
        with traced(state["device"]) as rec:
            n, rec.window_s = _loop(state, seconds * TRACE_SHARE, rec)
        run.trace = rec.trace
        run.trace_work["train_step"] = [(int(b), int(s))] * n
        run.attempted += n
    run.failed = int(sum(not np.isfinite(float(v)) for v in state["window_losses"]))


def release(state) -> None:
    for key in ("step_fn", "params", "opt_state", "window_losses"):
        state.pop(key, None)


def _picks(leaves, seed: int, n: int = 16384) -> Dict[str, torch.Tensor]:
    """`n` element positions of each leaf (with repeats), drawn from the seed."""
    gen = torch.Generator().manual_seed(seed_of(seed, 9))
    return {k: torch.randint(0, v.numel(), (n,), generator=gen).to(v.device) for k, v in leaves}


def _worst(prog: Dict[str, float], ref: Dict[str, float], keep) -> float:
    """The largest |prog - ref| of a leaf, over the larger of the leaf's
    reference norm and the median leaf's."""
    med = float(np.median([ref[k] for k in keep]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)


def reference_steps(state, precision: str = "float32"):
    """The reference's losses, first clipped gradient norms and parameter
    changes over the checked steps, from the same weights and batches."""
    m, device = state["m"], state["device"]
    flat0 = dict(leaf_paths(make_weights(m, seed_of(state["seed"], 1), device)))
    dec = ref_decoder.Decoder(m, ref_decoder.Precision(precision))
    opt = AdamW(state["tc"])
    params = dict(flat0)
    losses, grad1, grad1_at = [], {}, {}
    for i in range(state["mix"]["checked_steps"]):
        p32 = {k: v.float().requires_grad_() for k, v in params.items()}
        loss = dec.loss(p32, state["batches"][i])
        grads = torch.autograd.grad(loss, list(p32.values()))
        del p32
        params = opt.update(params, dict(zip(params, grads)))
        del grads
        losses.append(float(loss.detach()))
        if i == 0:
            grad1 = {k: float(g.norm()) for k, g in opt.last_grads.items()}
            picks = _picks(opt.last_grads.items(), state["seed"])
            grad1_at = {k: g.reshape(-1)[picks[k]] for k, g in opt.last_grads.items()}
    change = {k: float((params[k].float() - flat0[k].float()).norm()) for k in params}
    return losses, grad1, grad1_at, change


def check(state, run: Run) -> Dict[str, float]:
    """loss_err: the largest relative gap of a checked step's loss
    (loss1_err: the first step's); grad_err, update_err: the worst leaf's
    gap of the first clipped gradient's norm and of the change over the
    checked steps; grad_dir_err: the worst leaf's |program - reference|
    over |reference| of the first clipped gradient at `_picks`' seeded
    elements. The change and grad_dir_err leave out the leaves whose
    reference gradient is under a thousandth of the median leaf's (they
    move by round-off alone)."""
    losses, grad1, grad1_at, change = reference_steps(state)
    gaps = [abs(a - b) / abs(b) for a, b in zip(state["losses"], losses)]
    run.counts.update({f"loss_err.step{i + 1}": g for i, g in enumerate(gaps)})
    grad_err = _worst(state["grad1"], grad1, list(grad1))
    med = float(np.median(list(grad1.values())))
    moved = [k for k in grad1 if grad1[k] >= 1e-3 * med]
    update_err = _worst(state["change"], change, moved)
    grad_dir_err = max(float((state["grad1_at"][k] - grad1_at[k]).norm() / grad1_at[k].norm())
                       for k in moved)
    run.counts["leaves_left_out"] = len(grad1) - len(moved)
    return {"loss_err": max(gaps), "loss1_err": gaps[0], "grad_err": grad_err,
            "grad_dir_err": grad_dir_err, "update_err": update_err}


def control(state, run: Run) -> Dict[str, float]:
    """The numbers of the reference computed with fp8 products (the
    control for a bf16 configuration) put in the program's place."""
    (state["losses"], state["grad1"], state["grad1_at"],
     state["change"]) = reference_steps(state, "fp8")
    return check(state, run)
