#!/usr/bin/env python3
"""Where full-width mamba2-2.7b's greedy decode leaves a teacher-forced
forward, on one NVIDIA card.

    python3 scripts/ssm_decode_drift.py

Run from the root of a checkout on a machine with a Hopper card and nvcc.
A 2,048-token seeded prompt goes through `M.prefill` and 8 greedy
`decode_step`s, and each step's logits are held against a `forward` over
the prompt and the fed tokens at chip_smoke.py's bf16 tolerance (3e-2 plus
two bf16 ulps of the row max), under four variants: bf16 with the kernels
(as phase 12 serves it), bf16 with the plain versions, bf16 with the
decode cache's SSM state upcast to float32 after the prefill, and the
model in float32. It prints each step's max |difference|, the greedy
tokens, and `ssd_scan` against its plain version at layer 0's prefill
input.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

PROMPT, STEPS = 2048, 8


def run(cfg, params, use_kernel, state_float32=False, capture=False):
    """(max |d| a step, within tolerance a step, the forward's largest
    |logit| over the steps, layer 0's scan arguments when captured, the
    greedy tokens)."""
    import torch

    import chip_smoke
    from repro_torch.models import model as M, ssm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=gen, device=dev)
    captured, scan = [], ssm.ssd_ops.ssd_scan

    def record(*args, **kwargs):
        if not captured:
            captured.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return scan(*args, **kwargs)

    if capture:
        ssm.ssd_ops.ssd_scan = record
    try:
        with torch.no_grad():
            logits, cache = M.prefill(cfg, params, {"tokens": prompt},
                                      max_cache_len=PROMPT + STEPS + 1, use_kernel=use_kernel)
    finally:
        ssm.ssd_ops.ssd_scan = scan
    with torch.no_grad():
        if state_float32:
            cache["state"] = cache["state"].float()
        steps, fed = [logits[:, -1]], []
        for j in range(STEPS):
            tok = torch.argmax(steps[-1], dim=-1)[:, None]
            fed.append(tok)
            logits, cache = M.decode_step(cfg, params, cache, {"token": tok, "pos": PROMPT + j},
                                          use_kernel=use_kernel)
            steps.append(logits[:, -1])
        full, _ = M.forward(cfg, params, {"tokens": torch.cat([prompt] + fed, dim=1)},
                            use_kernel=use_kernel)
    close = [chip_smoke.bf16_logits_close(s, full[:, PROMPT - 1 + j]) for j, s in enumerate(steps)]
    return ([round(e, 4) for e, _ in close], [ok for _, ok in close],
            float(full[:, PROMPT - 1:].float().abs().max()), captured,
            [int(t) for t in torch.cat(fed, 1)[0]])


def main() -> int:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models import model as M

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    variants = {"bfloat16": (("kernel", dict(use_kernel=None, capture=True)),
                             ("plain", dict(use_kernel=False)),
                             ("kernel, decode state float32",
                              dict(use_kernel=None, state_float32=True))),
                "float32": (("kernel", dict(use_kernel=None, capture=True)),)}
    for dtype, runs in variants.items():
        cfg = dataclasses.replace(get_config("mamba2-2.7b"), dtype=dtype)
        params = M.init(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        for name, kwargs in runs:
            t = time.perf_counter()
            errs, oks, top, captured, tokens = run(cfg, params, **kwargs)
            print(f"{dtype} {name}: max|d| a step {errs} within {oks}; |logit| max {top:.3f}; "
                  f"tokens {tokens}; {time.perf_counter() - t:.1f} s", flush=True)
            if captured:
                x, dt, a_log, b, c, chunk = captured[0]
                y, state = ssd_kernel.ssd_scan_cuda(x, dt, a_log, b, c, chunk)
                ry, rstate = ssd_scan_ref(x, dt, a_log, b, c, chunk)
                print(f"  ssd_scan layer 0 x{list(x.shape)} {x.dtype} N={b.shape[-1]}: max|dy| "
                      f"{float((y.float() - ry.float()).abs().max()):.4g} (|y| max "
                      f"{float(ry.float().abs().max()):.4g}), max|dstate| "
                      f"{float((state - rstate).abs().max()):.4g} (|state| max "
                      f"{float(rstate.abs().max()):.4g})", flush=True)
        del params
        torch.cuda.empty_cache()
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
