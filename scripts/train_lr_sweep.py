#!/usr/bin/env python3
"""Train full-width hymba-1.5b through `repro_torch.launch.train` at a few
peak learning rates with each optimizer, on one NVIDIA card, and print
where the loss went.

    python3 scripts/train_lr_sweep.py [--lrs 1e-2,3e-2,1e-1] [--steps 20] [--rescaled]

Run from the root of a checkout on a machine with a CUDA card. Each run is
`main(["--arch", "hymba-1.5b", "--batch-size", "2", "--seq-len", "1024",
"--steps", N, "--lr", LR, "--optimizer", OPT])` in process, from the
reference's init (not rescaled), with the launcher's warmup of 100 steps:
step k's lr is LR * k / 100. Two things decide which LR trains at all. The
init's attention fan-in makes the gradient norm ~1e18 at 32 layers, so the
global-norm clip scales every gradient by ~1e-18; AdamW and Adafactor
normalise that away where the clipped gradient is above their eps. And an
update smaller than half a bf16 ulp of its weight rounds away: ~6e-5 at
the embedding's 0.02, ~5e-4 at wq's 0.2. With `--rescaled` each run
starts instead from the init with wq, wk and wv at a d_model fan-in
(`models.model.attention_at_d_model_fan_in`, as the pool's phase of
`chip_smoke.py` serves them). Prints one line a run (the logged losses,
the first gradient norm, seconds, peak memory) and the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import gc
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main() -> int:
    import torch

    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.optim.base import tree_map
    from repro_torch.training.trainer import Trainer

    class RescaledTrainer(Trainer):
        """The launcher's Trainer from the init at a d_model fan-in."""

        def __init__(self, cfg, *args, **kwargs):
            super().__init__(cfg, *args, **kwargs)
            with torch.no_grad():
                params = M.attention_at_d_model_fan_in(cfg, self.params)
            self.params = tree_map(lambda p: p.detach().requires_grad_(), params)

    ap = argparse.ArgumentParser()
    ap.add_argument("--lrs", default="1e-2,3e-2,1e-1")
    ap.add_argument("--optimizers", default="auto,adafactor")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rescaled", action="store_true",
                    help="start from the init with wq, wk, wv at a d_model fan-in")
    args = ap.parse_args()
    if args.rescaled:
        train.Trainer = RescaledTrainer
    if not torch.cuda.is_available():
        print("train_lr_sweep: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    for opt in args.optimizers.split(","):
        for lr in args.lrs.split(","):
            t0 = time.perf_counter()
            history = train.main(["--arch", "hymba-1.5b", "--batch-size", "2", "--seq-len",
                                  "1024", "--steps", str(args.steps), "--lr", lr,
                                  "--optimizer", opt])
            seconds = time.perf_counter() - t0
            print(f"sweep: {'rescaled' if args.rescaled else 'reference'} init, "
                  f"optimizer {opt} lr {lr}: loss "
                  + " -> ".join(f"{m['loss']:.4f} (step {m['step']})" for m in history)
                  + f", grad norm at step 1 {history[0]['grad_norm']:.4g}; {seconds:.1f} s, "
                  f"peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB on {card}",
                  flush=True)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
