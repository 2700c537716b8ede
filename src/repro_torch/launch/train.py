"""Training launcher: --arch <id> [--smoke] [--device cpu].

  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
      --steps 20 --batch-size 2 --seq-len 1024 --lr 3e-3      # on the CUDA card
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --smoke \
      --steps 50 --batch-size 4 --seq-len 128 --device cpu     # on the CPU

Counterpart of `repro/launch/train.py`, with the same arguments and the
same closing line, `loss a -> b (x% drop)`, plus `--device`: `cuda`
unless the caller asks for the CPU; without a card the launcher raises
(`resolve_device`), it never carries on on the CPU. `--smoke` selects the
reduced config (2 layers, d_model <= 256). Like the reference, the model
is `init` as it is: the attention init is not rescaled (ROADMAP.md queue
3, "the attention init's fan-in").
"""
from __future__ import annotations

import argparse

from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.lm_data import LMDataConfig, synthetic_lm_batches
from repro_torch.models.config import reduced
from repro_torch.training.train_step import TrainConfig
from repro_torch.training.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config for CPU")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the CUDA card; raises "
                         "without one); pass cpu to train on the CPU")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="auto")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    tcfg = TrainerConfig(
        steps=args.steps,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        seed=args.seed,
        train=TrainConfig(
            learning_rate=args.lr, optimizer=args.optimizer, total_steps=args.steps
        ),
    )
    trainer = Trainer(cfg, tcfg, device=device)
    data = synthetic_lm_batches(
        cfg, LMDataConfig(batch_size=args.batch_size, seq_len=args.seq_len, seed=args.seed)
    )
    history = trainer.fit(data)
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f} ({100 * (first - last) / first:.1f}% drop)")
    return history


if __name__ == "__main__":
    main()
