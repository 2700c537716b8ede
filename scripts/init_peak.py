#!/usr/bin/env python3
"""The peak device memory of command-r-plus-104b's seeded init at a depth
cut, on one NVIDIA card.

    python3 scripts/init_peak.py LAYERS

Run from the root of a checkout on a machine with a card. `M.init` draws
each stacked leaf in float32 and then casts it to bf16, so the init's
peak holds the largest leaf's float32 draw beside what is already cast;
this prints the card's free memory, then the init's peak and what it
holds, or the allocator's refusal when it runs out of memory. Phase 12
of chip_smoke.py cuts command-r-plus-104b to the depth this allows.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main() -> int:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    n = int(sys.argv[1])
    cfg = dataclasses.replace(get_config("command-r-plus-104b"), n_layers=n)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    free, total = torch.cuda.mem_get_info()
    print(f"card total {total / 1e9:.2f} GB, free {free / 1e9:.2f} GB before init; "
          f"params {cfg.param_count() / 1e9:.3f} B", flush=True)
    try:
        M.init(cfg, gen, device="cuda")
        torch.cuda.synchronize()
        print(f"init {n} layers OK: peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
              f"held {torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    except torch.OutOfMemoryError as e:
        print(f"init {n} layers OOM: peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB: "
              f"{str(e)[:200]}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
