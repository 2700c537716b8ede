#!/usr/bin/env python3
"""Hold both topk_sim routes and the plain version against float64, on one
NVIDIA card, where float32 near-ties decide the order.

    python3 scripts/topk_near_ties.py

Run from the root of a checkout on a machine with a Hopper card and nvcc.
For unit rows drawn as `tests/test_torch_cuda.py` draws them, it counts the
positions where each route's indices differ from the plain version's
(`torch.topk(q @ t.T)` order, cuBLAS's float32 sums) and from the float64
order, and prints each differing pair with both float64 scores. The cluster
route sums a product over a tree of lanes, the split route in order over
d, and cuBLAS in an order of its own, so a pair whose float64 scores lie
closer than float32 can resolve may come out either way.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

CASES = [(8, 16384, 128), (33, 2413, 128), (64, 2047, 128), (64, 16384, 25)]  # Q, T, k


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("topk_near_ties: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from repro_torch.kernels.topk_sim import kernel as topk_kernel
    from repro_torch.kernels.topk_sim.ref import topk_sim_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def unit_rows(rng, n, d):
        x = rng.normal(size=(n, d)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        return torch.from_numpy(x).to(dev)

    for n_q, n_t, k in CASES:
        rng = np.random.default_rng(n_q * 131 + n_t + k)
        q, t = unit_rows(rng, n_q, 384), unit_rows(rng, n_t, 384)
        _, plain = topk_sim_ref(q, t, k)
        exact = q.double() @ t.double().T
        order = torch.sort(exact, dim=1, descending=True, stable=True).indices[:, :k]
        print(f"Q={n_q} T={n_t} k={k}: plain differs from float64 at "
              f"{int((plain != order).sum())} positions")
        for route in topk_kernel.ROUTES:
            _, idx = topk_kernel.topk_sim_cuda(q, t, k, route=route)
            torch.cuda.synchronize()
            differ = (idx != plain).nonzero().tolist()
            print(f"  {route}: differs from plain at {len(differ)}, from float64 at "
                  f"{int((idx != order).sum())} positions")
            for r, c in differ:
                a, b = int(idx[r, c]), int(plain[r, c])
                print(f"    row {r} position {c}: {route} {a} (float64 {float(exact[r, a]):.10f}),"
                      f" plain {b} (float64 {float(exact[r, b]):.10f})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
