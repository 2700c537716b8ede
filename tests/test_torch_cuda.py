"""The port's hand-written CUDA kernels against their plain versions, on
the card. Every test here is marked `cuda` and skips without a card.

This file imports neither JAX nor `repro`, so it runs on a machine that has
only the port's dependencies. There, run it without the suite's conftest
(which builds a JAX benchmark fixture):

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.topk_sim import kernel as topk_kernel
from repro_torch.kernels.topk_sim.ops import topk_sim
from repro_torch.kernels.topk_sim.ref import topk_sim_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    return torch.device("cuda")


def _unit_rows(rng, n, d, device):
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize(
    "q,t,d,k",
    [(1, 2413, 384, 5), (8, 2413, 384, 25), (33, 5003, 384, 25), (7, 199, 384, 5),
     (33, 513, 256, 3), (5, 300, 64, 128), (130, 777, 100, 1), (2, 1, 8, 1)],
)
def test_topk_sim_kernel_matches_plain(cuda_device, q, t, d, k):
    rng = np.random.default_rng(q * 7919 + t)
    qt, tt = _unit_rows(rng, q, d, cuda_device), _unit_rows(rng, t, d, cuda_device)
    before = topk_kernel.launches
    ks, ki = topk_sim(qt, tt, k)
    torch.cuda.synchronize()
    assert topk_kernel.launches == before + 2  # pass 1 and pass 2
    rs, ri = topk_sim_ref(qt, tt, k)
    torch.testing.assert_close(ks, rs, atol=1e-5, rtol=0)
    assert torch.equal(ki, ri)


@pytest.mark.parametrize("k", [8, 128])
def test_topk_sim_kernel_ties_to_lowest_index(cuda_device, k):
    """One-hot rows tiled so bitwise ties cross every tile and split."""
    base = torch.zeros((9, 128), device=cuda_device)
    base[torch.arange(9), torch.arange(9)] = 1.0
    table = base.repeat(5000, 1).contiguous()
    q = _unit_rows(np.random.default_rng(1), 4, 128, cuda_device)
    ks, ki = topk_kernel.topk_sim_cuda(q, table, k)
    rs, ri = topk_sim_ref(q, table, k)
    torch.testing.assert_close(ks, rs, atol=1e-6, rtol=0)
    assert torch.equal(ki, ri)
    best = q[:, :9].argmax(dim=1)
    assert torch.equal(ki, best[:, None] + 9 * torch.arange(k, device=cuda_device)[None, :])


def test_topk_sim_kernel_rejects_bad_inputs(cuda_device):
    q = torch.zeros((2, 8), device=cuda_device)
    t = torch.zeros((300, 8), device=cuda_device)
    for bad in (
        lambda: topk_kernel.topk_sim_cuda(q.double(), t.double(), 2),  # dtype
        lambda: topk_kernel.topk_sim_cuda(q, t[:, :4], 2),  # D mismatch
        lambda: topk_kernel.topk_sim_cuda(q, t.T, 2),  # not contiguous
        lambda: topk_kernel.topk_sim_cuda(q, t, 129),  # k above the kernel's limit
        lambda: topk_kernel.topk_sim_cuda(q, t[:3], 4),  # k > T
    ):
        with pytest.raises(ValueError):
            bad()
    empty_s, empty_i = topk_kernel.topk_sim_cuda(q[:0], t, 2)
    assert empty_s.shape == (0, 2) and empty_i.shape == (0, 2)
