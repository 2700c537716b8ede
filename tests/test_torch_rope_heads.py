"""The port's rope_heads op (RoPE on q and k, q, k and v heads-major) on the CPU.

`repro_torch.kernels.rope_heads.ref.rope_heads_ref` is what the CUDA kernel
computes in one launch; here it is held bit for bit to the composition
`attn_block` ran before the kernel existed, `layers.rope` of q and of k and
`layers._heads_major` of q, k and v, and the op on CPU tensors serves it.
`attn_block`'s kernel path builds its decode cache from views of the op's
heads-major k and v rows: the cache equals the plain path's bit for bit.
The kernel itself is held against `rope_heads_ref` on the card in
`tests/test_torch_cuda.py`.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.rope_heads import kernel as cuda_kernel
from repro_torch.kernels.rope_heads.ops import rope_heads
from repro_torch.kernels.rope_heads.ref import rope_heads_ref
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models.config import reduced


def _inputs(seed, b, s, h, hkv, hd, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, s, n, hd, generator=g).to(dtype) for n in (h, hkv, hkv))


def _positions(b, s, offset):
    """[B, S] int64: an expanded arange from 0, as prefill passes it, or each
    batch row from its own offset."""
    if not offset:
        return torch.arange(s)[None].expand(b, s)
    return torch.arange(s)[None] + offset * (1 + torch.arange(b)[:, None])


@pytest.mark.parametrize("offset", [0, 1000])
@pytest.mark.parametrize("s", [1, 37, 512])
@pytest.mark.parametrize("h,hkv", [(25, 5), (32, 8), (16, 2)])
@pytest.mark.parametrize("hd", [64, 80, 128])
def test_rope_heads_ref_is_rope_then_heads_major(hd, h, hkv, s, offset):
    q, k, v = _inputs(hd + h + s, 2, s, h, hkv, hd)
    pos = _positions(2, s, offset)
    got = rope_heads_ref(q, k, v, pos, 1e4)
    want = (layers._heads_major(layers.rope(q, pos, 1e4)),
            layers._heads_major(layers.rope(k, pos, 1e4)), layers._heads_major(v))
    for g, w, n in zip(got, want, (h, hkv, hkv)):
        assert g.shape == (2 * n, s, hd) and g.dtype == torch.bfloat16 and g.is_contiguous()
        assert torch.equal(g, w)
    for g, w in zip(rope_heads(q, k, v, pos, 1e4), got):  # the op serves it on the CPU
        assert torch.equal(g, w)


def test_rope_heads_dispatch_and_work():
    q, k, v = _inputs(1, 1, 8, 4, 2, 16)
    pos = _positions(1, 8, 0)
    before = cuda_kernel.launches
    rope_heads(q, k, v, pos, 1e4)
    assert cuda_kernel.launches == before  # the plain version counts no launch
    with pytest.raises(ValueError, match="CUDA tensor"):
        rope_heads(q, k, v, pos, 1e4, use_kernel=True)  # the kernel never takes CPU tensors
    with pytest.raises(ValueError, match="rope_heads: the kernel has no backward"):
        rope_heads(q.float().requires_grad_(), k.float(), v.float(), pos, 1e4, use_kernel=True)
    with pytest.raises(ValueError, match="no path"):
        rope_heads(q.to("meta"), k.to("meta"), v.to("meta"), pos.to("meta"), 1e4)
    # granite-3-8b's layer at 2,048 tokens: 25 MB read and 25 MB written in bf16
    work = cuda_kernel.cost(1, 2048, 32, 8, 128)
    assert work["bytes_accessed"] == 2 * 2 * 2048 * 48 * 128 + 8 * 2048
    assert work["flops"] == 3 * 2048 * 40 * 128


@pytest.mark.parametrize("arch,window,s,max_len", [
    ("granite-3-8b", 0, 40, 48),  # full attention, the cache padded to the decode budget
    ("granite-3-8b", 0, 40, 0),  # full attention, the prompt's length
    ("hymba-1.5b", 16, 40, 48),  # window, rolled to ring slots (40 % 16 != 0)
    ("hymba-1.5b", 16, 32, 48),  # window, the last W entries in place
    ("hymba-1.5b", 16, 12, 48),  # prompt under the window: padded
])
def test_attn_block_kernel_path_cache_equals_plain(monkeypatch, arch, window, s, max_len):
    """The kernel path (forced on the CPU, rope_heads and flash served by
    their plain versions) returns the plain path's decode cache bit for bit, though its
    k and v are views of the heads-major rows, and an output within the
    flash tests' float32 2e-5."""
    cfg = reduced(get_config(arch), sliding_window=window)
    params = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    p = M._layer(params["layers"], 0)["attn"]
    x = torch.randn(2, s, cfg.d_model, generator=torch.Generator().manual_seed(1))
    pos = _positions(2, s, 0)
    flash, rope_heads_op = layers.flash_attention, layers.rope_heads
    monkeypatch.setattr(layers, "flash_attention",
                        lambda *a, **kw: flash(*a, **{**kw, "use_kernel": False}))
    monkeypatch.setattr(layers, "rope_heads",
                        lambda *a, **kw: rope_heads_op(*a, **{**kw, "use_kernel": False}))
    out, (k, v) = layers.attn_block(p, x, cfg, pos, return_cache=True, max_cache_len=max_len,
                                    use_kernel=True)
    want_out, (want_k, want_v) = layers.attn_block(p, x, cfg, pos, return_cache=True,
                                                   max_cache_len=max_len, use_kernel=False)
    assert k.shape == want_k.shape and torch.equal(k, want_k) and torch.equal(v, want_v)
    torch.testing.assert_close(out, want_out, atol=2e-5, rtol=0)
