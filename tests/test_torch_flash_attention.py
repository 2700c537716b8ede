"""Parity of the port's flash-attention op with the JAX reference.

The same numpy inputs (made from a seed) go through the JAX oracle
(`repro.kernels.flash_attention.ref.attention_ref`), the Pallas kernel in
interpret mode, and the port's plain version and public op on CPU tensors
(where the op serves the plain version). Tolerances are those of
`tests/test_kernels.py`: float32 atol=2e-5, bfloat16 atol=3e-2. The
grouped-query case holds the op (k and v with fewer heads than q) against
the JAX model's `gqa_attention` under `_causal_mask`, which is what
`attn_block` replaces with it. The CUDA kernels themselves are held against
the plain version on the card in `tests/test_torch_cuda.py`; which of the two
a CUDA input takes (`kernel.flash_route`) is a pure function of its type,
head dim and alignment, checked here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models.layers import _causal_mask as jax_causal_mask
from repro.models.layers import gqa_attention as jax_gqa_attention
from repro_torch.kernels.flash_attention import kernel as cuda_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

SHAPES = [
    (2, 128, 128, 64, True, 0, 0),
    (3, 200, 200, 64, True, 0, 0),
    (2, 256, 256, 128, True, 64, 0),
    (1, 1, 300, 64, True, 0, 299),  # decode step
    (2, 128, 128, 80, False, 0, 0),  # cross-attention, padded head dim
    (1, 96, 160, 64, True, 0, 64),  # chunked prefill continuation
]


def _qkv(rng, bh, sq, skv, hd, bhkv=None):
    bhkv = bh if bhkv is None else bhkv
    return (rng.normal(size=(bh, sq, hd)).astype(np.float32),
            rng.normal(size=(bhkv, skv, hd)).astype(np.float32),
            rng.normal(size=(bhkv, skv, hd)).astype(np.float32))


@pytest.mark.parametrize("bh,sq,skv,hd,causal,window,q_offset", SHAPES)
def test_flash_attention_shapes_match_jax(bh, sq, skv, hd, causal, window, q_offset):
    q, k, v = _qkv(np.random.default_rng(bh * 1000 + sq), bh, sq, skv, hd)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ref = np.asarray(jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    pallas = np.asarray(flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               interpret=True, **kw))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    plain = attention_ref(tq, tk, tv, **kw).numpy()
    op = flash_attention(tq, tk, tv, **kw).numpy()
    for name, got in (("pallas", pallas), ("plain", plain), ("op", op)):
        np.testing.assert_allclose(got, ref, atol=2e-5, err_msg=name)
    np.testing.assert_array_equal(op, plain)  # the op serves the plain version on the CPU


def test_flash_attention_bf16_matches_jax():
    q, k, v = _qkv(np.random.default_rng(7), 2, 128, 128, 64)
    ref = jax_attention_ref(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    got = flash_attention(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=3e-2)


@pytest.mark.parametrize("s,window", [(48, 0), (48, 16), (37, 16)])
def test_flash_attention_gqa_matches_gqa_attention(s, window):
    """4 q-heads over 2 kv-heads: row b*H + h reads kv row b*Hkv + h // 2."""
    b, h, hkv, hd = 2, 4, 2, 64
    rng = np.random.default_rng(s + window)
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    ref = np.asarray(jax_gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jax_causal_mask(s, s, 0, window)))

    def heads_major(x):
        return torch.from_numpy(x).permute(0, 2, 1, 3).reshape(-1, s, hd)

    got = flash_attention(heads_major(q), heads_major(k), heads_major(v), causal=True,
                          window=window)
    got = got.reshape(b, h, s, hd).permute(0, 2, 1, 3).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_flash_attention_dispatch_and_input_checks():
    q, k, v = map(torch.from_numpy, _qkv(np.random.default_rng(3), 2, 8, 8, 16))
    np.testing.assert_array_equal(flash_attention(q, k, v, use_kernel=False).numpy(),
                                  attention_ref(q, k, v).numpy())
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention(q, k, v, use_kernel=True)  # the kernel never takes CPU tensors
    with pytest.raises(ValueError, match="no path"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    before = cuda_kernel.launches
    flash_attention(q, k, v)
    assert cuda_kernel.launches == before  # the plain version counts no launch


def _tensor(shape, dtype, misaligned):
    """A contiguous tensor whose data starts one element past an aligned base
    when `misaligned` (2 or 4 bytes: no longer a multiple of 16)."""
    n = int(np.prod(shape))
    flat = torch.zeros(n + 1, dtype=dtype)
    return (flat[1:] if misaligned else flat[:n]).view(shape)


@pytest.mark.parametrize("misaligned", [None, "q", "k", "v"])
@pytest.mark.parametrize("hd", [8, 36, 64, 80, 128, 136])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_route(dtype, hd, misaligned):
    """bf16 with hd % 8 == 0, hd <= 128 and 16-byte aligned bases takes the
    tensor-core kernel; float32 (no TF32) and every other bf16 input the FMA
    kernel."""
    q, k, v = (_tensor((2, 5, hd), dtype, misaligned == name) for name in "qkv")
    want = ("wgmma" if dtype == torch.bfloat16 and hd % 8 == 0 and hd <= 128
            and misaligned is None else "fma")
    assert cuda_kernel.flash_route(dtype, hd, q, k, v) == want
    # no key at all: nothing for TMA to describe
    assert cuda_kernel.flash_route(dtype, hd, q, k[:, :0], v[:, :0]) == "fma"
