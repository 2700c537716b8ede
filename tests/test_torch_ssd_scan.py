"""Parity of the port's SSD chunk-scan op with the JAX reference.

The same numpy inputs (made from a seed) go through the JAX oracle
(`repro.kernels.ssd_scan.ref.ssd_scan_ref`, i.e. `models.ssm.ssd_chunked`),
the Pallas kernel in interpret mode, and the port's plain version and
public op on CPU tensors (where the op serves the plain version), at the
tolerance of `tests/test_kernels.py` (atol=1e-3). The second shape has
G=2 groups over H=8 heads. The port's `ssm_block`, which pads a ragged
sequence with dt = 0 before the scan, is held against the JAX block at a
length that is not a chunk multiple. The CUDA kernel itself is held
against the plain version on the card in `tests/test_torch_cuda.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES
from repro.kernels.ssd_scan.kernel import ssd_scan_pallas
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.models import model as JM
from repro.models import ssm as jax_ssm
from repro.models.config import reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels.ssd_scan import kernel as cuda_kernel
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models import ssm

SHAPES = [(2, 256, 4, 64, 1, 128, 64), (1, 512, 8, 64, 2, 64, 128), (2, 128, 2, 32, 1, 16, 32)]


def _inputs(rng, b, s, h, p, g, n, dt_lo=0.1, dt_span=0.5):
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            (dt_lo + dt_span * rng.random((b, s, h))).astype(np.float32),
            (rng.normal(size=(h,)) * 0.5).astype(np.float32),
            (rng.normal(size=(b, s, g, n)) * 0.3).astype(np.float32),
            (rng.normal(size=(b, s, g, n)) * 0.3).astype(np.float32))


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
def test_ssd_scan_shapes_match_jax(b, s, h, p, g, n, chunk):
    args = _inputs(np.random.default_rng(s + h), b, s, h, p, g, n)
    ry, rst = jax_ssd_scan_ref(*map(jnp.asarray, args), chunk)
    py, pst = ssd_scan_pallas(*map(jnp.asarray, args), chunk, interpret=True)
    targs = [torch.from_numpy(a) for a in args]
    plain_y, plain_st = ssd_scan_ref(*targs, chunk)
    op_y, op_st = ssd_scan(*targs, chunk)
    assert op_y.shape == (b, s, h, p) and op_st.shape == (b, h, p, n)
    assert op_st.dtype == torch.float32
    for name, (y, st) in (("pallas", (py, pst)), ("plain", (plain_y, plain_st)),
                          ("op", (op_y, op_st))):
        np.testing.assert_allclose(np.asarray(y), np.asarray(ry), atol=1e-3, err_msg=name)
        np.testing.assert_allclose(np.asarray(st), np.asarray(rst), atol=1e-3, err_msg=name)


def test_ssd_scan_matches_sequential_recurrence():
    """Chunked SSD == naive per-token recurrence (the SSM decode path)."""
    b, s, h, p, n, chunk = 1, 64, 2, 16, 8, 16
    args = _inputs(np.random.default_rng(11), b, s, h, p, 1, n, dt_span=0.3)
    x, dt, a_log, bm, cm = args
    y, st = ssd_scan(*map(torch.from_numpy, args), chunk)
    a = -np.exp(a_log)
    state = np.zeros((b, h, p, n), np.float64)
    ys = np.zeros((b, s, h, p), np.float64)
    for t in range(s):
        da = np.exp(dt[:, t] * a)
        bx = np.einsum("bh,bhn,bhp->bhpn", dt[:, t], bm[:, t, 0][:, None, :].repeat(h, 1), x[:, t])
        state = state * da[:, :, None, None] + bx
        ys[:, t] = np.einsum("bhn,bhpn->bhp", cm[:, t, 0][:, None, :].repeat(h, 1), state)
    np.testing.assert_allclose(y.numpy(), ys, atol=1e-3)
    np.testing.assert_allclose(st.numpy(), state, atol=1e-3)


@pytest.mark.parametrize("s", [45, 64])
def test_ssm_block_matches_jax(s):
    """Reduced mamba2 (chunk 32): 45 tokens pad to 64 with dt = 0."""
    cfg = reduced(ARCHITECTURES["mamba2-2.7b"])
    jp = jax.tree.map(lambda t: t[0], JM.init(cfg, jax.random.PRNGKey(1))["layers"]["ssm"])
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(s).normal(size=(2, s, cfg.d_model)).astype(np.float32)
    jout, (jconv, jst) = jax_ssm.ssm_block(jp, jnp.asarray(x), cfg, return_cache=True)
    tout, (tconv, tst) = ssm.ssm_block(tp, torch.from_numpy(x), cfg, return_cache=True)
    for got, ref in ((tout, jout), (tconv, jconv), (tst, jst)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3, rtol=1e-3)


def test_ssd_scan_dispatch_and_input_checks():
    args = [torch.from_numpy(a) for a in _inputs(np.random.default_rng(5), 1, 32, 2, 8, 1, 4)]
    y, st = ssd_scan(*args, 16, use_kernel=False)
    ry, rst = ssd_scan_ref(*args, 16)
    assert torch.equal(y, ry) and torch.equal(st, rst)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_scan(*args, 16, use_kernel=True)  # the kernel never takes CPU tensors
    with pytest.raises(ValueError, match="no path"):
        ssd_scan(*(a.to("meta") for a in args), 16)
    before = cuda_kernel.launches
    ssd_scan(*args, 16)
    assert cuda_kernel.launches == before  # the plain version counts no launch


@pytest.mark.parametrize("b,s,h,p,g,n", [(1, 512, 4, 32, 1, 16), (2, 256, 6, 16, 3, 8)])
def test_ssd_chunked_tile_64_matches_pallas_chunk_256(b, s, h, p, g, n):
    """The chunked algorithm is exact for any chunk length, which the CUDA
    kernel's 64-row tiles rely on: the port's plain `ssd_chunked` at chunk
    64 against the Pallas kernel (interpret mode) at chunk 256, within the
    file's atol=1e-3."""
    args = _inputs(np.random.default_rng(s + n), b, s, h, p, g, n)
    py, pst = ssd_scan_pallas(*map(jnp.asarray, args), 256, interpret=True)
    y, st = ssm.ssd_chunked(*map(torch.from_numpy, args), 64)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), atol=1e-3)
    np.testing.assert_allclose(st.numpy(), np.asarray(pst), atol=1e-3)
