"""Parity of the port's block-masked matmul (repro_torch) against the JAX
package.

Bit for bit: ``block_mask`` and ``tile_skip_fraction``. Within 1e-5 of the
output's scale (float32 summation order only): ``masked_matmul_ref`` and
the kernel wrapper (its plain version here) against the Pallas kernel in
interpret mode and the reference's plain version, with a caller's mask
that kills a nonzero tile; ``sparse_dense_matmul`` at shapes that are not
tile multiples (130, 70, 50), as the reference's own test runs it. The
``ValueError`` cases of ``block_mask`` and of the contraction check.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import sparsity as jsparsity
from repro.kernels.masked_matmul import ops as jmm_ops
from repro.kernels.masked_matmul.kernel import masked_matmul as jmasked_matmul
from repro.kernels.masked_matmul.ref import masked_matmul_ref as jmm_ref
from repro_torch.core import sparsity
from repro_torch.kernels.masked_matmul import kernel as mm_kernel
from repro_torch.kernels.masked_matmul import ops as mm_ops
from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, tol=TOL):
    p, r = port.numpy(), np.asarray(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    scale = max(1.0, float(np.abs(r).max(initial=0.0)))
    assert float(np.abs(p - r).max(initial=0.0)) <= tol * scale


def _tiled(rng, m, k, bm, bk, dead=0.4):
    """A with a share of all-zero (bm x bk) tiles."""
    a = rng.standard_normal((m, k)).astype(np.float32)
    kill = rng.random((m // bm, k // bk)) < dead
    a.reshape(m // bm, bm, k // bk, bk)[kill[:, None, :, None]
                                        .repeat(bm, 1).repeat(bk, 3)] = 0.0
    return a


@pytest.mark.parametrize("m,k,bm,bk", [(64, 48, 16, 16), (256, 256, 128, 128),
                                       (40, 24, 8, 12)])
def test_block_mask_and_skip_fraction_bit_identical(m, k, bm, bk):
    a = _tiled(np.random.default_rng(m), m, k, bm, bk)
    got = sparsity.block_mask(_t(a), bm, bk)
    want = jsparsity.block_mask(jnp.asarray(a), bm, bk)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < got.numel()
    skip = mm_ops.tile_skip_fraction(_t(a), bm, bk)
    jskip = jmm_ops.tile_skip_fraction(jnp.asarray(a), bm, bk)
    assert np.asarray(skip.numpy()) == np.asarray(jskip)
    assert skip.dtype == torch.float32


def _killing_mask(rng, a, bm, bk):
    """The block mask of ``a`` with one nonzero tile killed as well."""
    mask = sparsity.block_mask(_t(a), bm, bk).to(torch.int32)
    live = torch.nonzero(mask)
    i, j = live[int(rng.integers(len(live)))].tolist()
    mask[i, j] = 0
    assert np.abs(a[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk]).max() > 0
    return mask


@pytest.mark.parametrize("m,k,n,bm,bn,bk", [(64, 48, 32, 16, 16, 16),
                                            (256, 256, 128, 128, 128, 128)])
def test_masked_matmul_kills_nonzero_tile_like_reference(m, k, n, bm, bn, bk):
    rng = np.random.default_rng(k)
    a = _tiled(rng, m, k, bm, bk)
    b = rng.standard_normal((k, n)).astype(np.float32)
    mask = _killing_mask(rng, a, bm, bk)
    got = masked_matmul_ref(_t(a), _t(b), mask, bm=bm, bk=bk)
    jargs = (jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask.numpy()))
    _close(got, jmm_ref(*jargs, bm=bm, bn=bn, bk=bk))
    _close(got, jmasked_matmul(*jargs, bm=bm, bn=bn, bk=bk, interpret=True))
    # the killed tile changed the result: the mask is honoured
    assert not np.allclose(got.numpy(), a @ b, atol=1e-3)
    # the wrapper's CPU path is the plain version, and launches nothing
    before = mm_kernel.launches
    wrapped = mm_kernel.masked_matmul(_t(a), _t(b), mask, bm=bm, bn=bn,
                                      bk=bk)
    assert mm_kernel.launches == before
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("seed", range(4))
def test_sparse_dense_matmul_non_multiple_shapes(seed):
    rng = np.random.default_rng(seed)
    m, k, n = 130, 70, 50                      # none a multiple of 128
    a = rng.standard_normal((m, k)).astype(np.float32)
    a[rng.random(m) < 0.5] = 0.0               # some skippable tiles
    b = rng.standard_normal((k, n)).astype(np.float32)
    got = mm_ops.sparse_dense_matmul(_t(a), _t(b))
    assert got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-4, atol=1e-5)
    for impl in ("interpret", "ref"):
        _close(got, jmm_ops.sparse_dense_matmul(jnp.asarray(a),
                                                jnp.asarray(b), impl=impl))


def test_sparse_dense_matmul_small_tiles_skip():
    rng = np.random.default_rng(7)
    a = _tiled(rng, 96, 64, 16, 16, dead=0.6)[:90, :60]
    b = rng.standard_normal((60, 20)).astype(np.float32)
    got = mm_ops.sparse_dense_matmul(_t(a), _t(b), bm=16, bn=16, bk=16)
    want = jmm_ops.sparse_dense_matmul(jnp.asarray(a), jnp.asarray(b),
                                       bm=16, bn=16, bk=16, impl="interpret")
    _close(got, want)


def test_block_mask_non_multiple_raises_valueerror():
    with pytest.raises(ValueError, match="tile-multiple"):
        sparsity.block_mask(torch.ones(10, 10), 8, 8)
    with pytest.raises(ValueError):
        jsparsity.block_mask(jnp.ones((10, 10)), 8, 8)


def test_sparse_dense_matmul_contraction_mismatch_raises():
    with pytest.raises(ValueError, match="contraction mismatch"):
        mm_ops.sparse_dense_matmul(torch.ones(8, 5), torch.ones(6, 3))
    with pytest.raises(ValueError, match="contraction mismatch"):
        jmm_ops.sparse_dense_matmul(jnp.ones((8, 5)), jnp.ones((6, 3)))


def test_masked_matmul_wrapper_rejects_bad_inputs():
    a, b = torch.ones(32, 32), torch.ones(32, 16)
    mask = torch.ones(2, 2, dtype=torch.int32)
    kw = dict(bm=16, bn=16, bk=16)
    assert mm_kernel.masked_matmul(a, b, mask, **kw).shape == (32, 16)
    with pytest.raises(TypeError, match="a must be torch.float32"):
        mm_kernel.masked_matmul(a.double(), b, mask, **kw)
    with pytest.raises(ValueError, match="b has shape"):
        mm_kernel.masked_matmul(a, torch.ones(16, 16), mask, **kw)
    with pytest.raises(ValueError, match="N=16 is not a multiple"):
        mm_kernel.masked_matmul(a, b, mask, bm=16, bn=32, bk=16)
    with pytest.raises(TypeError, match="mask must be torch.int32"):
        mm_kernel.masked_matmul(a, b, mask.bool(), **kw)
    with pytest.raises(ValueError, match="mask has shape"):
        mm_kernel.masked_matmul(a, b, mask[:1], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        mm_kernel.masked_matmul(a.t(), b, mask, **kw)
