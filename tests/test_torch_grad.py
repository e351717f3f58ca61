"""Gradients of the port's fused execution (``apply_tiles``) against the
JAX package's ``jax.grad``.

The forward skips the tiles whose rows are all exactly zero (SPAC); the
backward must still send ``W^T g`` to those rows, as the reference's
custom VJP does over the geometry liveness. Clouds here zero enough rows
to leave whole tiles dead (K = 27, bm = bo = 32). Within 1e-5 of the scale
(float32 summation order only), through ``impl="ref"`` and through the
kernel wrapper's CPU branch, whose gradients must also be identical.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import plan as jplan
from repro.core import sparsity as jsparsity
from repro.kernels.spconv_gemm import ops as jsg_ops
from repro_torch.core import rulebook, sparsity
from repro_torch.kernels.spconv_gemm import ops as sg_ops
from tests.proptest import random_cloud

TOL = 1e-5
BM = BO = 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, tol=TOL):
    p, r = port.detach().numpy(), np.asarray(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    scale = max(1.0, float(np.abs(r).max(initial=0.0)))
    assert float(np.abs(p - r).max(initial=0.0)) <= tol * scale


def _layer(seed, n=300, n_zero=200, c_in=6, c_out=10):
    """A Subm3 layer whose first ``n_zero`` rows are exactly zero, its
    geometry tiles, and an output cotangent."""
    rng = np.random.default_rng(seed)
    c, b, v = random_cloud(rng, n, 8)
    kmap = np.asarray(jplan.subm3_plan(jnp.asarray(c), jnp.asarray(b),
                                       jnp.asarray(v), max_blocks=n,
                                       bm=8).kmap)
    f = rng.standard_normal((n, c_in)).astype(np.float32)
    f[:n_zero] = 0.0
    w = rng.standard_normal((27, c_in, c_out)).astype(np.float32)
    g = rng.standard_normal((n, c_out)).astype(np.float32)
    return kmap, f, w, g


def _port_grads(kmap, f, w, g, impl):
    tiles = sg_ops.build_tap_tiles(_t(kmap), bm=BM, bo=BO)
    ft, wt = _t(f).requires_grad_(), _t(w).requires_grad_()
    out = sg_ops.apply_tiles(ft, wt, tiles, n_out=kmap.shape[0],
                             row_nz=sparsity.row_nonzero(ft), impl=impl)
    out.backward(_t(g))
    dead = int((sg_ops.tile_liveness(tiles, sparsity.row_nonzero(_t(f)))
                == 0).sum() - (tiles.tile_nz == 0).sum())
    return out, ft.grad, wt.grad, dead


def _ref_grads(kmap, f, w, g):
    tiles = jsg_ops.build_tap_tiles(jnp.asarray(kmap), None, bm=BM, bo=BO)
    n = kmap.shape[0]

    def loss(a, b):
        out = jsg_ops.apply_tiles(a, b, tiles, n_out=n,
                                  row_nz=jsparsity.row_nonzero(a),
                                  impl="ref")
        return jnp.sum(out * jnp.asarray(g)), out

    (_, out), (df, dw) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(jnp.asarray(f),
                                                          jnp.asarray(w))
    return out, df, dw


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("seed", range(2))
def test_apply_tiles_grads_match_jax_grad(seed, impl):
    kmap, f, w, g = _layer(seed)
    out, df, dw, dead = _port_grads(kmap, f, w, g, impl)
    assert dead > 0, "the cloud must leave whole tiles dead"
    jout, jdf, jdw = _ref_grads(kmap, f, w, g)
    _close(out, jout)
    _close(df, jdf)
    _close(dw, jdw)
    # the elided rows get W^T g, not 0
    assert float(df[:200].abs().max()) > 0


@pytest.mark.parametrize("seed", range(2))
def test_apply_tiles_grads_equal_across_impls(seed):
    kmap, f, w, g = _layer(seed + 5, n_zero=150)
    _, df_ref, dw_ref, _ = _port_grads(kmap, f, w, g, "ref")
    _, df_k, dw_k, _ = _port_grads(kmap, f, w, g, "kernel")
    assert torch.equal(df_ref, df_k)
    assert torch.equal(dw_ref, dw_k)


def test_apply_tiles_grads_match_unelided_scan():
    """The elided fused path and the un-elided tap scan have one
    gradient."""
    kmap, f, w, g = _layer(7)
    _, df, dw, _ = _port_grads(kmap, f, w, g, None)
    ft, wt = _t(f).requires_grad_(), _t(w).requires_grad_()
    rulebook.apply_kmap_gather(ft, wt, _t(kmap)).backward(_t(g))
    _close(df, ft.grad.numpy())
    _close(dw, wt.grad.numpy())


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_apply_tiles_epilogue_backward_raises(impl):
    kmap, f, w, _ = _layer(3)
    n = kmap.shape[0]
    tiles = sg_ops.build_tap_tiles(_t(kmap), bm=BM, bo=BO)
    rng = np.random.default_rng(4)
    epi = sg_ops.FusedEpilogue(_t(rng.uniform(0.5, 1.5, 10)
                                  .astype(np.float32)),
                               _t(rng.uniform(-0.5, 0.5, 10)
                                  .astype(np.float32)),
                               torch.ones(n, dtype=torch.bool))
    ft = _t(f).requires_grad_()
    y, act = sg_ops.apply_tiles(ft, _t(w), tiles, n_out=n,
                                row_nz=sparsity.row_nonzero(ft),
                                epilogue=epi, impl=impl)
    assert y.requires_grad and not act.blk_nz.requires_grad
    with pytest.raises(NotImplementedError, match="inference-only"):
        y.sum().backward()
