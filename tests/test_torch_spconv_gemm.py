"""Parity of the port's gather-GEMM side (repro_torch) against the JAX package.

Bit for bit: all ten TapTiles streams over several (bm, bo) layouts, tile liveness and Cin-block liveness at a given bk.
Within 1e-5 (the reference's own test tolerance; only the float32
summation order differs): ``apply_tiles`` against the reference's
``_exec_ref_math``, and the kernel wrapper (its plain version here)
against the Pallas kernel in interpret mode, in both modes. The
epilogue's liveness is checked against a sweep of the port's own output.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import mapsearch as jmapsearch
from repro.kernels.spconv_gemm import ops as jsg_ops
from repro.kernels.spconv_gemm.kernel import (
    spconv_gemm_fused as jspconv_gemm_fused)
from repro_torch.core import mapsearch, morton, sparsity
from repro_torch.kernels.spconv_gemm import ops as sg_ops
from repro_torch.kernels.spconv_gemm.kernel import spconv_gemm_fused
from tests.proptest import random_cloud

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(port, ref):
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.dtype == r.dtype, (p.dtype, r.dtype)
    assert p.shape == r.shape, (p.shape, r.shape)
    assert np.array_equal(p, r)


def _close(port, ref, tol=TOL):
    p, r = port.numpy(), np.asarray(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    scale = max(1.0, float(np.abs(r).max(initial=0.0)))
    assert float(np.abs(p - r).max(initial=0.0)) <= tol * scale


def _kmap(seed, n=72, extent=7, n_valid=None):
    c, b, v = random_cloud(np.random.default_rng(seed), n, extent,
                           n_valid=n_valid)
    return jmapsearch.build_kmap_hash(c, b, v, morton.subm3_offsets())


def _feats(rng, n, c_in, bk):
    """Post-ReLU-like features with dead rows and dead Cin blocks."""
    f = np.maximum(rng.standard_normal((n, c_in)), 0).astype(np.float32)
    f[rng.random(n) < 0.25] = 0.0
    dead_blk = rng.random((n, c_in // bk)) < 0.3
    f.reshape(n, c_in // bk, bk)[dead_blk] = 0.0
    return f


LAYOUTS = [(32, None), (16, 32), (16, 48), (8, 16), (128, 128)]


@pytest.mark.parametrize("bm,bo", LAYOUTS)
def test_tap_tiles_bit_identical(bm, bo):
    kmap = _kmap(bm)
    tiles = sg_ops.build_tap_tiles(_t(kmap), bm=bm, bo=bo)
    jtiles = jsg_ops.build_tap_tiles(jnp.asarray(kmap), bm=bm, bo=bo)
    assert tiles.bo == jtiles.bo and tiles.bm == jtiles.bm
    for name in jtiles._fields[:-1]:      # the ten streams
        _eq(getattr(tiles, name), getattr(jtiles, name))


def test_tap_tiles_strided_kmap_and_empty_blocks():
    # a Gconv2 kmap over a half-empty budget: empty output blocks get their
    # forced all-pad tile exactly as in the reference
    c, b, v = random_cloud(np.random.default_rng(5), 96, 12, n_valid=40)
    maps = mapsearch.build_maps_gconv2(_t(c), _t(b), _t(v))
    kmap = mapsearch.strided_to_kmap(maps, n_out=96, n_taps=8)
    tiles = sg_ops.build_tap_tiles(kmap, bm=8, bo=16)
    jtiles = jsg_ops.build_tap_tiles(jnp.asarray(kmap.numpy()), bm=8, bo=16)
    for name in jtiles._fields[:-1]:
        _eq(getattr(tiles, name), getattr(jtiles, name))


def test_liveness_bit_identical():
    kmap = _kmap(3)
    rng = np.random.default_rng(4)
    f = _feats(rng, kmap.shape[0], 64, 16)
    tiles = sg_ops.build_tap_tiles(_t(kmap), bm=16, bo=32)
    jtiles = jsg_ops.build_tap_tiles(jnp.asarray(kmap), bm=16, bo=32)
    row_nz = sparsity.row_nonzero(_t(f))
    _eq(sg_ops.tile_liveness(tiles, row_nz),
        jsg_ops.tile_liveness(jtiles, jnp.asarray(row_nz.numpy())))
    for bk in (16, 32):
        blk = sparsity.row_block_nonzero(_t(f), bk)
        _eq(sg_ops.tile_block_liveness(tiles, blk),
            jsg_ops.tile_block_liveness(jtiles, jnp.asarray(blk.numpy())))


@pytest.mark.parametrize("c_in,c_out,bk", [(4, 24, None), (64, 130, 32)])
def test_apply_tiles_matches_reference_math(c_in, c_out, bk):
    kmap = _kmap(7)
    n = kmap.shape[0]
    rng = np.random.default_rng(c_in)
    f = _feats(rng, n, c_in, bk or c_in)
    w = rng.standard_normal((27, c_in, c_out)).astype(np.float32)
    bias = rng.standard_normal(c_out).astype(np.float32)
    tiles = sg_ops.build_tap_tiles(_t(kmap), bm=16, bo=32)
    jtiles = jsg_ops.build_tap_tiles(jnp.asarray(kmap), bm=16, bo=32)
    got = sg_ops.apply_tiles(_t(f), _t(w), tiles, _t(bias), n_out=n,
                             row_nz=sparsity.row_nonzero(_t(f)), bk=bk)
    want = jsg_ops._exec_ref_math(
        jnp.asarray(f), jnp.asarray(w), jtiles.gather_idx, jtiles.tile_tap,
        jtiles.tile_nz, jtiles.scatter_idx, n_out=n, bm=16, bn=128) + bias
    _close(got, want)


@pytest.mark.parametrize("epilogue", [False, True], ids=["plain", "epilogue"])
def test_kernel_wrapper_matches_pallas_interpret(epilogue):
    """The wrapper's CPU path against the TPU kernel itself (interpret
    mode): same tile streams, same Cin-block liveness, both modes."""
    kmap = _kmap(11, n=40, extent=5)
    n, c_in, c_out, bm, bo, bk = kmap.shape[0], 64, 128, 16, 32, 32
    rng = np.random.default_rng(12)
    f = _feats(rng, n, c_in, bk)
    w = rng.standard_normal((27, c_in, c_out)).astype(np.float32)
    jt = jsg_ops.build_tap_tiles(jnp.asarray(kmap), bm=bm, bo=bo)
    tiles = sg_ops.build_tap_tiles(_t(kmap), bm=bm, bo=bo)
    row_nz = sparsity.row_nonzero(_t(f))
    blk = sparsity.row_block_nonzero(_t(f), bk) & row_nz[:, None]
    tile_nz = sg_ops.tile_liveness(tiles, row_nz)
    tile_bk_nz = sg_ops.tile_block_liveness(tiles, blk)
    n_out_pad = -(-n // bo) * bo
    kw, jkw = {}, {}
    if epilogue:
        scale = rng.uniform(0.5, 1.5, c_out).astype(np.float32)
        shift = rng.uniform(-0.5, 0.5, c_out).astype(np.float32)
        valid = np.zeros(n_out_pad, np.int32)
        valid[:n] = rng.random(n) < 0.9
        kw = dict(epi_scale=_t(scale), epi_shift=_t(shift),
                  epi_valid=_t(valid), epilogue=True)
        jkw = dict(epi_scale=jnp.asarray(scale), epi_shift=jnp.asarray(shift),
                   epi_valid=jnp.asarray(valid), epilogue=True)
    got = spconv_gemm_fused(_t(f), _t(w), tiles.gather_idx,
                            tiles.scatter_idx, tiles.tile_tap, tile_nz,
                            tiles.tile_ob, tile_bk_nz, bm=bm, bo=bo, bk=bk,
                            n_out_pad=n_out_pad, **kw)
    want = jspconv_gemm_fused(
        jnp.asarray(f), jnp.asarray(w), jt.gather_idx, jt.scatter_idx,
        jt.tile_tap, jnp.asarray(tile_nz.numpy()), jt.tile_ob, jt.tile_first,
        jt.tile_run, jt.grp_skip, jt.grp_contig,
        tile_bk_nz=jnp.asarray(tile_bk_nz.numpy()), bm=bm, bn=128, bo=bo,
        bk=bk, n_out_pad=n_out_pad, interpret=True, **jkw)
    if not epilogue:
        _close(got, want)
        return
    out, nz = got
    _close(out, want[0])
    # the emitted liveness is exactly a sweep of the port's own output
    _eq(nz, (out.reshape(n_out_pad, 1, 128) != 0).any(-1).int().numpy())


def test_apply_tiles_epilogue_threads_act():
    kmap = _kmap(13)
    n = kmap.shape[0]
    rng = np.random.default_rng(14)
    f = _feats(rng, n, 32, 32)
    w = rng.standard_normal((27, 32, 200)).astype(np.float32)
    tiles = sg_ops.build_tap_tiles(_t(kmap), bm=16, bo=32)
    valid = torch.ones(n, dtype=torch.bool)
    valid[-5:] = False
    epi = sg_ops.FusedEpilogue(scale=torch.full((200,), 0.7),
                               shift=torch.full((200,), -0.1), valid=valid)
    out, act = sg_ops.apply_tiles(_t(f), _t(w), tiles, n_out=n,
                                  row_nz=sparsity.row_nonzero(_t(f)),
                                  epilogue=epi)
    plain = sg_ops.apply_tiles(_t(f), _t(w), tiles, n_out=n,
                               row_nz=sparsity.row_nonzero(_t(f)))
    want = torch.where(valid[:, None], (plain * 0.7 - 0.1).clamp(min=0), 0.0)
    _close(out, want.numpy())
    padded = torch.nn.functional.pad(out, (0, 56))
    _eq(act.blk_nz, (padded.reshape(n, 2, 128) != 0).any(-1).numpy())
    _eq(act.row_nz, (out != 0).any(-1).numpy())
    assert act.block_liveness(256, 128).shape == (n, 2)


def test_tap_counts_and_schedule_bit_identical():
    from repro.core import rulebook as jrulebook
    from repro_torch.core import rulebook
    kmap = _kmap(17)
    kmap[:, 5] = -1                      # an empty tap ties with others
    counts = rulebook.tap_counts(_t(kmap))
    _eq(counts, jrulebook.tap_counts(jnp.asarray(kmap)).astype(np.int32))
    _eq(rulebook.tap_schedule(counts),
        jrulebook.tap_schedule(jnp.asarray(counts.numpy())))


def _runs(lengths, live_share, seed):
    """tile_ob / tile_nz of output blocks whose runs have ``lengths`` tiles,
    each tile live with probability ``live_share``."""
    rng = np.random.default_rng(seed)
    ob = np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)
    nz = (rng.random(ob.size) < live_share).astype(np.int32)
    return _t(ob), _t(nz)


def _check_plan(tile_ob, tile_nz, n_blocks, n_ctas, max_splits, busy_min):
    """The plan's contract: every block gets consecutive CTAs, at least one
    and at most ``max_splits``; left-over CTAs get block -1; the tile
    ranges of a block's CTAs are in order, lie in the block's run, and hold
    each of its live tiles exactly once."""
    from repro_torch.kernels.spconv_gemm.kernel import split_plan_ref
    work, blk = split_plan_ref(tile_ob, tile_nz, n_blocks=n_blocks,
                               n_ctas=n_ctas, max_splits=max_splits,
                               busy_min=busy_min)
    assert work.dtype == blk.dtype == torch.int32
    assert work.shape == (n_ctas, 4) and blk.shape == (n_blocks, 2)
    ob, nz = tile_ob.numpy(), tile_nz.numpy()
    w, bl = work.numpy(), blk.numpy()
    assert (bl[:, 1] >= 1).all() and (bl[:, 1] <= max_splits).all()
    assert np.array_equal(bl[:, 0], np.cumsum(bl[:, 1]) - bl[:, 1])
    used = int(bl[:, 1].sum())
    assert used <= n_ctas
    assert (w[used:] == [-1, 0, 0, 0]).all()
    owner = np.full(ob.size, -1)
    for b in range(n_blocks):
        first, n = bl[b]
        rows = w[first:first + n]
        assert (rows[:, 0] == b).all() and (rows[:, 3] == n).all()
        assert (rows[:, 1] <= rows[:, 2]).all()
        assert (rows[1:, 1] >= rows[:-1, 2]).all()          # in order
        for lo, hi in rows[:, 1:3]:
            assert (ob[lo:hi] == b).all()
            assert (owner[lo:hi] == -1).all()
            owner[lo:hi] = b
    live = nz != 0
    assert np.array_equal(owner[live], ob[live])
    return w, bl


@pytest.mark.parametrize("max_splits", [1, 2, 3, 8, 64])
@pytest.mark.parametrize("live_share", [0.0, 0.3, 1.0])
def test_split_plan_partitions_every_run(max_splits, live_share):
    """The fused kernel's work plan (plain version): the ranges partition
    the live tiles of every run exactly, with empty output blocks, runs
    shorter than ``max_splits`` and all-dead runs."""
    from repro_torch.kernels.spconv_gemm.kernel import plan_shape
    lengths = np.random.default_rng(max_splits).integers(1, 40, 30)
    lengths[[0, 7, 8]] = 1                          # all-pad blocks
    lengths[3] = 2
    tile_ob, tile_nz = _runs(lengths, live_share, seed=max_splits)
    n_ctas, busy_min = plan_shape(30, 1, 132, max_splits)
    _, bl = _check_plan(tile_ob, tile_nz, 30, n_ctas, max_splits, busy_min)
    if max_splits == 1 or live_share == 0.0:
        assert (bl[:, 1] == 1).all()


def test_split_plan_splits_only_few_live_blocks():
    """A deep layer: 128 blocks, a dozen live with long runs and a long
    all-pad tail on the last block. The live blocks get several CTAs each,
    in proportion to their live tiles, and the tail none of its tiles;
    with most blocks live (res 0) every block keeps one CTA."""
    from repro_torch.kernels.spconv_gemm.kernel import plan_shape
    lengths = np.ones(128, np.int64)
    lengths[:12] = 30
    lengths[5] = 60
    lengths[-1] = 5000
    ob = np.repeat(np.arange(128), lengths).astype(np.int32)
    nz = np.zeros(ob.size, np.int32)
    nz[ob < 12] = 1
    n_ctas, busy_min = plan_shape(128, 4, 132, 8)
    assert (n_ctas, busy_min) == (128 + 66, 29)
    w, bl = _check_plan(_t(ob), _t(nz), 128, n_ctas, 8, busy_min)
    assert (bl[:12, 1] > 1).all() and bl[5, 1] >= bl[4, 1]
    assert (bl[12:, 1] == 1).all()
    assert (w[w[:, 0] == 127][:, 1:3] == w[w[:, 0] == 127][0, 1]).all()
    nz[:] = 1
    _, bl = _check_plan(_t(ob), _t(nz), 128, n_ctas, 8, busy_min)
    assert (bl[:, 1] == 1).all()


@pytest.mark.parametrize("n_blocks,n_slabs,max_splits,want", [
    (128, 1, 8, (128 + 264, 116)),
    (128, 4, 8, (128 + 66, 29)),
    (3, 2, 64, (3 + 132, 58)),
    (128, 1, 1, (128, 0)),
    (0, 1, 8, (0, 0))])
def test_plan_shape(n_blocks, n_slabs, max_splits, want):
    from repro_torch.kernels.spconv_gemm.kernel import plan_shape
    assert plan_shape(n_blocks, n_slabs, 132, max_splits) == want
