"""Parity of the port's materialized SpConv path (repro_torch) against the
JAX package.

Bit for bit: ``build_tap_tiles`` with build-time row elision
(``row_nz``), all ten streams, over several (bm, bo) layouts;
``compact_kmap``, ``blocked_tap_counts``, ``act_from_feats`` and
``sparsity_stats``.
Within 1e-5 of the output's scale (the reference's own test tolerance;
float32 summation order only): ``spconv_gemm_ref`` and the kernel wrapper
(its plain version here) against the Pallas kernel in interpret mode and
the reference's plain version, and ``apply_kmap`` against the reference's
``apply_kmap`` (interpret mode and ``ref``), at Cin in {4, 32, 96} with
dead tiles present. ``apply_kmap_fused`` and ``apply_epilogue`` against
their reference counterparts; the epilogue's backward raises.

Bit-equal to explicit numpy float32 loops that add each destination row's
sources in ascending order from zero: ``segment.ordered_sum`` (rows of 0,
1, 2, 27 and more than ``segment.GUESS`` sources, dropped sources, a row
of negative zeros) and its backward (``g[dst]``), ``ordered_gather``'s
backward, and ``scatter_valid`` in ascending slot order.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import mapsearch as jmapsearch
from repro.core import rulebook as jrulebook
from repro.core import sparsity as jsparsity
from repro.kernels.spconv_gemm import ops as jsg_ops
from repro.kernels.spconv_gemm.kernel import spconv_gemm as jspconv_gemm
from repro.kernels.spconv_gemm.ref import spconv_gemm_ref as jspconv_gemm_ref
from repro_torch.core import morton, rulebook, segment, sparsity
from repro_torch.kernels.spconv_gemm import kernel as sg_kernel
from repro_torch.kernels.spconv_gemm import ops as sg_ops
from repro_torch.kernels.spconv_gemm.ref import spconv_gemm_ref
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
    p, r = port.detach().numpy(), np.asarray(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    scale = max(1.0, float(np.abs(r).max(initial=0.0)))
    assert float(np.abs(p - r).max(initial=0.0)) <= tol * scale


def _kmap(seed, n=72, extent=7):
    c, b, v = random_cloud(np.random.default_rng(seed), n, extent)
    return jmapsearch.build_kmap_hash(c, b, v, morton.subm3_offsets())


def _dead_rows_feats(rng, n, c_in, dead=0.4):
    """Mixed-sign features with a share of exactly-zero rows."""
    f = rng.standard_normal((n, c_in)).astype(np.float32)
    f[rng.random(n) < dead] = 0.0
    return f


LAYOUTS = [(32, None), (16, 32), (16, 48), (8, 16), (128, 128)]


@pytest.mark.parametrize("bm,bo", LAYOUTS)
def test_tap_tiles_row_nz_bit_identical(bm, bo):
    kmap = _kmap(bm + 1)
    row_nz = np.random.default_rng(bm).random(kmap.shape[0]) < 0.6
    tiles = sg_ops.build_tap_tiles(_t(kmap), _t(row_nz), bm=bm, bo=bo)
    jtiles = jsg_ops.build_tap_tiles(jnp.asarray(kmap), jnp.asarray(row_nz),
                                     bm=bm, bo=bo)
    assert tiles.bo == jtiles.bo and tiles.bm == jtiles.bm
    for name in jtiles._fields[:-1]:      # the ten streams
        _eq(getattr(tiles, name), getattr(jtiles, name))
    # elision really re-packed the layout
    base = sg_ops.build_tap_tiles(_t(kmap), bm=bm, bo=bo)
    assert int(tiles.slot_valid.sum()) < int(base.slot_valid.sum())


def test_tap_tiles_all_live_row_nz_equals_geometry_build():
    kmap = _kmap(2)
    live = torch.ones(kmap.shape[0], dtype=torch.bool)
    a = sg_ops.build_tap_tiles(_t(kmap), live, bm=16, bo=32)
    b = sg_ops.build_tap_tiles(_t(kmap), bm=16, bo=32)
    for x, y in zip(a[:-1], b[:-1]):
        assert torch.equal(x, y)


def test_compact_kmap_bit_identical():
    kmap = _kmap(3)
    row_nz = np.random.default_rng(3).random(kmap.shape[0]) < 0.5
    got = sparsity.compact_kmap(_t(kmap), _t(row_nz))
    _eq(got, jsparsity.compact_kmap(jnp.asarray(kmap), jnp.asarray(row_nz)))
    assert int((got >= 0).sum()) < int((kmap >= 0).sum())


@pytest.mark.parametrize("bo", [16, 48, 512])
def test_blocked_tap_counts_bit_identical(bo):
    kmap = _kmap(4)
    kmap[:, 7] = -1
    _eq(rulebook.blocked_tap_counts(_t(kmap), bo),
        jrulebook.blocked_tap_counts(jnp.asarray(kmap), bo))


@pytest.mark.parametrize("c", [20, 128, 300])
def test_act_from_feats_bit_identical(c):
    f = _dead_rows_feats(np.random.default_rng(c), 50, c)
    f[:, :c // 2][np.random.default_rng(1).random(50) < 0.5] = 0.0
    act = sparsity.act_from_feats(_t(f))
    jact = jsparsity.act_from_feats(jnp.asarray(f))
    _eq(act.row_nz, jact.row_nz)
    _eq(act.blk_nz, jact.blk_nz)
    assert act.blk == jact.blk


@pytest.mark.parametrize("empty", [False, True], ids=["cloud", "empty"])
def test_sparsity_stats_match(empty):
    kmap = _kmap(5)
    if empty:
        kmap[:] = -1
    f = _dead_rows_feats(np.random.default_rng(5), kmap.shape[0], 8)
    got = sparsity.sparsity_stats(_t(f), _t(kmap), c_out=16)
    want = jsparsity.sparsity_stats(jnp.asarray(f), jnp.asarray(kmap),
                                    c_out=16)
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6,
                                   err_msg=name)
    if empty:
        assert float(got.map_elision) == 0.0


def _gemm_inputs(c_in, c_out=128, bm=16, seed=0):
    """Materialized lhs with dead tiles: tiles built with row elision, the
    rows gathered, invalid slots zeroed, and every third live tile marked
    dead."""
    kmap = _kmap(seed + 20)
    rng = np.random.default_rng(seed)
    f = _dead_rows_feats(rng, kmap.shape[0], c_in)
    w = rng.standard_normal((27, c_in, c_out)).astype(np.float32)
    tiles = sg_ops.build_tap_tiles(_t(kmap), sparsity.row_nonzero(_t(f)),
                                   bm=bm)
    lhs = _t(f)[tiles.gather_idx.long()]
    lhs[~tiles.slot_valid] = 0.0
    nz = tiles.tile_nz.clone()
    nz[torch.nonzero(nz).squeeze(1)[::3]] = 0
    assert int((nz == 0).sum()) > 0 and int(nz.sum()) > 0
    return lhs, _t(w), tiles.tile_tap, nz


# (Cin, Cout_pad, bm): the first three at bm 16, then the edges the CUDA
# kernel handles apart: a tile shorter than a warp's 16 rows, a tile of two
# 128-row blocks, a Cin that is not a multiple of 4 (4-byte copies, a ragged
# last step) and three 128-column slabs. Every case marks live tiles dead.
GEMM_CASES = [pytest.param(4, 128, 16, id="4"),
              pytest.param(32, 128, 16, id="32"),
              pytest.param(96, 128, 16, id="96"),
              pytest.param(32, 128, 8, id="bm8"),
              pytest.param(16, 128, 256, id="bm256"),
              pytest.param(38, 128, 16, id="cin38"),
              pytest.param(24, 384, 16, id="cout384")]


@pytest.mark.parametrize("c_in,c_out,bm", GEMM_CASES)
def test_spconv_gemm_ref_matches_reference(c_in, c_out, bm):
    lhs, w, tap, nz = _gemm_inputs(c_in, c_out, bm=bm, seed=c_in)
    got = spconv_gemm_ref(lhs, w, tap, nz, bm=bm)
    args = (jnp.asarray(lhs.numpy()), jnp.asarray(w.numpy()),
            jnp.asarray(tap.numpy()), jnp.asarray(nz.numpy()))
    _close(got, jspconv_gemm_ref(*args, bm=bm))
    _close(got, jspconv_gemm(*args, bm=bm, interpret=True))
    # dead tiles are exact zeros, the killed live ones among them
    dead = (nz == 0).repeat_interleave(bm)
    assert not got[dead].any()


def test_spconv_gemm_wrapper_cpu_path():
    lhs, w, tap, nz = _gemm_inputs(32)
    before = sg_kernel.materialized_launches
    got = sg_kernel.spconv_gemm(lhs, w, tap, nz, bm=16)
    assert sg_kernel.materialized_launches == before   # no kernel on CPU
    assert torch.equal(got, spconv_gemm_ref(lhs, w, tap, nz, bm=16))


def test_spconv_gemm_wrapper_rejects_bad_inputs():
    lhs, w, tap, nz = _gemm_inputs(32)
    with pytest.raises(TypeError, match="lhs must be torch.float32"):
        sg_kernel.spconv_gemm(lhs.double(), w, tap, nz, bm=16)
    with pytest.raises(ValueError, match="multiple of 128"):
        sg_kernel.spconv_gemm(lhs, w[..., :100].contiguous(), tap, nz, bm=16)
    with pytest.raises(ValueError, match="multiple of bm"):
        sg_kernel.spconv_gemm(lhs[:-1], w, tap, nz, bm=16)
    with pytest.raises(TypeError, match="tile_nz must be torch.int32"):
        sg_kernel.spconv_gemm(lhs, w, tap, nz.long(), bm=16)
    with pytest.raises(ValueError, match="contiguous"):
        sg_kernel.spconv_gemm(lhs.t().contiguous().t(), w, tap, nz, bm=16)


@pytest.mark.parametrize("c_in,c_out", [(4, 24), (32, 130), (96, 64)])
def test_apply_kmap_matches_reference(c_in, c_out):
    kmap = _kmap(c_in)
    rng = np.random.default_rng(c_in + 1)
    f = _dead_rows_feats(rng, kmap.shape[0], c_in)
    w = rng.standard_normal((27, c_in, c_out)).astype(np.float32)
    bias = rng.standard_normal(c_out).astype(np.float32)
    got = sg_ops.apply_kmap(_t(f), _t(w), _t(kmap), _t(bias), bm=16, bo=32)
    jargs = (jnp.asarray(f), jnp.asarray(w), jnp.asarray(kmap),
             jnp.asarray(bias))
    for impl in ("interpret", "ref"):
        _close(got, jsg_ops.apply_kmap(*jargs, bm=16, bo=32, impl=impl))
    # the tap-scan oracle gives the same function
    _close(got, (rulebook.apply_kmap_gather(_t(f), _t(w), _t(kmap))
                 + _t(bias)).numpy())
    # dead tiles were present: elision dropped maps
    tiles = sg_ops.build_tap_tiles(_t(kmap), sparsity.row_nonzero(_t(f)),
                                   bm=16, bo=32)
    assert int((tiles.tile_nz == 0).sum()) > 0


def test_apply_kmap_spac_off_matches_reference():
    """The port always elides: the elision must be invisible against the
    reference run without it."""
    kmap = _kmap(9)
    rng = np.random.default_rng(9)
    f = _dead_rows_feats(rng, kmap.shape[0], 16)
    w = rng.standard_normal((27, 16, 40)).astype(np.float32)
    got = sg_ops.apply_kmap(_t(f), _t(w), _t(kmap), bm=32)
    want = jsg_ops.apply_kmap(jnp.asarray(f), jnp.asarray(w),
                              jnp.asarray(kmap), spac=False, bm=32,
                              impl="ref")
    _close(got, want)


def test_scatter_valid_drops_pad_and_dead_rows():
    """Only valid slots are scattered, as the reference's mode="drop"
    scatter keeps them: rows of pad slots and dead tiles are never read."""
    kmap = _kmap(13)
    rng = np.random.default_rng(13)
    f = _t(_dead_rows_feats(rng, kmap.shape[0], 8))
    tiles = sg_ops.build_tap_tiles(_t(kmap), sparsity.row_nonzero(f), bm=16,
                                   bo=32)
    ps = torch.from_numpy(rng.standard_normal(
        (tiles.gather_idx.shape[0], 24)).astype(np.float32))
    assert int((~tiles.slot_valid).sum()) > 0
    got = sg_ops.scatter_valid(ps.masked_fill(~tiles.slot_valid[:, None],
                                              float("nan")),
                               tiles, kmap.shape[0])
    want = jnp.zeros((kmap.shape[0], 24), jnp.float32).at[
        jnp.asarray(tiles.scatter_idx.numpy())].add(
            jnp.asarray(ps.numpy()) * jnp.asarray(
                tiles.slot_valid.numpy())[:, None], mode="drop")
    assert bool(torch.isfinite(got).all())
    _close(got, want)


@pytest.mark.parametrize("spac", [True, False])
def test_apply_kmap_fused_matches_reference(spac):
    kmap = _kmap(11)
    rng = np.random.default_rng(11)
    f = _dead_rows_feats(rng, kmap.shape[0], 64)
    w = rng.standard_normal((27, 64, 96)).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32)
    got = sg_ops.apply_kmap_fused(_t(f), _t(w), _t(kmap), _t(bias),
                                  spac=spac, bm=16, bo=32)
    want = jsg_ops.apply_kmap_fused(jnp.asarray(f), jnp.asarray(w),
                                    jnp.asarray(kmap), jnp.asarray(bias),
                                    spac=spac, bm=16, bo=32, impl="ref")
    _close(got, want)


@pytest.mark.parametrize("c_out", [24, 200])
def test_apply_epilogue_matches_reference(c_out):
    rng = np.random.default_rng(c_out)
    n = 40
    out = rng.standard_normal((n, c_out)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c_out).astype(np.float32)
    shift = rng.uniform(-0.5, 0.5, c_out).astype(np.float32)
    valid = rng.random(n) < 0.8
    y, act = sg_ops.apply_epilogue(_t(out), sg_ops.FusedEpilogue(
        _t(scale), _t(shift), _t(valid)))
    jy, jact = jsg_ops.apply_epilogue_xla(jnp.asarray(out), jsg_ops.
                                          FusedEpilogue(jnp.asarray(scale),
                                                        jnp.asarray(shift),
                                                        jnp.asarray(valid)))
    _close(y, jy, tol=1e-6)
    # liveness is exactly a sweep of the port's own output
    padded = torch.nn.functional.pad(y, (0, -c_out % 128))
    _eq(act.blk_nz, (padded.reshape(n, -1, 128) != 0).any(-1).numpy())
    _eq(act.row_nz, (y != 0).any(-1).numpy())
    assert act.blk == jact.blk == 128


def test_apply_epilogue_backward_raises():
    out = torch.randn(8, 16, requires_grad=True)
    epi = sg_ops.FusedEpilogue(torch.ones(16), torch.zeros(16),
                               torch.ones(8, dtype=torch.bool))
    y, _ = sg_ops.apply_epilogue(out, epi)
    with pytest.raises(NotImplementedError, match="inference-only"):
        y.sum().backward()
    # the reference raises the same way
    with pytest.raises(NotImplementedError, match="inference-only"):
        jax.grad(lambda o: jsg_ops.apply_epilogue_xla(
            o, jsg_ops.FusedEpilogue(jnp.ones(16), jnp.zeros(16),
                                     jnp.ones(8, bool)))[0].sum())(
            jnp.ones((8, 16)))


def _loop_sum(vals, dst, n_rows):
    """The sequential float32 loop: each row adds its sources in ascending
    source order, from zero; sources outside [0, n_rows) are dropped."""
    out = np.zeros((n_rows, *vals.shape[1:]), np.float32)
    for i, r in enumerate(dst):
        if 0 <= r < n_rows:
            out[r] += vals[i]
    return out


def _segment_case(counts, seed, c=5, dropped=7):
    """Values and shuffled destinations giving row r ``counts[r]`` sources,
    plus ``dropped`` sources outside the rows; values spread over orders
    of magnitude so that the order of a sum shows in its bits."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.repeat(np.arange(len(counts)), counts),
                          rng.choice([-1, len(counts), len(counts) + 3],
                                     dropped)])
    rng.shuffle(dst)
    vals = (rng.standard_normal((dst.size, c))
            * 10.0 ** rng.integers(-4, 5, (dst.size, 1))).astype(np.float32)
    return vals, dst


SEGMENT_COUNTS = {
    "mixed": [0, 1, 2, 27, 0, 3, 1, 27, 2, 0],
    "wide": [0, 40, 1, 2, 0, 27, 33],        # a second host read
    "empty": [0, 0, 0],
}


@pytest.mark.parametrize("case", sorted(SEGMENT_COUNTS))
def test_ordered_sum_bit_equal_to_the_ascending_loop(case):
    counts = SEGMENT_COUNTS[case]
    vals, dst = _segment_case(counts, len(case))
    if case == "mixed":
        vals[dst == 4] = -0.0                # a row of negative zeros
        dst[dst == 4] = 5
    seg = segment.segments((_t(dst), len(counts)))[0]
    keep = (dst >= 0) & (dst < len(counts))
    per_row = np.bincount(dst[keep], minlength=len(counts))
    # column j: the rows with more than j sources
    assert seg.cols == tuple(int((per_row > j).sum())
                             for j in range(per_row.max(initial=0)))
    v = _t(vals).requires_grad_()
    got = segment.ordered_sum(v, seg)
    want = _loop_sum(vals, dst, len(counts))
    assert got.dtype == torch.float32
    assert np.array_equal(got.detach().numpy().view(np.int32),
                          want.view(np.int32))
    # the backward is the gather g[dst], zero for a dropped source
    g = np.random.default_rng(3).standard_normal(want.shape).astype(
        np.float32)
    got.backward(_t(g))
    gw = np.where(keep[:, None], g[np.where(keep, dst, 0)], 0.0)
    assert np.array_equal(v.grad.numpy(), gw.astype(np.float32))


def test_ordered_gather_backward_bit_equal_to_the_ascending_loop():
    rng = np.random.default_rng(4)
    idx = np.concatenate([np.repeat(np.arange(6), [3, 0, 27, 1, 2, 40]),
                          rng.integers(0, 6, 11)])
    rng.shuffle(idx)
    f = _t(rng.standard_normal((6, 3)).astype(np.float32)).requires_grad_()
    seg = segment.segments((_t(idx), 6))[0]
    rows = segment.ordered_gather(f, _t(idx), seg)
    assert torch.equal(rows, f[_t(idx)])
    g = (rng.standard_normal(rows.shape)
         * 10.0 ** rng.integers(-4, 5, (rows.shape[0], 1))).astype(
             np.float32)
    rows.backward(_t(g))
    assert np.array_equal(f.grad.numpy().view(np.int32),
                          _loop_sum(g, idx, 6).view(np.int32))


def test_scatter_valid_bit_equal_to_the_slot_order_loop():
    """Every output row adds its valid slots in ascending slot order."""
    rng = np.random.default_rng(17)
    c, b, v = random_cloud(rng, 200, 6, n_valid=180)   # pad rows: no slot
    kmap = jmapsearch.build_kmap_hash(c, b, v, morton.subm3_offsets())
    f = _t(_dead_rows_feats(rng, kmap.shape[0], 8, dead=0.2))
    tiles = sg_ops.build_tap_tiles(_t(kmap), sparsity.row_nonzero(f), bm=16,
                                   bo=32)
    m = tiles.gather_idx.shape[0]
    ps = (rng.standard_normal((m, 24))
          * 10.0 ** rng.integers(-4, 5, (m, 1))).astype(np.float32)
    valid = tiles.slot_valid.numpy()
    dst = np.where(valid, tiles.scatter_idx.numpy(), -1)
    n_out = kmap.shape[0]
    per_row = np.bincount(dst[valid], minlength=n_out)
    assert per_row.max() >= 20 and (per_row == 0).any()
    got = sg_ops.scatter_valid(_t(ps), tiles, n_out)
    assert np.array_equal(got.numpy().view(np.int32),
                          _loop_sum(ps, dst, n_out).view(np.int32))
