"""The paper's models, search baselines and cache tiers in the port,
against the JAX package on the same numpy inputs.

* PNELUT: the LUT, its depths and the 8 query cycles equal to the
  reference's, every entry's neighbour in the bank it is filed under;
  ``deinterleave3`` inverts ``interleave3`` exhaustively at 1-6 bits.
* ``cyclemodel`` and ``caching`` (the port's own copies of numpy code):
  every function over a grid of inputs, with exact float equality.
* The search baselines, bit-equal to the reference's on random clouds,
  duplicates, cross-block neighbours, batch isolation, out-of-grid
  queries and an all-invalid cloud: ``build_kmap_bruteforce``, the dense
  table (``build_block_table``, ``build_kmap_octree`` and
  ``build_kmap(impl="dense")`` against the reference's ``impl="xla"``)
  and ``build_kmap_sorted``. On duplicates the dense table and the hash
  keep the last row, the sorted search and kernel 1 the first, in both
  packages.
* ``subm3_plan(method="sorted")`` and ``search_impl="dense"`` (plans,
  search counts, the ValueError at ``grid_bits=7``), MinkUNet's and
  SECOND's ``map_method="sorted"``.
* ``plan_tier_bytes`` / ``ConvPlan.residency`` equal to the reference's,
  but for the reference plan's ``overflow`` field, which the port's plan
  does not carry (it raises instead): one bool byte in the cached tier of
  an octree Subm3 plan.
* ``make_sparse_tensor`` under each ``REPRO_GUARD_VALIDATE`` policy on the
  degenerate clouds of ``tests/test_robustness.py``.
* The five claim bands of ``tests/test_paper_bands.py`` through the
  port's modules.
* ``build_plans(replan=)``: ``run_spconv_demo(max_blocks=4)`` replans in
  both packages with equal search and ``replan.*`` counts, each reaching
  its own default run's digest (the two packages draw their seeded
  weights differently, so their digests differ from each other), and
  ``replan=False`` raises.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import caching as jcaching, cyclemodel as jcyclemodel
from repro.core import mapsearch as jmapsearch, morton as jmorton
from repro.core import plan as jplan, spconv as jspconv, validate as jvalidate
from repro.kernels.octent import ops as joct_ops
from repro.launch import train as jtrain
from repro.models import minkunet as jminkunet
from repro.runtime import feature_cache as jfeature_cache, guard as jguard
from repro_torch.core import caching, cyclemodel, mapsearch, morton
from repro_torch.core import plan as planlib, rulebook, spconv, validate
from repro_torch.data import pointcloud
from repro_torch.kernels.octent import ops as oct_ops
from repro_torch.launch import train
from repro_torch.models import minkunet, second
from repro_torch.runtime import feature_cache, guard
from tests.proptest import DEGENERATE_KINDS, degenerate_cloud, random_cloud
from tests.test_paper_bands import _lidar_tap_counts as _ref_tap_counts

OFFS = morton.subm3_offsets()


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _eq(port, ref):
    """Bit-identity of int32 or bool arrays."""
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, (p.dtype, r.dtype,
                                                       p.shape, r.shape)
    assert np.array_equal(p, r)


# ---------------------------------------------------------------------------
# PNELUT and Morton decoding
# ---------------------------------------------------------------------------

def test_pnelut_structure_and_codes():
    lut, depth, max_rot = morton.build_pnelut()
    jlut, jdepth, jmax_rot = jmorton.build_pnelut()
    _eq(lut, jlut)
    _eq(depth, jdepth)
    assert max_rot == jmax_rot == 8
    assert morton.pnelut_query_cycles() == jmorton.pnelut_query_cycles() == 8
    assert (depth.sum(axis=1) == 27).all()
    for p1 in range(8):
        # each of the 27 offsets filed exactly once per center ...
        assert sorted(lut[p1][lut[p1] >= 0].tolist()) == list(range(27))
        # ... under the bank (phi_1) its neighbour lands in
        center = torch.tensor([16 + (p1 & 1), 16 + ((p1 >> 1) & 1),
                               16 + ((p1 >> 2) & 1)], dtype=torch.int32)
        for bank in range(8):
            for oi in lut[p1, bank, :depth[p1, bank]]:
                code = morton.local_code(center + torch.as_tensor(OFFS[oi]))
                assert int(code) & 7 == bank


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6])
def test_deinterleave3_round_trip(bits):
    codes = torch.arange(8 ** bits, dtype=torch.int32)
    xyz = morton.deinterleave3(codes, bits)
    _eq(xyz, jmorton.deinterleave3(jnp.asarray(codes.numpy()), bits))
    _eq(morton.interleave3(xyz, bits), codes.numpy())
    # every coordinate of the cube exactly once
    assert torch.unique(xyz, dim=0).shape[0] == 8 ** bits
    assert int(xyz.max()) == (1 << bits) - 1


# ---------------------------------------------------------------------------
# The numpy models: exact float equality
# ---------------------------------------------------------------------------

def test_cyclemodel_matches_reference():
    for name in ("FREQ_HZ", "PE_ROWS", "PE_COLS", "MACS_PER_CYCLE",
                 "E_MAC_PJ", "E_SRAM_PJ_PER_BYTE", "E_DRAM_PJ_PER_BIT",
                 "HASH_BUILD_CPV", "HASH_PROBE_CPQ"):
        assert getattr(cyclemodel, name) == getattr(jcyclemodel, name), name
    for n, k, probe in itertools.product((1, 4096, 16384, 45422), (27, 8),
                                         (2.5, 2.6, 3.0, 3.4, 6.0)):
        got = cyclemodel.search_cycles(n, k, probe)
        want = jcyclemodel.search_cycles(n, k, probe)
        for f in ("hash_serial", "octent_serial", "octent_parallel",
                  "serial_algo_saving", "parallel_arch_saving",
                  "total_speedup"):
            assert getattr(got, f) == getattr(want, f), (n, k, probe, f)
    for maps, cin, cout, vs in itertools.product(
            (1, 5000, 123457), (4, 16, 48, 96, 128), (16, 32, 96, 128),
            (0.0, 0.3, 0.45, 0.6, 0.8, 1.0)):
        for grain in (16, 8):
            assert cyclemodel.compute_cycles(maps, cin, cout, vs, grain) \
                == jcyclemodel.compute_cycles(maps, cin, cout, vs, grain)
        assert cyclemodel.dense_compute_cycles(maps, cin, cout) \
            == jcyclemodel.dense_compute_cycles(maps, cin, cout)
        lat = cyclemodel.layer_latency(8192, maps, cin, cout, vs)
        jlat = jcyclemodel.layer_latency(8192, maps, cin, cout, vs)
        assert (lat.coarse, lat.fine, lat.fine_spac) \
            == (jlat.coarse, jlat.fine, jlat.fine_spac)
        assert lat.fps(25) == jlat.fps(25)
        for dram in (0.0, 1e6):
            assert cyclemodel.layer_energy_pj(maps, cin, cout, vs, dram) \
                == jcyclemodel.layer_energy_pj(maps, cin, cout, vs, dram)


def test_caching_matches_reference():
    for name in ("TAP_CENTER", "TAPS_DOWN", "TAPS_MID", "TAPS_UP",
                 "DDR_PJ_PER_BIT", "DDR_BYTES_PER_SEC"):
        assert getattr(caching, name) == getattr(jcaching, name), name
    assert [caching.tap_partition(t) for t in range(27)] \
        == [jcaching.tap_partition(t) for t in range(27)]
    rng = np.random.default_rng(0)
    tap_sets = [rng.integers(0, 5000, 27), np.zeros(27, np.int64),
                _ref_tap_counts(1024)]
    tap_sets[0][[2, 20]] = 0                      # inactive taps
    for counts, cin, cap, rows, db in itertools.product(
            tap_sets, (16, 48, 128), (0, 27 * 32 * 32, 1e9), (16, 128),
            (1, 4)):
        for policy in ("uniform", "nonuniform"):
            kw = dict(capacity_bytes=cap, tile_rows=rows, policy=policy,
                      dtype_bytes=db)
            assert tuple(caching.weight_traffic(counts, cin, cin, **kw)) \
                == tuple(jcaching.weight_traffic(counts, cin, cin, **kw))
        assert caching.saving(counts, cin, cin, cap, tile_rows=rows) \
            == jcaching.saving(counts, cin, cin, cap, tile_rows=rows)
    for mod in (caching, jcaching):
        with pytest.raises(ValueError):
            mod.weight_traffic(tap_sets[0], 8, 8, capacity_bytes=1.0,
                               policy="lru")


# ---------------------------------------------------------------------------
# Search baselines
# ---------------------------------------------------------------------------

def _cloud(name):
    """(coords, batch, valid, grid_bits) of the named case; grid_bits 5
    (a 512-voxel grid) lets the sorted key fit int32."""
    rng = np.random.default_rng(11)
    if name == "random":
        return (*random_cloud(rng, 64, 40, batch=3, n_valid=50), 5)
    if name == "duplicates":
        c, b, v = random_cloud(rng, 64, 8, batch=2, n_valid=48)
        c[48:], b[48:], v[48:] = c[:16], b[:16], True
        return c, b, v, 5
    if name == "cross_block":
        c = np.array([[15, 8, 8], [16, 8, 8], [15, 15, 15], [16, 16, 16],
                      [31, 31, 31], [32, 32, 32], [0, 0, 0], [0, 0, 0]],
                     np.int32)
        return c, np.zeros(8, np.int32), np.arange(8) < 6, 5
    if name == "batch_isolation":
        c = np.array([[5, 5, 5], [6, 5, 5], [5, 5, 5], [6, 5, 5]], np.int32)
        return c, np.array([0, 1, 1, 0], np.int32), np.ones(4, bool), 5
    if name == "out_of_grid":
        # grid_bits 2: a 64-voxel grid; voxels on both faces of it
        c, b, v = random_cloud(rng, 48, 6, batch=2, origin=58)
        c[:16] -= 58
        return c, b, v, 2
    if name == "all_invalid":
        c, b, _ = random_cloud(rng, 16, 8)
        return c, b, np.zeros(16, bool), 5
    raise ValueError(name)


CLOUDS = ["random", "duplicates", "cross_block", "batch_isolation",
          "out_of_grid", "all_invalid"]


@pytest.mark.parametrize("name", CLOUDS)
def test_search_baselines_bit_equal(name):
    c, b, v, gb = _cloud(name)
    n = c.shape[0]
    brute = mapsearch.build_kmap_bruteforce(c, b, v, OFFS)
    _eq(brute, jmapsearch.build_kmap_bruteforce(c, b, v, OFFS))
    hash_ = mapsearch.build_kmap_hash(c, b, v, OFFS)

    bt = mapsearch.build_block_table(_t(c), _t(b), _t(v), max_blocks=n,
                                     grid_bits=gb)
    jbt = jmapsearch.build_block_table(*_j(c, b, v), max_blocks=n,
                                       grid_bits=gb)
    for f in bt._fields:
        _eq(getattr(bt, f), getattr(jbt, f))
    dense = mapsearch.build_kmap_octree(_t(c), _t(b), _t(v), _t(OFFS),
                                        max_blocks=n, grid_bits=gb)
    _eq(dense, jmapsearch.build_kmap_octree(*_j(c, b, v, OFFS), max_blocks=n,
                                            grid_bits=gb))
    _eq(dense, hash_)
    kmap, n_blocks = oct_ops.build_kmap(_t(c), _t(b), _t(v), max_blocks=n,
                                        grid_bits=gb, impl="dense")
    jkmap, jn_blocks = joct_ops.build_kmap(*_j(c, b, v), max_blocks=n,
                                           grid_bits=gb, impl="xla")
    _eq(kmap, jkmap)
    assert int(n_blocks) == int(jn_blocks)

    sorted_ = mapsearch.build_kmap_sorted(_t(c), _t(b), _t(v), _t(OFFS),
                                          grid_bits=gb)
    _eq(sorted_, jmapsearch.build_kmap_sorted(*_j(c, b, v, OFFS),
                                              grid_bits=gb))
    _eq(sorted_, brute)
    kernel, _ = oct_ops.build_kmap(_t(c), _t(b), _t(v), max_blocks=n,
                                   grid_bits=gb)
    _eq(kernel, sorted_)
    if name == "duplicates":
        # rows 48.. repeat rows 0..15: first and last writers differ
        center = dense.numpy()[:16, 13]
        assert np.array_equal(center, np.arange(48, 64))
        assert np.array_equal(sorted_.numpy()[48:, 13], np.arange(16))
    else:
        _eq(sorted_, hash_)
    if name == "all_invalid":
        assert (dense.numpy() == -1).all() and int(n_blocks) == 0


def test_sorted_search_refuses_a_key_past_int32():
    assert mapsearch.sorted_key_fits(5, 4) == jmapsearch.sorted_key_fits(5, 4)
    for gb, bb in itertools.product(range(3, 9), range(1, 6)):
        assert mapsearch.sorted_key_fits(gb, bb) \
            == jmapsearch.sorted_key_fits(gb, bb)
    c, b, v, _ = _cloud("random")
    with pytest.raises(ValueError, match="int32"):
        mapsearch.build_kmap_sorted(_t(c), _t(b), _t(v), _t(OFFS),
                                    grid_bits=7)


def test_dense_table_overflow_and_prebuilt_table():
    c, b, v, _ = _cloud("random")
    _, n_blocks = oct_ops.build_kmap(_t(c), _t(b), _t(v), max_blocks=2,
                                     impl="dense")
    _, jn_blocks = joct_ops.build_kmap(*_j(c, b, v), max_blocks=2,
                                       impl="xla")
    assert int(n_blocks) == int(jn_blocks) > 2
    qt = oct_ops.build_query_table(_t(c), _t(b), _t(v), max_blocks=64)
    with pytest.raises(ValueError, match="dense"):
        oct_ops.build_kmap(_t(c), _t(b), _t(v), max_blocks=64, impl="dense",
                           table=qt)
    assert guard.fallback_chain("search", "dense", torch.device("cpu")) \
        == ("ref",)
    assert guard.fallback_chain("search", "dense", torch.device("cuda")) \
        == ()


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

def test_subm3_plan_sorted_and_dense():
    c, b, v, _ = _cloud("random")
    n = c.shape[0]
    cache = planlib.PlanCache()
    planlib.reset_mapsearch_counter()
    jplan.reset_mapsearch_counter()
    got = planlib.subm3_plan(_t(c), _t(b), _t(v), max_blocks=n,
                             method="sorted", grid_bits=5, bm=16,
                             cache=cache)
    want = jplan.subm3_plan(*_j(c, b, v), max_blocks=n, method="sorted",
                            grid_bits=5, bm=16)
    _eq(got.kmap, want.kmap)
    for f in got.tiles._fields[:-1]:
        _eq(getattr(got.tiles, f), getattr(want.tiles, f))
    octree = planlib.subm3_plan(_t(c), _t(b), _t(v), max_blocks=n,
                                grid_bits=5, bm=16, cache=cache)
    dense = planlib.subm3_plan(_t(c), _t(b), _t(v), max_blocks=n,
                               search_impl="dense", grid_bits=5, bm=16,
                               cache=cache)
    # three methods, three cache entries, one search each, equal kmaps
    assert len(cache) == 3 and octree is not got and dense is not octree
    _eq(octree.kmap, got.kmap.numpy())
    _eq(dense.kmap, got.kmap.numpy())
    assert planlib.mapsearch_call_count() == 3
    assert jplan.mapsearch_call_count() == 1
    # a dense build pins no table
    assert cache.pinned.stats()["entries"] == 1
    for mod, args in ((planlib, (_t(c), _t(b), _t(v))), (jplan, _j(c, b, v))):
        with pytest.raises(ValueError, match="fit int32"):
            mod.subm3_plan(*args, max_blocks=n, method="sorted", grid_bits=7)
    # the refused build still counts its search, as the reference's does
    assert planlib.mapsearch_call_count() == 4
    assert jplan.mapsearch_call_count() == 2
    with pytest.raises(ValueError, match="unknown map search method"):
        planlib.subm3_plan(_t(c), _t(b), _t(v), max_blocks=n, method="hash")


def test_plan_tier_bytes_match_reference():
    c, b, v, _ = _cloud("random")
    n = c.shape[0]
    for name in ("ublocks", "tkey", "tval", "n_blocks", "tile_tap",
                 "tile_nz", "tile_ob", "tile_first", "tile_run", "grp_skip",
                 "grp_contig", "kmap", "gather_idx", "scatter_idx",
                 "slot_valid", "in_idx", "feats", "weights", "bias"):
        assert feature_cache.classify(name) == jfeature_cache.classify(name)
    assert (feature_cache.TIER_PINNED, feature_cache.TIER_CACHED,
            feature_cache.TIER_STREAM) == (jfeature_cache.TIER_PINNED,
                                           jfeature_cache.TIER_CACHED,
                                           jfeature_cache.TIER_STREAM)
    subm = planlib.subm3_plan(_t(c), _t(b), _t(v), max_blocks=n, bm=16)
    jsubm = jplan.subm3_plan(*_j(c, b, v), max_blocks=n, bm=16)
    qt = oct_ops.build_query_table(_t(c), _t(b), _t(v), max_blocks=n)
    jqt = joct_ops.build_query_table(*_j(c, b, v), max_blocks=n)
    # the reference's plan carries ``overflow``, a () bool the port's plan
    # does not have (its build raises instead): one cached byte
    assert "overflow" not in planlib.ConvPlan._fields
    assert jsubm.overflow is not None and jsubm.overflow.dtype == bool
    want = jsubm.residency
    want["cached"] -= 1
    assert subm.residency == want
    got_t = feature_cache.plan_tier_bytes(subm, qt)
    want_t = jfeature_cache.plan_tier_bytes(jsubm, jqt)
    want_t["cached"] -= 1
    assert got_t == want_t and got_t["pinned"] > subm.residency["pinned"]
    down = planlib.gconv2_plan(_t(c), _t(b), _t(v), bm=16)
    jdown = jplan.gconv2_plan(*_j(c, b, v), bm=16)
    assert jdown.overflow is None
    assert down.residency == jdown.residency
    assert down.residency["stream"] == 0
    sorted_ = planlib.subm3_plan(_t(c), _t(b), _t(v), max_blocks=n, bm=16,
                                 method="sorted", grid_bits=5)
    jsorted = jplan.subm3_plan(*_j(c, b, v), max_blocks=n, bm=16,
                               method="sorted", grid_bits=5)
    assert jsorted.overflow is None
    assert sorted_.residency == jsorted.residency


# ---------------------------------------------------------------------------
# make_sparse_tensor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["repair", "strict", "off"])
def test_make_sparse_tensor_policies(policy, monkeypatch):
    """The degenerate clouds of ``test_degenerate_clouds_end_to_end``
    through both constructors under one ``REPRO_GUARD_VALIDATE``: the same
    rows survive, the same report, the same rejection, and (where the
    cloud is admitted) a Subm3 plan equal to the reference's."""
    monkeypatch.setenv("REPRO_GUARD_VALIDATE", policy)
    n = 16
    for kind in DEGENERATE_KINDS:
        rng = np.random.default_rng(3)
        coords, batch, valid = degenerate_cloud(kind, rng, n=n)
        feats = rng.standard_normal((n, 3)).astype(np.float32)
        try:
            jst, jrep = jspconv.make_sparse_tensor(coords, batch, valid,
                                                   feats)
        except jvalidate.CloudValidationError as e:
            with pytest.raises(validate.CloudValidationError) as ei:
                spconv.make_sparse_tensor(coords, batch, valid, feats)
            assert ei.value.kind == e.kind, kind
            continue
        st, rep = spconv.make_sparse_tensor(coords, batch, valid, feats)
        assert (rep is None) == (jrep is None) == (policy == "off"), kind
        if rep is not None:
            assert rep == tuple(jrep), kind
        for f in ("coords", "batch", "valid", "feats"):
            p, r = np.asarray(getattr(st, f)), np.asarray(getattr(jst, f))
            assert p.dtype == r.dtype and np.array_equal(p, r, equal_nan=True)
        if policy == "off" and kind == "nan_coords":
            continue                   # unsanitized float coords: no plan
        plan = planlib.subm3_plan(_t(st.coords), _t(st.batch), _t(st.valid),
                                  max_blocks=n, search_impl="ref")
        jp = jplan.subm3_plan(*_j(jst.coords, jst.batch, jst.valid),
                              max_blocks=n)
        _eq(plan.kmap, jp.kmap)


def test_make_sparse_tensor_passes_a_clean_cloud_through():
    c, b, v = (_t(a) for a in random_cloud(np.random.default_rng(4), 32, 9))
    f = torch.zeros((32, 3))
    st, rep = spconv.make_sparse_tensor(c, b, v, f,
                                        policy=validate.STRICT)
    assert rep.ok
    assert st.coords is c and st.batch is b and st.valid is v \
        and st.feats is f


# ---------------------------------------------------------------------------
# Models with map_method="sorted"
# ---------------------------------------------------------------------------

def _indoor(rows):
    vb = pointcloud.make_batch(np.random.default_rng(21), "indoor", 1, rows)
    return vb.coords, vb.batch, vb.valid, vb.feats


def test_minkunet_sorted_method_matches_octree_and_reference():
    cfg = dataclasses.replace(train.DEMO_CFG, grid_bits=5, bm=32)
    jcfg = jminkunet.MinkUNetConfig(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    c, b, v, f = _indoor(509)
    scfg = dataclasses.replace(cfg, map_method="sorted")
    plans = minkunet.build_plans(c, b, v, scfg, device="cpu")
    oplans = minkunet.build_plans(c, b, v, cfg, device="cpu")
    jplans = jminkunet.build_plans(
        *_j(c, b, v), dataclasses.replace(jcfg, map_method="sorted"))
    for p, o, jp in zip(plans.subm, oplans.subm, jplans.subm):
        _eq(p.kmap, jp.kmap)
        _eq(o.kmap, jp.kmap)
    model = minkunet.MinkUNet(scfg, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    st = spconv.SparseTensor(_t(c), _t(b), _t(v), _t(f))
    got = minkunet.forward(model, st, plans=plans)
    want = minkunet.forward(model, st, plans=oplans)
    assert torch.equal(got, want) and torch.isfinite(got).all()
    # LARGE's 7-bit grid does not fit the sorted key in either package
    big = dataclasses.replace(scfg, grid_bits=7)
    with pytest.raises(ValueError, match="fit int32"):
        minkunet.build_plans(c, b, v, big, device="cpu")
    with pytest.raises(ValueError, match="fit int32"):
        jminkunet.build_plans(*_j(c, b, v),
                              dataclasses.replace(jcfg, map_method="sorted",
                                                  grid_bits=7))


def test_second_sorted_method_matches_octree():
    kw = dict(channels=(8, 8, 16), blocks=2, bev_hw=32, bev_z=4,
              head_ch=16, n_batch=2, grid_bits=5)
    vb = pointcloud.make_batch(np.random.default_rng(0), "lidar", 2, 1003,
                               voxel_size=0.15)
    st = spconv.SparseTensor(*(_t(a) for a in (vb.coords, vb.batch,
                                               vb.valid, vb.feats)))
    outs = []
    for method in ("octree", "sorted"):
        model = second.SECOND(second.SECONDConfig(map_method=method, **kw),
                              device="cpu")
        outs.append(second.forward(model, st))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The paper's claim bands through the port's modules
# ---------------------------------------------------------------------------

def _lidar_tap_counts(n=4096):
    vb = pointcloud.make_batch(np.random.default_rng(0), "lidar", 1, n)
    kmap = mapsearch.build_kmap_octree(_t(vb.coords), _t(vb.batch),
                                       _t(vb.valid), _t(OFFS), max_blocks=n)
    counts = rulebook.tap_counts(kmap).numpy()
    assert np.array_equal(counts, _ref_tap_counts(n))
    return counts


def test_band_fig9a_search_speedup():
    for n, probe in ((8192, 2.6), (16384, 6.0)):
        lat = cyclemodel.search_cycles(n, probe_factor=probe)
        assert 7.5 <= lat.total_speedup <= 22.5
        assert 0.60 <= lat.serial_algo_saving <= 0.90
        assert 0.66 <= lat.parallel_arch_saving <= 0.69


def test_band_fig9b_spac_saving():
    savings = [1 - cyclemodel.compute_cycles(10000, c, c, vs)
               / cyclemodel.dense_compute_cycles(10000, c, c)
               for vs in (0.45, 0.6, 0.8) for c in (48, 96, 128)]
    assert 0.30 <= min(savings) and max(savings) <= 0.80
    assert any(0.44 <= s <= 0.80 for s in savings)


def test_band_fig8a_lidar_vertical_skew():
    counts = _lidar_tap_counts()
    parts = {"center": 0, "mid": 0, "up": 0, "down": 0}
    for t, c in enumerate(counts):
        parts[caching.tap_partition(t)] += int(c)
    assert (parts["center"] + parts["mid"]) / max(counts.sum(), 1) >= 0.45
    assert parts["up"] == parts["down"]


def test_band_fig9c_caching_saving():
    counts = _lidar_tap_counts()
    cap = 27 * 32 * 32
    s48, s96, s128 = (caching.saving(counts, c, c, cap)
                      for c in (48, 96, 128))
    assert s48 >= 0.70 and s48 >= s96 >= s128 >= 0.10
    assert caching.saving(counts, 16, 16, cap) == 0.0


def test_band_fig10_overall_speedup():
    n, n_maps = 8192, 8192 * 14
    ours = base = 0.0
    for c_in, c_out in [(16, 32), (32, 64), (64, 64)]:
        ours += cyclemodel.layer_latency(n, n_maps, c_in, c_out,
                                         0.5).fine_spac
        base += (cyclemodel.search_cycles(n).hash_serial
                 + cyclemodel.dense_compute_cycles(n_maps, c_in, c_out))
    assert 1.1 <= base / ours <= 8.0


# ---------------------------------------------------------------------------
# build_plans(replan=)
# ---------------------------------------------------------------------------

#: the demo's row budget here, used by no other test (the capacity memo is
#: process-wide in both packages; each run is scoped besides)
REPLAN_VOXELS = 136


def _demo(mod, **kw):
    scope = guard.scoped_health() if mod is train else jguard.scoped_health()
    with scope:
        extra = {"device": "cpu"} if mod is train else {}
        return mod.run_spconv_demo(2, voxels=REPLAN_VOXELS, **extra, **kw)


def test_build_plans_replans_like_the_reference():
    clean, tight = _demo(train), _demo(train, max_blocks=4)
    jclean, jtight = _demo(jtrain), _demo(jtrain, max_blocks=4)
    assert tight["state_digest"] == clean["state_digest"]
    assert jtight["state_digest"] == jclean["state_digest"]
    assert tight["mapsearch_calls"] == jtight["mapsearch_calls"] \
        == clean["mapsearch_calls"] + 1
    replan = {k: v for k, v in tight["health"].items()
              if k.startswith("replan.")}
    assert replan == {k: v for k, v in jtight["health"].items()
                      if k.startswith("replan.")}
    assert replan["replan.overflow"] > 0 and replan["replan.recovered"] > 0
    assert tight["losses"] == clean["losses"]


def test_build_plans_without_replan_raises():
    c, b, v, _ = _indoor(REPLAN_VOXELS + 2)
    with guard.scoped_health() as h:
        with pytest.raises(planlib.CapacityOverflow):
            minkunet.build_plans(c, b, v, train.DEMO_CFG, n_max=4,
                                 replan=False, device="cpu")
        assert "replan.overflow" not in h.snapshot()
        with pytest.raises(planlib.CapacityOverflow):
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("REPRO_GUARD_REPLAN", "0")
                minkunet.build_plans(c, b, v, train.DEMO_CFG, n_max=4,
                                     device="cpu")
        plans = minkunet.build_plans(c, b, v, train.DEMO_CFG, n_max=4,
                                     device="cpu")
        assert h.get("replan.recovered") > 0
    want = minkunet.build_plans(c, b, v, train.DEMO_CFG, device="cpu")
    for p, w in zip(plans.subm, want.subm):
        assert torch.equal(p.kmap, w.kmap)
