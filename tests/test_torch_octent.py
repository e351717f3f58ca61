"""Parity of the port's map search (repro_torch) against the JAX package.

Integer outputs must match bit for bit: Morton codes, the unique passes,
the QueryTable, Subm3 kmaps (against the plain reference query and once
against the Pallas kernel in interpret mode), and the Gconv2 / Tconv2
strided maps and kmaps. Inputs are made with numpy from a seed and handed
to both packages as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import mapsearch as jmapsearch, morton as jmorton
from repro.kernels.octent import ops as joct_ops
from repro.kernels.octent.kernel import octent_query as joctent_query
from repro.kernels.octent.ref import octent_query_ref as joctent_query_ref
from repro_torch.core import mapsearch, morton
from repro_torch.kernels.octent import ops as oct_ops
from repro_torch.kernels.octent.ref import octent_query_ref
from tests.proptest import random_cloud

OFFS = morton.subm3_offsets()


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(port, ref):
    """Bit-identity on int32 (or bool) arrays."""
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.dtype == r.dtype, (p.dtype, r.dtype)
    assert p.shape == r.shape, (p.shape, r.shape)
    assert np.array_equal(p, r)


def _clouds():
    """(name, coords, batch, valid, grid_bits): out-of-grid queries at the
    grid limit, invalid padded rows, multi-batch, all-invalid."""
    rng = np.random.default_rng(0)
    yield ("plain",) + random_cloud(rng, 96, 20) + (7,)
    yield ("multibatch",) + random_cloud(rng, 96, 10, batch=3) + (7,)
    # sample window against the grid edge: offsets step out of the grid
    yield ("edge",) + random_cloud(rng, 80, 8, origin=(1 << 5) * 16 - 8,
                                   n_valid=60) + (5,)
    # sparse, far-apart voxels: many empty blocks around each one
    yield ("sparse",) + random_cloud(rng, 48, 200, n_valid=30) + (7,)
    c, b, v = random_cloud(rng, 40, 10)
    yield ("all_invalid", c, b, np.zeros_like(v), 7)


CLOUDS = list(_clouds())


def test_morton_matches_reference():
    rng = np.random.default_rng(1)
    c = rng.integers(0, 2048, (257, 3)).astype(np.int32)
    b = rng.integers(0, 16, 257).astype(np.int32)
    _eq(morton.block_key(_t(c), _t(b)), jmorton.block_key(jnp.asarray(c),
                                                          jnp.asarray(b)))
    _eq(morton.local_code(_t(c)), jmorton.local_code(jnp.asarray(c)))
    _eq(morton.child_octant(_t(c)), jmorton.child_octant(jnp.asarray(c)))
    for bits in (4, 5, 7, 10):
        _eq(morton.interleave3(_t(c), bits),
            jmorton.interleave3(jnp.asarray(c), bits))
    bank, row = morton.bank_and_row(morton.local_code(_t(c)))
    jbank, jrow = jmorton.bank_and_row(jmorton.local_code(jnp.asarray(c)))
    _eq(bank, jbank)
    _eq(row, jrow)
    assert np.array_equal(OFFS, jmorton.subm3_offsets())
    assert (morton.BLOCK_SIZE, morton.TABLE_SIZE, morton.BANK_ROWS) == (
        jmorton.BLOCK_SIZE, jmorton.TABLE_SIZE, jmorton.BANK_ROWS)


def test_unique_passes_match_reference():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 50, 200).astype(np.int32)
    codes[rng.random(200) < 0.2] = np.iinfo(np.int32).max
    for size in (64, 20):           # 20 < unique count: truncation
        got = mapsearch.sorted_unique(_t(codes), size)
        want = jmapsearch.sorted_unique(jnp.asarray(codes), size, nbits=6)
        for g, w in zip(got, want):
            _eq(g.reshape(np.shape(w)), w)
    hi = rng.integers(0, 8, 150).astype(np.int32)
    lo = rng.integers(0, 30, 150).astype(np.int32)
    valid = rng.random(150) < 0.8
    for size in (150, 40):
        got = mapsearch.unique_pairs(_t(hi), _t(lo), _t(valid), size)
        want = jmapsearch.unique_pairs(jnp.asarray(hi), jnp.asarray(lo),
                                       jnp.asarray(valid), size, hi_bits=3)
        for g, w in zip(got, want):
            _eq(g.reshape(np.shape(w)), w)


@pytest.mark.parametrize("case", CLOUDS, ids=[c[0] for c in CLOUDS])
def test_query_table_and_kmap_bit_identical(case):
    _, c, b, v, gb = case
    max_blocks = c.shape[0]
    qt = oct_ops.build_query_table(_t(c), _t(b), _t(v),
                                   max_blocks=max_blocks, grid_bits=gb)
    jqt = joct_ops.build_query_table(jnp.asarray(c), jnp.asarray(b),
                                     jnp.asarray(v), max_blocks=max_blocks,
                                     grid_bits=gb)
    for name in qt._fields:
        _eq(getattr(qt, name), getattr(jqt, name))
    kmap, n_blocks = oct_ops.build_kmap(_t(c), _t(b), _t(v),
                                        max_blocks=max_blocks, grid_bits=gb)
    want = joctent_query_ref(jnp.asarray(c), jnp.asarray(b), jnp.asarray(v),
                             jnp.asarray(OFFS), jqt.ublocks, jqt.tkey,
                             jqt.tval, jqt.n_blocks, grid_bits=gb)
    _eq(kmap, want)
    _eq(n_blocks, jqt.n_blocks)
    assert np.array_equal(kmap.numpy(),
                          jmapsearch.build_kmap_hash(c, b, v, OFFS))


def test_kmap_matches_pallas_kernel_interpret():
    _, c, b, v, gb = CLOUDS[2]          # the grid-edge cloud
    qt = joct_ops.build_query_table(jnp.asarray(c), jnp.asarray(b),
                                    jnp.asarray(v), max_blocks=c.shape[0],
                                    grid_bits=gb)
    qpack = joct_ops._pack_queries(jnp.asarray(c), jnp.asarray(b),
                                   jnp.asarray(v), bq=128)
    want = joctent_query(qpack, jnp.asarray(OFFS), qt.ublocks, qt.tkey,
                         qt.tval, qt.n_blocks, grid_bits=gb,
                         interpret=True)[:, :c.shape[0]].T
    got = octent_query_ref(_t(c), _t(b), _t(v), _t(OFFS), _t(qt.ublocks),
                           _t(qt.tkey), _t(qt.tval),
                           _t(np.asarray(qt.n_blocks)), grid_bits=gb)
    _eq(got, want)


def test_block_overflow_clamps_like_reference():
    # fewer directory slots than occupied blocks: the table keeps the
    # smallest keys and the query clamps n_blocks, exactly as the reference
    _, c, b, v, gb = CLOUDS[3]
    qt = oct_ops.build_query_table(_t(c), _t(b), _t(v), max_blocks=4,
                                   grid_bits=gb)
    jqt = joct_ops.build_query_table(jnp.asarray(c), jnp.asarray(b),
                                     jnp.asarray(v), max_blocks=4,
                                     grid_bits=gb)
    for name in qt._fields:
        _eq(getattr(qt, name), getattr(jqt, name))
    assert int(qt.n_blocks) > 4
    got = octent_query_ref(_t(c), _t(b), _t(v), _t(OFFS), qt.ublocks,
                           qt.tkey, qt.tval, qt.n_blocks, grid_bits=gb)
    want = joctent_query_ref(jnp.asarray(c), jnp.asarray(b), jnp.asarray(v),
                             jnp.asarray(OFFS), jqt.ublocks, jqt.tkey,
                             jqt.tval, jqt.n_blocks, grid_bits=gb)
    _eq(got, want)


@pytest.mark.parametrize("case", CLOUDS[:2] + CLOUDS[4:],
                         ids=[c[0] for c in CLOUDS[:2] + CLOUDS[4:]])
def test_strided_maps_bit_identical(case):
    _, c, b, v, gb = case
    maps = mapsearch.build_maps_gconv2(_t(c), _t(b), _t(v), grid_bits=gb)
    jmaps = jmapsearch.build_maps_gconv2(jnp.asarray(c), jnp.asarray(b),
                                         jnp.asarray(v), grid_bits=gb)
    for name in maps._fields:
        _eq(getattr(maps, name), getattr(jmaps, name))
    n = c.shape[0]
    _eq(mapsearch.strided_to_kmap(maps, n_out=n, n_taps=8),
        jmapsearch.strided_to_kmap(jmaps, n_out=n, n_taps=8))
    # Tconv2: the transposed maps back onto the input coordinate set
    tmaps = mapsearch.transpose_maps(maps, _t(c), _t(b), _t(v))
    jtmaps = jmapsearch.transpose_maps(jmaps, jnp.asarray(c), jnp.asarray(b),
                                       jnp.asarray(v))
    for name in tmaps._fields:
        if getattr(jtmaps, name) is not None:
            _eq(getattr(tmaps, name), getattr(jtmaps, name))
    _eq(mapsearch.strided_to_kmap(tmaps, n_out=n, n_taps=8),
        jmapsearch.strided_to_kmap(jtmaps, n_out=n, n_taps=8))


def test_subm3_plan_raises_on_block_overflow():
    from repro_torch.core import plan as planlib
    _, c, b, v, gb = CLOUDS[3]
    planlib.reset_mapsearch_counter()
    with pytest.raises(planlib.CapacityOverflow) as e:
        planlib.subm3_plan(_t(c), _t(b), _t(v), max_blocks=4, grid_bits=gb)
    assert e.value.capacity == 4 and e.value.needed > 4
    plan = planlib.subm3_plan(_t(c), _t(b), _t(v), max_blocks=c.shape[0],
                              grid_bits=gb, bm=16)
    assert planlib.mapsearch_call_count() == 2
    assert np.array_equal(plan.kmap.numpy(),
                          jmapsearch.build_kmap_hash(c, b, v, OFFS))


def _kernel_edge_cloud(name):
    """The clouds that steer the CUDA kernel's other branches: a run of
    duplicate keys (keep-first), and one 16^3 block holding all 4,096
    voxels, more than the kernel stages, inside a shell of neighbours."""
    rng = np.random.default_rng(5)
    if name == "duplicates":
        c, b, v = random_cloud(rng, 160, 12, batch=2, n_valid=120)
        c[120:], b[120:], v[120:] = c[:40], b[:40], True
        return c, b, v
    g = np.stack(np.meshgrid(*[np.arange(16, 32)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    c = np.unique(np.concatenate([g, rng.integers(12, 36, (300, 3))]),
                  axis=0).astype(np.int32)
    c = c[rng.permutation(c.shape[0])]
    return c, np.zeros(c.shape[0], np.int32), np.ones(c.shape[0], bool)


@pytest.mark.parametrize("name", ["duplicates", "full_block"])
def test_kmap_kernel_edge_clouds_bit_identical(name):
    c, b, v = _kernel_edge_cloud(name)
    jqt = joct_ops.build_query_table(jnp.asarray(c), jnp.asarray(b),
                                     jnp.asarray(v), max_blocks=c.shape[0])
    kmap, _ = oct_ops.build_kmap(_t(c), _t(b), _t(v), max_blocks=c.shape[0])
    want = joctent_query_ref(jnp.asarray(c), jnp.asarray(b), jnp.asarray(v),
                             jnp.asarray(OFFS), jqt.ublocks, jqt.tkey,
                             jqt.tval, jqt.n_blocks)
    _eq(kmap, want)
    if name == "duplicates":
        # both copies see the first copy's row
        hits = kmap.numpy()[120:, 13]
        assert np.array_equal(hits, np.arange(40))
