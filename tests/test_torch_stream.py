"""Parity of the port's streaming slice (repro_torch) against the JAX package.

The same numpy frames go through both packages' delta paths. Integer
outputs are held bit for bit at every level of every frame: the new
canonical arrays, ``slot_of``, the inserted / evicted / dirty masks and
dirty blocks, the spliced stage-1 tables, the kmaps and the sessions'
counters. The port's delta path is also held to its own build from
scratch (``build_query_table``, a full ``build_kmap``, a scratch session).
Logits agree with the reference's within 1e-4 of their max (float32 in
another summation order), weights carried by ``params_from_jax``. The
sanitizer, the pinned store, ``build_kmap(update=)`` with kernel 1's
row-list mode (its plain version on the CPU), ``moving_sensor_sequence``
and the launcher are held to the reference as well.

Row budgets of the replanning tests are used by no other test: the
capacity memo of ``with_replan`` is process-wide in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import plan as jplan
from repro.core import stream as jstream
from repro.core import validate as jvalidate
from repro.data import pointcloud as jpointcloud
from repro.kernels.octent import ops as joct
from repro.launch import spconv_stream as jlaunch
from repro.models import minkunet as jminkunet
from repro.runtime import feature_cache as jfc, guard as jguard
from repro_torch.core import morton, stream, validate
from repro_torch.core import plan as planlib
from repro_torch.data import pointcloud
from repro_torch.kernels.octent import kernel as oct_kernel, ops as oct_ops
from repro_torch.launch import spconv_stream
from repro_torch.models import minkunet
from repro_torch.runtime import feature_cache, guard
from tests.proptest import forall, frame_sequence, random_cloud

GB, BB = 5, 2            # 32 blocks an axis, 4 batches
TINY = dict(name="tiny", in_ch=3, classes=4, stem=8, enc=(8, 8),
            dec=(8, 8), blocks=1, grid_bits=GB, batch_bits=BB)
SMALL = dict(name="stream-small", in_ch=3, classes=8, stem=16,
             enc=(16, 32), dec=(32, 16), blocks=1, grid_bits=6,
             batch_bits=2)
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tests run thousands of
    small ops, which the default thread pool slows by an order of
    magnitude when parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def _table_eq(a, b, msg=""):
    for name, x, y in zip(oct_ops.QueryTable._fields, a, b):
        _eq(x, y, f"{msg} QueryTable.{name}")


def _state_eq(a, b, msg=""):
    for name in ("coords", "batch", "valid", "kmap"):
        _eq(getattr(a, name), getattr(b, name), f"{msg} {name}")
    _table_eq(a.table, b.table, msg)


def _delta_eq(a, b, msg=""):
    for name in stream.FrameDelta._fields:
        _eq(getattr(a, name), getattr(b, name), f"{msg} delta.{name}")


def _scratch(st, mb):
    """The port's build from scratch over a state's canonical arrays."""
    table = oct_ops.build_query_table(st.coords, st.batch, st.valid,
                                      max_blocks=mb, grid_bits=GB,
                                      batch_bits=BB)
    kmap, _ = oct_ops.build_kmap(st.coords, st.batch, st.valid,
                                 max_blocks=mb, grid_bits=GB, batch_bits=BB,
                                 impl="ref", table=table)
    return table, kmap


def _delta_step(st, frame, mb):
    """One frame through the port's raw delta path: diff, splice, the
    dirty rows' search (the calls StreamSession makes)."""
    c, b, v = (_t(a) for a in frame)
    delta, nc, nb, nv = stream.diff_frame(st, c, b, v, max_blocks=mb,
                                          grid_bits=GB, batch_bits=BB)
    n_dirty = int(delta.n_dirty_rows)
    if n_dirty == 0:
        return delta, stream.FrameState(nc, nb, nv, st.table, st.kmap)
    table = stream.apply_table_delta(st.table, delta, st.coords, st.batch,
                                     nc, nb, max_blocks=mb, grid_bits=GB,
                                     batch_bits=BB)
    rows = stream.pack_dirty_rows(delta.dirty_rows,
                                  stream.row_budget(n_dirty, nc.shape[0]))
    assert rows is not None
    kmap, _ = oct_ops.build_kmap(nc, nb, nv, max_blocks=mb, grid_bits=GB,
                                 batch_bits=BB, table=table,
                                 update=oct_ops.KmapUpdate(st.kmap, rows))
    return delta, stream.FrameState(nc, nb, nv, table, kmap)


def _jdelta_step(st, frame, mb):
    """The same frame through the reference's delta path."""
    c, b, v = (jnp.asarray(a) for a in frame)
    delta, nc, nb, nv = jstream.diff_frame(st, c, b, v, max_blocks=mb,
                                           grid_bits=GB, batch_bits=BB)
    n_dirty = int(delta.n_dirty_rows)
    if n_dirty == 0:
        return delta, jstream.FrameState(nc, nb, nv, st.table, st.kmap)
    table = jstream.apply_table_delta(st.table, delta, st.coords, st.batch,
                                      nc, nb, max_blocks=mb, grid_bits=GB,
                                      batch_bits=BB)
    rows = jstream.pack_dirty_rows(delta.dirty_rows,
                                   jstream.row_budget(n_dirty, nc.shape[0]))
    kmap, _ = joct.build_kmap(nc, nb, nv, max_blocks=mb, grid_bits=GB,
                              batch_bits=BB, impl="ref", table=table,
                              update=joct.KmapUpdate(st.kmap,
                                                     jnp.asarray(rows)))
    return delta, jstream.FrameState(nc, nb, nv, table, kmap)


def _pair_states(n, mb):
    return (stream.empty_state(n, max_blocks=mb, grid_bits=GB,
                               batch_bits=BB, device="cpu"),
            jstream.empty_state(n, max_blocks=mb, grid_bits=GB,
                                batch_bits=BB))


# ---------------------------------------------------------------------------
# The property: incremental == reference == from scratch, every frame
# ---------------------------------------------------------------------------

@forall(4)
def test_stream_parity_over_sequences(rng):
    """4 seeds x 8 transitions of churn, inserts, evictions, jitter,
    teleports and repeats: the diff, the new canonical arrays, the spliced
    table and the updated kmap equal the reference's bit for bit, and the
    port's own build from scratch; kept voxels keep their rows."""
    n, mb = 512, 64
    st, jst = _pair_states(n, mb)
    for t, frame in enumerate(frame_sequence(rng, 9, n, 48, batch=2,
                                             turnover=0.2)):
        old = st
        delta, st = _delta_step(st, frame, mb)
        jdelta, jst = _jdelta_step(jst, frame, mb)
        _delta_eq(delta, jdelta, f"frame {t}")
        _state_eq(st, jst, f"frame {t}")
        t_ref, k_ref = _scratch(st, mb)
        _table_eq(st.table, t_ref, f"frame {t} vs scratch")
        _eq(st.kmap, k_ref, f"frame {t} kmap vs scratch")
        kept = old.valid & ~delta.evicted
        assert torch.equal(st.coords[kept], old.coords[kept])
        assert bool(st.valid[kept].all())


def _sessions(cfg, n, mb, **kw):
    """A delta session and its scratch twin (content keys off, so that no
    plan is served without a search), each with its own pinned store."""
    d = stream.StreamSession(
        cfg, n, max_blocks=mb, enabled=True, device="cpu",
        cache=planlib.PlanCache(pinned=feature_cache.PinnedStore()), **kw)
    s = stream.StreamSession(
        cfg, n, max_blocks=mb, enabled=False, device="cpu",
        cache=planlib.PlanCache(content=False,
                                pinned=feature_cache.PinnedStore()), **kw)
    return d, s


def _jsession(cfg, n, mb, **kw):
    return jstream.StreamSession(
        cfg, n, max_blocks=mb, search_impl="ref", enabled=True,
        cache=jplan.PlanCache(pinned=jfc.PinnedStore()), **kw)


def _models(cfg_kw, seed=0):
    jcfg = jminkunet.MinkUNetConfig(**cfg_kw)
    params = jminkunet.init_model(jcfg, jax.random.key(seed))
    model = minkunet.MinkUNet(minkunet.MinkUNetConfig(**cfg_kw),
                              device="cpu")
    model.load_state_dict(minkunet.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, params, model


def _sessions_eq(sessions, jsess, msg):
    for r in range(jsess.levels):
        for sess in sessions:
            _state_eq(sess.states[r], jsess.states[r], f"{msg} level {r}")
            _eq(sess.plans.subm[r].kmap, jsess.plans.subm[r].kmap,
                f"{msg} level {r} plan")
    for r in range(jsess.levels - 1):
        _eq(sessions[0].plans.down[r].kmap, jsess.plans.down[r].kmap,
            f"{msg} gconv2 {r}")


def _logits_close(got, want, msg):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1e-6), f"{msg}: {err}"


@forall(2)
def test_stream_session_plan_and_forward_parity(rng):
    """Session level: every level's state and plans, ``slot_of`` and the
    counters equal the reference session's; the delta and scratch
    sessions' logits are equal; the logits match the reference's."""
    n, mb = 512, 64
    jcfg, params, model = _models(TINY)
    cfg = model.cfg
    d, s = _sessions(cfg, n, mb)
    j = _jsession(jcfg, n, mb)
    for t, frame in enumerate(frame_sequence(rng, 5, n, 32, batch=2,
                                             turnover=0.15)):
        dd = d.advance(*frame)
        ds = s.advance(*frame)
        dj = j.advance(*frame)
        _eq(dd.slot_of, dj.slot_of, f"frame {t} slot_of")
        _eq(ds.slot_of, dj.slot_of, f"frame {t} slot_of (scratch)")
        _sessions_eq((d, s), j, f"frame {t}")
        feats = rng.standard_normal((n, cfg.in_ch)).astype(np.float32)
        la, lb = d.forward(model, feats), s.forward(model, feats)
        assert torch.equal(la, lb), f"frame {t}: delta vs scratch logits"
        _logits_close(la, j.forward(params, jnp.asarray(feats)),
                      f"frame {t}")
    assert d.stats() == j.stats()
    for sess in (d, s, j):
        sess.close()


@pytest.mark.parametrize("name", ["tiny", "small"])
def test_stream_session_delta_coverage(name):
    """A moving-sensor replay takes the delta path, searches fewer rows
    than its scratch twin, and matches the reference session level by
    level and the scratch session at the logits; TINY and the replay
    benchmark's ``small`` config."""
    cfg_kw = TINY if name == "tiny" else SMALL
    n, mb = 512, 64
    frames = pointcloud.moving_sensor_sequence(
        np.random.default_rng(5), 6, n, window=128, step=8, depth=16,
        density=0.2)
    jcfg, params, model = _models(cfg_kw, seed=1)
    d, s = _sessions(model.cfg, n, mb)
    j = _jsession(jcfg, n, mb)
    for t, f in enumerate(frames):
        for sess in (d, s, j):
            sess.advance(f.coords, f.batch, f.valid)
        _sessions_eq((d, s), j, f"frame {t}")
        feats = f.feats[:, :model.cfg.in_ch]
        la = d.forward(model, feats)
        assert torch.equal(la, s.forward(model, feats)), f"frame {t}"
        _logits_close(la, j.forward(params, jnp.asarray(feats)),
                      f"frame {t}")
    ds, ss = d.stats(), s.stats()
    assert ds == j.stats()
    assert ds["delta_levels"] > 0, "moving sensor never delta-patched"
    assert ds["rows_searched"] < ss["rows_searched"]
    for sess in (d, s, j):
        sess.close()


# ---------------------------------------------------------------------------
# Degenerate ends of the turnover spectrum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("content", [False, True])
def test_empty_delta_is_zero_query_rows(content):
    """A repeated frame costs no stage-2 query row on both no-op paths
    (the warm patch with no dirty row, and the content hit), with the
    reference's counters."""
    n, mb = 512, 64
    frame = next(frame_sequence(np.random.default_rng(7), 1, n, 32))
    cfg = minkunet.MinkUNetConfig(**TINY)
    sess = stream.StreamSession(
        cfg, n, max_blocks=mb, enabled=True, device="cpu",
        cache=planlib.PlanCache(content=content,
                                pinned=feature_cache.PinnedStore()))
    jsess = jstream.StreamSession(
        jminkunet.MinkUNetConfig(**TINY), n, max_blocks=mb,
        search_impl="ref", enabled=True,
        cache=jplan.PlanCache(content=content, pinned=jfc.PinnedStore()))
    for s in (sess, jsess):
        s.advance(*frame)
    before, jbefore = sess.stats(), jsess.stats()
    q0, jq0 = oct_ops.QUERY_ROWS[0], joct.query_row_count()
    d = sess.advance(*frame)
    jsess.advance(*frame)
    assert int(d.n_dirty_rows) == 0
    assert oct_ops.QUERY_ROWS[0] == q0
    assert joct.query_row_count() == jq0
    after = sess.stats()
    key = "content_hit_levels" if content else "delta_levels"
    assert after[key] - before[key] == sess.levels
    assert after["rows_searched"] == before["rows_searched"]
    assert after["kmap_rows_reused"] - before["kmap_rows_reused"] \
        == sess.levels * n
    assert before == jbefore and after == jsess.stats()
    sess.close()
    jsess.close()


def test_full_turnover_matches_scratch():
    """Disjoint frames exceed every delta threshold at level 0: both
    sessions rebuild from scratch there and agree with the reference."""
    n, mb = 512, 64
    rng = np.random.default_rng(11)
    f1 = random_cloud(rng, n, 16, n_valid=384)
    f2 = random_cloud(rng, n, 16, n_valid=384, origin=16)
    cfg = minkunet.MinkUNetConfig(**TINY)
    d, s = _sessions(cfg, n, mb)
    j = _jsession(jminkunet.MinkUNetConfig(**TINY), n, mb)
    for sess in (d, s, j):
        sess.advance(*f1)
    mid = d.stats()["full_levels"]
    for sess in (d, s, j):
        sess.advance(*f2)
    _sessions_eq((d, s), j, "frame 1")
    assert d.stats()["full_levels"] > mid
    assert d.stats() == j.stats()
    t_ref, _ = _scratch(d.states[0], mb)
    _table_eq(d.states[0].table, t_ref)
    for sess in (d, s, j):
        sess.close()


def test_boundary_drift_drops_out_of_grid_rows():
    """A cloud marching off the grid's edge: out-of-grid rows get no slot
    (never aliased into the table), as in the reference, and the state
    still equals a build from scratch over what remains."""
    n, mb = 512, 64
    limit = 16 << GB
    st, jst = _pair_states(n, mb)
    rng = np.random.default_rng(13)
    c, b, v = random_cloud(rng, n, 24, n_valid=320, origin=limit - 28)
    for step in range(4):
        cs = c + np.int32([8 * step, 0, 0])
        delta, st = _delta_step(st, (cs, b, v), mb)
        jdelta, jst = _jdelta_step(jst, (cs, b, v), mb)
        _delta_eq(delta, jdelta, f"step {step}")
        _state_eq(st, jst, f"step {step}")
        out = v & (cs >= limit).any(axis=1)
        assert bool((delta.slot_of.numpy()[out] < 0).all())
        live = st.valid
        assert bool((st.coords[live] < limit).all())
        assert bool((st.coords[live] >= 0).all())
        t_ref, k_ref = _scratch(st, mb)
        _table_eq(st.table, t_ref, f"step {step}")
        _eq(st.kmap, k_ref)
    assert int(st.valid.sum()) < int(v.sum())


# ---------------------------------------------------------------------------
# Capacity overflow mid-sequence
# ---------------------------------------------------------------------------

def _two_block_growth_frames(n):
    """Frame 1 occupies 3 16^3 blocks; frame 2 adds voxels in 2 more: it
    fits a dirty-block budget of 4 but overflows a 4-entry directory at
    splice time."""
    rng = np.random.default_rng(17)
    c = np.zeros((n, 3), np.int32)
    b = np.zeros((n,), np.int32)
    v = np.zeros((n,), bool)
    seen = set()
    blocks1 = [(0, 0, 0), (1, 0, 0), (0, 1, 0)]
    i = 0
    while i < 20:
        bl = blocks1[int(rng.integers(0, 3))]
        p = tuple(int(x) * 16 + int(y) for x, y in
                  zip(bl, rng.integers(0, 14, 3)))
        if p in seen:
            continue
        seen.add(p)
        c[i], v[i] = p, True
        i += 1
    c2, v2 = c.copy(), v.copy()
    for j, bl in enumerate([(1, 1, 0), (1, 1, 0), (0, 0, 1)]):
        c2[i + j] = [x * 16 + 4 + j for x in bl]
        v2[i + j] = True
    return (c, b, v), (c2, b, v2)


def test_overflow_mid_sequence_is_atomic():
    """With replanning off, the overflow raises the port's
    CapacityOverflow where the reference raises its own, and neither
    session changes: the same frame then replays as an empty delta."""
    n = 544
    f1, f2 = _two_block_growth_frames(n)
    cfg = minkunet.MinkUNetConfig(**TINY)
    sess = stream.StreamSession(
        cfg, n, max_blocks=4, enabled=True, replan=False, device="cpu",
        cache=planlib.PlanCache(pinned=feature_cache.PinnedStore()))
    jsess = _jsession(jminkunet.MinkUNetConfig(**TINY), n, 4, replan=False)
    for s in (sess, jsess):
        s.advance(*f1)
    snap_valid = sess.states[0].valid.clone()
    snap_stats = sess.stats()
    with pytest.raises(planlib.CapacityOverflow):
        sess.advance(*f2)
    with pytest.raises(jvalidate.CapacityOverflow):
        jsess.advance(*f2)
    assert sess.stats() == snap_stats == jsess.stats()
    assert torch.equal(sess.states[0].valid, snap_valid)
    assert sess.mb[0] == jsess.mb[0] == 4
    assert int(sess.advance(*f1).n_dirty_rows) == 0
    sess.close()
    jsess.close()


def test_overflow_recovers_with_replan():
    """With replanning on, the same overflow escalates max_blocks and
    rebuilds from scratch, as the reference does; the next small delta
    patches again, bit-equal to a build from scratch."""
    n = 576
    f1, f2 = _two_block_growth_frames(n)
    cfg = minkunet.MinkUNetConfig(**TINY)
    sess = stream.StreamSession(
        cfg, n, max_blocks=4, enabled=True, replan=True, device="cpu",
        cache=planlib.PlanCache(pinned=feature_cache.PinnedStore()))
    jsess = _jsession(jminkunet.MinkUNetConfig(**TINY), n, 4, replan=True)
    c3 = np.asarray(f2[0]).copy()
    c3[22, 2] += 1                     # one voxel jittered
    for t, frame in enumerate((f1, f2, (c3, f2[1], f2[2]))):
        before = sess.stats()["delta_levels"]
        for s in (sess, jsess):
            s.advance(*frame)
        assert sess.mb == jsess.mb, f"frame {t}"
        _sessions_eq((sess,), jsess, f"frame {t}")
        if t == 1:
            assert sess.mb[0] > 4, "overflow did not escalate capacity"
        if t == 2:
            assert sess.stats()["delta_levels"] > before
    st = sess.states[0]
    t_ref = oct_ops.build_query_table(st.coords, st.batch, st.valid,
                                      max_blocks=sess.mb[0], grid_bits=GB,
                                      batch_bits=BB)
    _table_eq(st.table, t_ref)
    assert sess.stats() == jsess.stats()
    sess.close()
    jsess.close()


# ---------------------------------------------------------------------------
# Pinned-store refcounts
# ---------------------------------------------------------------------------

def test_pinned_refcount_blocks_eviction():
    """An acquired key survives byte pressure; everything held admits over
    budget; a release returns the key to insertion-order eviction. The
    same operations on the reference's store give the same results and
    the same stats."""
    arr = np.arange(2048, dtype=np.int32)
    stores = (feature_cache.PinnedStore(capacity_bytes=2 * arr.nbytes),
              jfc.PinnedStore(capacity_bytes=2 * arr.nbytes))
    results = []
    for store, mk in zip(stores, (torch.as_tensor, jnp.asarray)):
        got = []
        store.put("a", mk(arr))
        store.put("b", mk(arr + 1))
        store.acquire("a")
        store.acquire("b")
        store.put("c", mk(arr + 2))          # nothing evictable
        got += [store.evictions_skipped >= 1,
                store.get("a") is not None, store.get("b") is not None,
                store.get("c") is not None]
        store.release("a")
        got += [store.refcount("a"), store.refcount("b")]
        store.put("d", mk(arr + 3))          # "a" is the oldest unheld
        got += [store.get("a") is None, store.get("b") is not None]
        store.release("b")
        store.release("b")                   # a no-op
        got += [store.refcount("b"), len(store), store.resident_bytes()]
        results.append((got, store.stats()))
    (got, st), (jgot, jst) = results
    # "d" evicts the released "a" and then "c" to fit the budget
    assert got == jgot == [True, True, True, True, 0, 1, True, True, 0, 2,
                           2 * arr.nbytes]
    assert st == jst
    assert feature_cache.nbytes(oct_ops.QueryTable(
        *(torch.zeros(4, dtype=torch.int32),) * 4)) == 64


def test_pinned_verify_drops_collisions_and_anchorless_entries():
    store = feature_cache.PinnedStore()
    a = (torch.arange(4, dtype=torch.int32),)
    store.put("k", torch.ones(2), anchor=a)
    assert store.get("k", anchor=a, verify=True) is not None
    hb = guard.health().get("pinned.collision")
    assert store.get("k", anchor=(a[0] + 1,), verify=True) is None
    assert store.collisions == 1
    assert guard.health().get("pinned.collision") == hb + 1
    store.put("bare", torch.ones(2))
    assert store.get("bare") is not None
    assert store.get("bare", anchor=a, verify=True) is None
    assert store.collisions == 1 and "bare" not in store


def test_session_close_releases_pins():
    n, mb = 512, 64
    store = feature_cache.PinnedStore()
    sess = stream.StreamSession(
        minkunet.MinkUNetConfig(**TINY), n, max_blocks=mb, enabled=True,
        device="cpu", cache=planlib.PlanCache(pinned=store))
    frame = next(frame_sequence(np.random.default_rng(23), 1, n, 32))
    sess.advance(*frame)
    assert any(store.refcount(k) for k in sess.pin_keys if k is not None)
    sess.close()
    sess.close()                            # idempotent
    assert store.stats()["held"] == 0


def test_pinned_table_skips_stage_one_but_counts_the_search():
    """A Subm3 build that finds its table pinned counts one map search and
    one store hit, as the reference's does; a cache without content keys
    pins nothing."""
    c, b, v = random_cloud(np.random.default_rng(3), 300, 20)
    counts = []
    for pkg, store_cls, mk, impl in (
            (planlib, feature_cache.PinnedStore, _t, "kernel"),
            (jplan, jfc.PinnedStore, jnp.asarray, "ref")):
        pkg.reset_mapsearch_counter()
        kw = dict(max_blocks=300, grid_bits=GB, batch_bits=BB,
                  search_impl=impl)
        store = store_cls()
        # two caches over one store: the second's plan misses, its table
        # hits
        for cache in (pkg.PlanCache(pinned=store),
                      pkg.PlanCache(pinned=store)):
            plan = pkg.subm3_plan(mk(c), mk(b), mk(v), cache=cache, **kw)
        bare = pkg.PlanCache(content=False, pinned=store_cls())
        pkg.subm3_plan(mk(c), mk(b), mk(v), cache=bare, **kw)
        counts.append((pkg.mapsearch_call_count(), store.hits, store.misses,
                       len(store), len(bare.pinned), np.asarray(plan.kmap)))
    (*got, kmap), (*want, jkmap) = counts
    assert got == want == [3, 1, 1, 1, 0]
    _eq(kmap, jkmap)


# ---------------------------------------------------------------------------
# build_kmap(update=) and kernel 1's row-list mode (plain version)
# ---------------------------------------------------------------------------

def test_build_kmap_update_requires_table():
    c, b, v = random_cloud(np.random.default_rng(0), 64, 32)
    upd = oct_ops.KmapUpdate(torch.full((64, 27), -1, dtype=torch.int32),
                             torch.full((64,), -1, dtype=torch.int32))
    with pytest.raises(ValueError, match="update"):
        oct_ops.build_kmap(_t(c), _t(b), _t(v), max_blocks=64, grid_bits=GB,
                           batch_bits=BB, update=upd)
    jupd = joct.KmapUpdate(jnp.full((64, 27), -1, jnp.int32),
                           jnp.full((64,), -1, jnp.int32))
    with pytest.raises(ValueError, match="update"):
        joct.build_kmap(jnp.asarray(c), jnp.asarray(b), jnp.asarray(v),
                        max_blocks=64, grid_bits=GB, batch_bits=BB,
                        impl="ref", update=jupd)


@forall(4)
def test_build_kmap_update_restores_dirty_rows(rng):
    """Listed rows are searched again, unlisted rows pass through bit for
    bit (even corrupted ones), through both impls and the reference's;
    ``QUERY_ROWS`` adds Q as the reference's counter does; an all -1 list
    is a copy of the previous kmap."""
    n = 512
    c, b, v = random_cloud(rng, n, 48, batch=2)
    ct, bt, vt = _t(c), _t(b), _t(v)
    kw = dict(max_blocks=64, grid_bits=GB, batch_bits=BB)
    table = oct_ops.build_query_table(ct, bt, vt, **kw)
    full, _ = oct_ops.build_kmap(ct, bt, vt, impl="ref", table=table, **kw)
    dirty = np.sort(rng.choice(n, size=int(rng.integers(1, 200)),
                               replace=False)).astype(np.int32)
    prev = full.numpy().copy()
    prev[dirty] = -7
    rows = np.full((stream.row_budget(dirty.size, n),), -1, np.int32)
    rows[:dirty.size] = dirty
    jtable = joct.build_query_table(jnp.asarray(c), jnp.asarray(b),
                                    jnp.asarray(v), **kw)
    jq0 = joct.query_row_count()
    jout, _ = joct.build_kmap(jnp.asarray(c), jnp.asarray(b),
                              jnp.asarray(v), impl="ref", table=jtable,
                              update=joct.KmapUpdate(jnp.asarray(prev),
                                                     jnp.asarray(rows)),
                              **kw)
    for impl in ("kernel", "ref"):
        q0 = oct_ops.QUERY_ROWS[0]
        out, _ = oct_ops.build_kmap(
            ct, bt, vt, impl=impl, table=table,
            update=oct_ops.KmapUpdate(_t(prev), _t(rows)), **kw)
        assert oct_ops.QUERY_ROWS[0] - q0 == rows.size \
            == joct.query_row_count() - jq0
        assert torch.equal(out, full)
        _eq(out, jout)
    none_rows = torch.full((n,), -1, dtype=torch.int32)
    out2, _ = oct_ops.build_kmap(ct, bt, vt, table=table,
                                 update=oct_ops.KmapUpdate(_t(prev),
                                                           none_rows), **kw)
    _eq(out2, prev)


def test_octent_query_row_list_checks_and_empty_list():
    c, b, v = random_cloud(np.random.default_rng(4), 256, 24)
    ct, bt, vt = _t(c), _t(b), _t(v)
    qt = oct_ops.build_query_table(ct, bt, vt, max_blocks=64, grid_bits=GB,
                                   batch_bits=BB)
    offs = torch.as_tensor(morton.subm3_offsets())
    args = (ct, bt, vt, offs, qt.ublocks, qt.tkey, qt.tval, qt.n_blocks)
    prev = torch.full((256, 27), 5, dtype=torch.int32)
    rows = torch.tensor([3, -1, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        oct_kernel.octent_query(*args, grid_bits=GB, rows=rows)
    with pytest.raises(TypeError):
        oct_kernel.octent_query(*args, grid_bits=GB, rows=rows.long(),
                                prev=prev)
    with pytest.raises(ValueError):
        oct_kernel.octent_query(*args, grid_bits=GB, rows=rows,
                                prev=prev[:10])
    with pytest.raises(ValueError):
        oct_kernel.octent_query(*args, grid_bits=GB, rows=rows[None],
                                prev=prev)
    before = oct_kernel.launches
    empty = oct_kernel.octent_query(*args, grid_bits=GB,
                                    rows=rows[:0], prev=prev)
    assert torch.equal(empty, prev) and empty is not prev
    got = oct_kernel.octent_query(*args, grid_bits=GB, rows=rows, prev=prev)
    full = oct_kernel.octent_query(*args, grid_bits=GB)
    assert torch.equal(got[[0, 3]], full[[0, 3]])
    assert bool((got[[1, 2, 4]] == 5).all())
    assert oct_kernel.launches == before     # the CPU runs the plain one


# ---------------------------------------------------------------------------
# Ingress sanitizer, health counters, the generator, the launcher
# ---------------------------------------------------------------------------

def _dirty_cloud():
    """One cloud with every failure class but shape: a float coordinate,
    NaN coordinates and features, out-of-grid rows, duplicates."""
    rng = np.random.default_rng(9)
    c, b, v = random_cloud(rng, 64, 20, n_valid=48)
    c = c.astype(np.float32)
    c[1, 0] += 0.5                      # fractional
    c[2, 1] = np.nan                    # non-finite coordinate
    c[3] = [600, 0, 0]                  # out of the grid at GB = 5
    b[4] = 9                            # batch out of range at BB = 2
    c[5], c[6] = c[7], c[7]             # duplicates of row 7
    f = rng.standard_normal((64, 3)).astype(np.float32)
    f[8, 2] = np.inf                    # non-finite feature
    return c, b, v, f


@pytest.mark.parametrize("case", ["repair", "strict", "clean", "empty",
                                  "oversize", "clip"])
def test_sanitize_cloud_matches_reference(case):
    c, b, v, f = _dirty_cloud()
    kw = dict(grid_bits=GB, batch_bits=BB)
    if case == "strict":
        kw["policy"] = validate.STRICT
    elif case == "clip":
        kw["policy"] = validate.CloudPolicy(out_of_grid="clip")
    elif case == "clean":
        c, b, v = random_cloud(np.random.default_rng(1), 64, 20, n_valid=48)
        f = None
    elif case == "empty":
        v = np.zeros_like(v)
        kw["policy"] = validate.CloudPolicy(empty="reject")
    elif case == "oversize":
        kw["max_valid"] = 30
    jkw = dict(kw)
    if "policy" in kw:
        jkw["policy"] = jvalidate.CloudPolicy(**dataclasses.asdict(
            kw["policy"]))
    outs = []
    for mod, g in ((validate, guard), (jvalidate, jguard)):
        h0 = g.health().snapshot()
        try:
            res = mod.sanitize_cloud(c, b, v, f, **(kw if mod is validate
                                                    else jkw))
        except (validate.CloudValidationError,
                jvalidate.CloudValidationError) as e:
            res = ("raised", e.kind)
        moved = {k: n for k, n in g.health().delta(h0).items()
                 if k.startswith("validate.")}
        outs.append((res, moved))
    (res, moved), (jres, jmoved) = outs
    assert moved == jmoved and (moved or case == "clean")
    if isinstance(res[0], str):
        assert res == jres
        return
    for a, ja in zip(res[:4], jres[:4]):
        if ja is None:
            assert a is None
        else:
            _eq(a, ja)
    assert res[4] == jres[4]
    if case == "clean":
        assert res[0] is c and res[4].ok
    # tensors in, tensors out
    tres = validate.sanitize_cloud(_t(c), _t(b), _t(v), **kw)
    assert all(isinstance(a, torch.Tensor) for a in tres[:3])
    _eq(tres[2], res[2])


@pytest.mark.parametrize("mode", ["repair", "strict", "off", None])
def test_validate_policy_reads_the_flag(monkeypatch, mode):
    if mode is None:
        monkeypatch.delenv("REPRO_GUARD_VALIDATE", raising=False)
    else:
        monkeypatch.setenv("REPRO_GUARD_VALIDATE", mode)
    got, want = guard.validate_policy(), jguard.validate_policy()
    assert (got is None) == (want is None)
    if got is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_session_sanitizes_its_frames():
    """A frame with duplicates and an out-of-grid row is repaired on the
    host before it moves to the device: the same canonical state as the
    reference's session, whose sanitizer repairs it alike."""
    n, mb = 512, 64
    c, b, v = random_cloud(np.random.default_rng(2), n, 20, n_valid=200)
    c[10], c[11] = c[12], [900, 0, 0]
    cfg = minkunet.MinkUNetConfig(**TINY)
    sess = stream.StreamSession(
        cfg, n, max_blocks=mb, device="cpu",
        cache=planlib.PlanCache(pinned=feature_cache.PinnedStore()))
    jsess = _jsession(jminkunet.MinkUNetConfig(**TINY), n, mb)
    h0 = guard.health().snapshot()
    d = sess.advance(c, b, v)
    jd = jsess.advance(c, b, v)
    _eq(d.slot_of, jd.slot_of)
    _sessions_eq((sess,), jsess, "sanitized")
    assert guard.health().delta(h0) == {"validate.out_of_grid": 1,
                                        "validate.duplicate": 1}
    sess.close()
    jsess.close()


def test_moving_sensor_sequence_bit_equal():
    kw = dict(window=64, step=8, depth=12, density=0.35)
    got = pointcloud.moving_sensor_sequence(np.random.default_rng(3), 5,
                                            700, **kw)
    want = jpointcloud.moving_sensor_sequence(np.random.default_rng(3), 5,
                                              700, **kw)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            _eq(a, b)
    assert int(got[0].valid.sum()) == 700    # kept the lowest keys


def test_run_stream_matches_reference():
    """The launcher end to end on the CPU: the same counters and pinned
    store as the reference's ``run_stream`` on the same frames."""
    kw = dict(window=96, step=8, depth=16, density=0.2, seed=2,
              pinned_bytes=2 ** 24, log=None)
    got = spconv_stream.run_stream(spconv_stream.CONFIGS["tiny"], 4, 512,
                                   device="cpu", **kw)
    want = jlaunch.run_stream(jlaunch.CONFIGS["tiny"], 4, 512, impl="ref",
                              **kw)
    counters = [k for k in got if isinstance(got[k], int)]
    assert len(counters) == 10
    assert {k: got[k] for k in counters} == {k: want[k] for k in counters}
    assert got["search_fraction"] == want["search_fraction"]
    assert got["pinned"] == {k: want["pinned"][k] for k in got["pinned"]}
