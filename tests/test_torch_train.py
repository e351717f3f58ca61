"""Parity of the port's training slice (repro_torch) against the JAX package.

The same seeded inputs go through both packages on the CPU, with the plain
versions of the kernels (``impl="ref"``) and the reference's weights
carried across by ``params_from_jax`` / ``adamw_state_from_jax``. Models:
the reference demo's config (stem 8, enc (8, 16), dec (16, 8), 4 classes,
one block) and a deeper one (three stages, two blocks), with every
BatchNorm bias at -1 so that ReLU leaves whole tiles dead.

Tolerances (float32 throughout; only the summation order differs):

* ``batch_norm(training=True)``: output and new statistics within 1e-6
  (absolute, values of order 1);
* ``segmentation_loss``: the loss within 1e-5 relative; each gradient
  within 1e-4 x its own max |g|. Three kinds are zero in exact
  arithmetic: the BatchNorm statistics (exactly zero on both sides) and
  every conv bias, since each conv feeds a training BatchNorm that
  subtracts the batch mean; those biases hold float32 rounding noise
  (measured at most 2.3e-7 of the model's largest |g|), held below 1e-6 of
  it on both sides;
* ``adamw.update`` / ``schedule``: parameters, moments and the learning
  rate within 1e-6, ``grad_norm`` (about 169 here) within 1e-6 relative;
* three training steps: each loss within 1e-4 relative;
* fingerprints, search counts and restored checkpoints: exact.

``TrainRunner`` and ``run_spconv_demo`` are checked on their own: a retried
failure and a stop-and-resume both reach a state bit-identical to the
clean run (on the CPU the plain backward is deterministic).
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import checkpoint as jcheckpoint
from repro.core import plan as jplan
from repro.core import spconv as jspconv
from repro.launch import train as jtrain
from repro.launch.spconv_serve import ServeEngine as JServeEngine
from repro.models import minkunet as jminkunet
from repro.optim import adamw as jadamw
from repro.runtime import admission as jadmission, guard as jguard
from repro_torch.checkpoint import checkpoint
from repro_torch.core import plan as planlib
from repro_torch.core import spconv
from repro_torch.data import pointcloud
from repro_torch.kernels.spconv_gemm import ops as sg_ops
from repro_torch.launch import train
from repro_torch.launch.spconv_serve import ServeEngine
from repro_torch.models import minkunet
from repro_torch.optim import adamw
from repro_torch.runtime import admission
from repro_torch.runtime.fault import RunnerConfig, TrainRunner
from tests.proptest import random_cloud

CONFIGS = {
    "demo": dict(stem=8, enc=(8, 16), dec=(16, 8), classes=4, blocks=1),
    "deep": dict(stem=8, enc=(8, 16, 16), dec=(16, 8, 8), classes=4,
                 blocks=2),
}
VOXELS = 384


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and under parallel
    test workers a thread pool per process mostly waits at barriers for
    preempted siblings (a 100x slowdown of the demo tests was measured)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@functools.lru_cache(maxsize=None)
def _jax_params(name: str):
    """Reference init, every BatchNorm bias at -1 (ReLU kills tiles)."""
    cfg = jminkunet.MinkUNetConfig(**CONFIGS[name])
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(functools.partial(
        jminkunet.init_model, cfg))(jax.random.key(0)))

    def perturb(node):
        if isinstance(node, dict) and "var" in node:
            return {**node, "bias": np.full_like(node["bias"], -1.0)}
        if isinstance(node, dict):
            return {k: perturb(v) for k, v in node.items()}
        return node

    return perturb(tree)


def _batch(seed: int = 0, voxels: int = VOXELS, classes: int = 4):
    vb = pointcloud.make_batch(np.random.default_rng(seed), "indoor", 1,
                               voxels)
    b = vb._asdict()
    b["labels"] = np.clip(b["labels"], 0, classes - 1)
    return b


def _model(name: str):
    m = minkunet.MinkUNet(minkunet.MinkUNetConfig(**CONFIGS[name]),
                          device="cpu")
    m.load_state_dict(minkunet.params_from_jax(_jax_params(name)))
    return m


def _port_batch(b):
    return {k: _t(v) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _jax_plans(name, jb):
    return jminkunet.build_plans(jb["coords"], jb["batch"], jb["valid"],
                                 jminkunet.MinkUNetConfig(**CONFIGS[name]))


# ---------------------------------------------------------------------------
# BatchNorm, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_matches_reference(training):
    rng = np.random.default_rng(1)
    n, c = 50, 12
    feats = (rng.standard_normal((n, c)) * 3 + 1).astype(np.float32)
    valid = rng.random(n) < 0.7
    bn = {"scale": rng.uniform(0.5, 1.5, c), "bias": rng.uniform(-1, 1, c),
          "mean": rng.uniform(-1, 1, c), "var": rng.uniform(0.5, 2, c)}
    bn = {k: v.astype(np.float32) for k, v in bn.items()}
    coords = np.zeros((n, 3), np.int32)
    batch = np.zeros((n,), np.int32)
    jst = jspconv.SparseTensor(jnp.asarray(coords), jnp.asarray(batch),
                               jnp.asarray(valid), jnp.asarray(feats))
    want, want_stats = jspconv.batch_norm(
        jst, {k: jnp.asarray(v) for k, v in bn.items()}, training=training)
    st = spconv.SparseTensor(_t(coords), _t(batch), _t(valid), _t(feats))
    got, got_stats = spconv.batch_norm(st, {k: _t(v) for k, v in bn.items()},
                                       training=training)
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats),
                               rtol=0, atol=1e-6)
    assert not np.asarray(want.feats)[~valid].any()
    for k in bn:
        np.testing.assert_allclose(got_stats[k].numpy(),
                                   np.asarray(want_stats[k]), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_segmentation_loss_and_grads_match_reference(name, monkeypatch):
    cfg = jminkunet.MinkUNetConfig(**CONFIGS[name])
    b = _batch()
    jb = _jax_batch(b)
    jparams = jax.tree_util.tree_map(jnp.asarray, _jax_params(name))
    plans = _jax_plans(name, jb)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jminkunet.segmentation_loss(p, jb, cfg, plans=plans,
                                              impl="ref"),
        has_aux=True))(jparams)
    want = minkunet.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           jgrads))

    dead = []
    liveness = sg_ops.tile_liveness

    def counting(tiles, row_nz):
        out = liveness(tiles, row_nz)
        dead.append(int(((tiles.tile_nz != 0) & (out == 0)).sum()))
        return out

    monkeypatch.setattr(sg_ops, "tile_liveness", counting)
    model = _model(name)
    pb = _port_batch(b)
    plans = minkunet.build_plans(pb["coords"], pb["batch"], pb["valid"],
                                 model.cfg, device="cpu")
    params = {k: v.clone() for k, v in model.state_dict().items()}
    loss, aux, grads = train.loss_and_grads(model, params, pb, plans=plans,
                                            impl="ref")
    # ReLU, not the input, kills these tiles: the stem (first sweep) has
    # none, later layers do
    assert dead[0] == 0 and sum(dead[1:]) > 0, dead
    assert _rel(loss, jloss) <= 1e-5
    assert float(aux["acc"]) == pytest.approx(float(jaux["acc"]), abs=1e-6)
    assert set(grads) == set(want)
    gmax = max(float(g.abs().max()) for g in want.values())
    for k, g in grads.items():
        w = want[k].numpy()
        if k.endswith((".mean", ".var")):
            assert not w.any() and not g.any(), k
            continue
        if k.endswith(".conv.b"):
            assert max(float(np.abs(w).max()),
                       float(g.abs().max())) <= 1e-6 * gmax, k
            continue
        scale = float(np.abs(w).max())
        assert scale > 0, k
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * scale, k


def test_training_forward_is_unfused_and_inference_keeps_no_graph():
    """``fused_epilogue`` is an inference form: training ignores it (same
    loss as the unfused model), and inference records no graph."""
    fused = _model("demo")
    fused.cfg = dataclasses.replace(fused.cfg, fused_epilogue=True)
    pb = _port_batch(_batch())
    plans = minkunet.build_plans(pb["coords"], pb["batch"], pb["valid"],
                                 fused.cfg, device="cpu")
    want, _ = minkunet.segmentation_loss(_model("demo"), pb, plans=plans,
                                         impl="ref")
    got, _ = minkunet.segmentation_loss(fused, pb, plans=plans, impl="ref")
    assert torch.equal(got, want) and got.requires_grad
    st = spconv.SparseTensor(pb["coords"], pb["batch"], pb["valid"],
                             pb["feats"])
    assert not fused(st, plans=plans).requires_grad


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_update_matches_reference():
    rng = np.random.default_rng(2)
    tree = _jax_params("demo")
    cfg = dict(lr=1e-3, warmup_steps=2, total_steps=10, clip_norm=0.5)

    def like(scale):
        return jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * scale).astype(
                np.float32), tree)

    grads, m, v = like(1.0), like(0.1), like(0.01)
    v = jax.tree_util.tree_map(np.abs, v)
    state = {"m": m, "v": v, "count": np.int32(3)}
    jp, js, jm = jax.jit(functools.partial(
        jadamw.update, jadamw.AdamWConfig(**cfg)))(
        *(jax.tree_util.tree_map(jnp.asarray, t)
          for t in (grads, state, tree)))
    p, s, met = adamw.update(
        adamw.AdamWConfig(**cfg), minkunet.params_from_jax(grads),
        minkunet.adamw_state_from_jax(state), minkunet.params_from_jax(tree))
    for got, want in ((p, jp), (s["m"], js["m"]), (s["v"], js["v"])):
        want = minkunet.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               want))
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)
    assert int(s["count"]) == int(js["count"]) == 4
    assert s["count"].dtype == torch.int32
    assert _rel(met["grad_norm"], jm["grad_norm"]) <= 1e-6
    assert float(met["lr"]) == pytest.approx(float(jm["lr"]), abs=1e-6)
    assert float(met["grad_norm"]) > 0.5       # the clip was active


def test_adamw_schedule_matches_reference():
    cfg = dict(lr=3e-3, warmup_steps=3, total_steps=10, min_lr_frac=0.2)
    got = [float(adamw.schedule(adamw.AdamWConfig(**cfg),
                                torch.tensor(s, dtype=torch.int32)))
           for s in range(13)]
    want = [float(jadamw.schedule(jadamw.AdamWConfig(**cfg),
                                  jnp.asarray(s, jnp.int32)))
            for s in range(13)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_three_step_losses_match_reference():
    name = "demo"
    jcfg = jminkunet.MinkUNetConfig(**CONFIGS[name])
    opt = dict(lr=1e-3, total_steps=3, warmup_steps=1)
    b = _batch(seed=3)
    jb = _jax_batch(b)
    jparams = jax.tree_util.tree_map(jnp.asarray, _jax_params(name))
    jstep = jtrain.make_spconv_step(jcfg, jadamw.AdamWConfig(**opt),
                                    _jax_plans(name, jb), impl="ref")
    jstate = (jparams, jadamw.init(jparams))
    model = _model(name)
    pb = _port_batch(b)
    plans = minkunet.build_plans(pb["coords"], pb["batch"], pb["valid"],
                                 model.cfg, device="cpu")
    step = train.make_spconv_step(model, adamw.AdamWConfig(**opt), plans,
                                  impl="ref")
    params = {k: v.clone() for k, v in model.state_dict().items()}
    state = (params, minkunet.adamw_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jadamw.init(jparams))))
    for _ in range(3):
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, pb)
        assert _rel(m["loss"], jm["loss"]) <= 1e-4
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), abs=1e-9)


# ---------------------------------------------------------------------------
# Content keys
# ---------------------------------------------------------------------------

def _coords(seed=4, n=200):
    return random_cloud(np.random.default_rng(seed), n, 10)[0]


def _int64_high_words():
    a = np.arange(12, dtype=np.int64) * 7
    b = a.copy()
    b[5] += 1 << 32                    # equal to a mod 2**32
    return [a, b]


FP_CASES = {
    "int32": lambda: [_coords()],
    "bool": lambda: [np.random.default_rng(5).random(97) < 0.5],
    "int64": _int64_high_words,
    "permuted": lambda: [_coords(), _coords()[::-1].copy()],
    "one_voxel_moved": lambda: [_coords(), _coords() + np.eye(
        200, 3, dtype=np.int32)[::-1]],
}


@pytest.mark.parametrize("case", list(FP_CASES))
def test_array_fingerprint_bit_equal_to_reference(case):
    arrays = FP_CASES[case]()
    prev = jax.config.jax_enable_x64
    try:
        jax.config.update("jax_enable_x64", True)
        want = [jplan.array_fingerprint(jnp.asarray(a)) for a in arrays]
    finally:
        jax.config.update("jax_enable_x64", prev)
    got = [planlib.array_fingerprint(torch.from_numpy(a)) for a in arrays]
    assert got == want
    assert got[0][1] == str(arrays[0].dtype)
    if len(arrays) == 2:               # the variant hashes differently
        assert got[0][2:] != got[1][2:]
    assert planlib.content_fingerprint([torch.from_numpy(a)
                                        for a in arrays]) == tuple(want)


def test_float_tensors_are_not_content_keyed():
    assert planlib.array_fingerprint(torch.ones(4)) is None
    assert planlib.content_fingerprint(
        (torch.zeros(3, dtype=torch.int32), torch.ones(3))) is None


def test_content_hit_across_reallocated_tensors_and_miss_on_moved_voxel():
    c, b, v = random_cloud(np.random.default_rng(6), 300, 10)
    cfg = minkunet.MinkUNetConfig(**CONFIGS["demo"])
    cache = planlib.PlanCache(verify=True)
    planlib.reset_mapsearch_counter()
    first = minkunet.build_plans(_t(c), _t(b), _t(v), cfg, cache=cache,
                                 device="cpu")
    again = minkunet.build_plans(_t(c), _t(b), _t(v), cfg, cache=cache,
                                 device="cpu")
    assert planlib.mapsearch_call_count() == 2 * len(cfg.enc) + 1
    assert all(p is q for part, qart in zip(first, again)
               for p, q in zip(part, qart))
    s = cache.stats()
    assert s["content_hits"] > 0 and s["collisions"] == 0
    moved = c.copy()
    moved[np.flatnonzero(v)[0]] += 1
    third = minkunet.build_plans(_t(moved), _t(b), _t(v), cfg, cache=cache,
                                 device="cpu")
    assert planlib.mapsearch_call_count() > 2 * len(cfg.enc) + 1
    assert third.subm[0] is not first.subm[0]


def test_plan_build_hashes_each_level_once(monkeypatch):
    """A fresh cloud costs one fingerprint a level (of that level's
    coordinates, batch and validity), the same tensors again none
    (identity hits), and a re-allocated copy one: its content hits on the
    lookups keyed by the cloud itself, and every lookup of a derived
    coordinate set then hits by identity."""
    c, b, v = random_cloud(np.random.default_rng(8), 100, 8)
    cfg = minkunet.MinkUNetConfig(**CONFIGS["demo"])
    cache = planlib.PlanCache()
    hashed = []
    real = planlib.content_fingerprint
    monkeypatch.setattr(planlib, "content_fingerprint",
                        lambda arrays: hashed.append(arrays) or real(arrays))
    planlib.reset_mapsearch_counter()
    ins = (_t(c), _t(b), _t(v))
    first = minkunet.build_plans(*ins, cfg, cache=cache, device="cpu")
    levels = [ins] + [(d.out_coords, d.out_batch, d.out_valid)
                      for d in first.down]
    assert len(hashed) == len(cfg.enc) + 1
    assert all(x is y for got, want in zip(hashed, levels)
               for x, y in zip(got, want))
    n_lookups = 2 * len(cfg.enc) + 1 + len(cfg.dec)
    assert cache.misses == len(cache) == n_lookups
    again = minkunet.build_plans(*ins, cfg, cache=cache, device="cpu")
    assert len(hashed) == len(cfg.enc) + 1 and cache.id_hits == n_lookups
    copy = minkunet.build_plans(_t(c), _t(b), _t(v), cfg, cache=cache,
                                device="cpu")
    assert len(hashed) == len(cfg.enc) + 2
    # the cloud's own lookups: Subm3 and Gconv2 at level 0, the last Tconv2
    assert cache.content_hits == 3
    assert cache.id_hits == 2 * n_lookups - 3
    assert planlib.mapsearch_call_count() == 2 * len(cfg.enc) + 1
    assert all(p is q is r for xs in zip(first, again, copy)
               for p, q, r in zip(*xs))


def test_shared_coarse_levels_search_as_the_reference():
    """Two clouds that differ in one voxel within its octree parent share
    every level below the finest. The reference's content keys hit on
    those levels, so the second cloud costs two searches (Subm3 and Gconv2
    at level 0); the port counts the same."""
    c, b, v = random_cloud(np.random.default_rng(9), 200, 12)
    occupied = {tuple(x) for x in c[v]}
    i = next(i for i in np.flatnonzero(v)
             if tuple(c[i] ^ np.array([1, 0, 0])) not in occupied)
    moved = c.copy()
    moved[i, 0] ^= 1
    cfg = minkunet.MinkUNetConfig(**CONFIGS["deep"])
    jcfg = jminkunet.MinkUNetConfig(**CONFIGS["deep"])
    cache, jcache = planlib.PlanCache(), jplan.PlanCache(content=True)
    counts, jcounts = [], []
    planlib.reset_mapsearch_counter()
    jplan.reset_mapsearch_counter()
    for coords in (c, moved, c):
        minkunet.build_plans(_t(coords), _t(b), _t(v), cfg, cache=cache,
                             device="cpu")
        jminkunet.build_plans(jnp.asarray(coords), jnp.asarray(b),
                              jnp.asarray(v), jcfg, cache=jcache,
                              replan=False)
        counts.append(planlib.mapsearch_call_count())
        jcounts.append(jplan.mapsearch_call_count())
    full = 2 * len(cfg.enc) + 1
    assert jcounts == [full, full + 2, full + 2]
    assert counts == jcounts


def test_verify_rebuilds_on_a_fingerprint_collision(monkeypatch):
    c, b, v = random_cloud(np.random.default_rng(7), 64, 6)
    cfg = minkunet.MinkUNetConfig(**CONFIGS["demo"])
    cache = planlib.PlanCache(verify=True)
    monkeypatch.setattr(planlib, "content_fingerprint",
                        lambda arrays: (("same",),) * len(arrays))
    minkunet.build_plans(_t(c), _t(b), _t(v), cfg, cache=cache, device="cpu")
    other = c.copy()
    other[np.flatnonzero(v)[0]] += 1
    plans = minkunet.build_plans(_t(other), _t(b), _t(v), cfg, cache=cache,
                                 device="cpu")
    assert cache.collisions > 0
    want = minkunet.build_plans(_t(other), _t(b), _t(v), cfg, device="cpu")
    assert torch.equal(plans.subm[0].kmap, want.subm[0].kmap)


SERVE_JCFG = jminkunet.MinkUNetConfig(name="minkunet-serve-tiny", in_ch=3,
                                      classes=4, stem=8, enc=(8,), dec=(8,),
                                      blocks=1, bm=32)


def _serve_cloud(seed, n):
    coords, batch, valid = random_cloud(np.random.default_rng(seed), n, 12)
    feats = np.random.default_rng(seed + 1000).standard_normal(
        (n, 3)).astype(np.float32)
    return coords, batch, valid, feats


def test_serve_engine_repeated_scene_searches_as_the_reference():
    """A re-submitted scene costs no search in either engine: the port's
    engine keeps one content-keyed cache for its life."""
    a, b = _serve_cloud(20, 30), _serve_cloud(21, 40)
    requests = [("a0", a), ("b0", b), ("a1", a), ("a2", a), ("b1", b)]
    buckets = (48,)
    params = jax.tree_util.tree_map(
        np.asarray, jminkunet.init_model(SERVE_JCFG, jax.random.key(0)))
    with jguard.scoped_health():
        jplan.reset_mapsearch_counter()
        jeng = JServeEngine(params, SERVE_JCFG, impl="ref",
                            queue=jadmission.AdmissionQueue(
                                capacity=16, buckets=buckets, policy=False))
        for rid, cl in requests:
            jeng.submit(rid, *(x.copy() for x in cl))
        jres = {r.rid: r for r in jeng.drain()}
        j_searches = jplan.mapsearch_call_count()
    model = minkunet.MinkUNet(
        minkunet.MinkUNetConfig(**dataclasses.asdict(SERVE_JCFG)),
        device="cpu")
    model.load_state_dict(minkunet.params_from_jax(params))
    planlib.reset_mapsearch_counter()
    eng = ServeEngine(model, device="cpu", queue=admission.AdmissionQueue(
        capacity=16, buckets=buckets))
    for rid, cl in requests:
        eng.submit(rid, *(x.copy() for x in cl))
    res = {r.rid: r for r in eng.drain()}
    assert planlib.mapsearch_call_count() == j_searches \
        == 2 * (2 * len(SERVE_JCFG.enc) + 1)
    assert eng.stats()["cache"]["content_hits"] > 0
    assert all(r.status == "completed" for r in res.values())
    assert res["a0"].digest == res["a1"].digest == res["a2"].digest
    for rid in res:
        np.testing.assert_allclose(res[rid].logits, jres[rid].logits,
                                   rtol=0, atol=1e-4 * max(
                                       1.0, np.abs(jres[rid].logits).max()))


# ---------------------------------------------------------------------------
# Checkpoints and the runner
# ---------------------------------------------------------------------------

def _state():
    model = _model("demo")
    params = {k: v.clone() for k, v in model.state_dict().items()}
    opt = adamw.init(params)
    opt["count"] += 5
    opt["m"]["head.b"] += 0.25
    return params, opt


def _assert_state_equal(a, b):
    la, lb = checkpoint.tree_leaves(a), checkpoint.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_round_trip_and_retention(tmp_path):
    state = _state()
    for step in range(4):
        checkpoint.save(str(tmp_path), step, state, keep=2)
    assert checkpoint.all_steps(str(tmp_path)) == [2, 3]
    zeros = (jax.tree_util.tree_map(torch.zeros_like, state[0]),
             adamw.init(state[0]))
    _assert_state_equal(checkpoint.restore(str(tmp_path), 3, zeros), state)
    t = checkpoint.save(str(tmp_path), 4, state, keep=2, blocking=False)
    t.join(timeout=60)
    assert not t.is_alive() and checkpoint.latest_step(str(tmp_path)) == 4


def test_corrupt_newest_checkpoint_is_skipped_and_refused(tmp_path):
    state = _state()
    checkpoint.save(str(tmp_path), 1, state)
    checkpoint.save(str(tmp_path), 2, state)
    blob = tmp_path / "step-0000000002" / "leaves.npz"
    raw = bytearray(blob.read_bytes())
    raw[len(raw) // 2] ^= 0x10
    blob.write_bytes(bytes(raw))
    assert not checkpoint.verify(str(tmp_path), 2)
    assert checkpoint.latest_step(str(tmp_path)) == 1
    with pytest.raises(ValueError, match="corrupt"):
        checkpoint.restore(str(tmp_path), 2, state)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jparams = jax.tree_util.tree_map(jnp.asarray, _jax_params("demo"))
    jopt = jadamw.init(jparams)
    jopt = {**jopt, "count": jopt["count"] + 7,
            "m": jax.tree_util.tree_map(lambda a: a + 0.5, jopt["m"])}
    jcheckpoint.save(str(tmp_path), 9, (jparams, jopt))
    want = (minkunet.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            jparams)),
            minkunet.adamw_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                 jopt)))
    like = _state()
    assert checkpoint.latest_step(str(tmp_path)) == 9
    _assert_state_equal(checkpoint.restore(str(tmp_path), 9, like), want)


def _toy_runner(tmp_path, **cfg):
    def step(state, batch):
        w = state["w"] * 0.5 + batch
        return {"w": w}, {"loss": float(w.sum())}

    return TrainRunner(RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=1,
                                    keep=2, **cfg),
                       step, lambda s: torch.full((3,), float(s + 1)),
                       {"w": torch.zeros(3)})


def test_runner_retries_to_the_clean_state(tmp_path):
    clean = _toy_runner(tmp_path / "clean")
    clean.run(5)
    fired = set()

    def fail_once(step):
        if step == 2 and step not in fired:
            fired.add(step)
            raise RuntimeError("node lost")

    flaky = _toy_runner(tmp_path / "flaky")
    losses = flaky.run(5, fail_hook=fail_once)
    assert flaky.recoveries == 1 and flaky.skipped_batches == 0
    assert len(losses) == 5 and torch.equal(flaky.state["w"],
                                            clean.state["w"])


def test_runner_skip_budget_and_abort(tmp_path):
    def always(step):
        if step == 1:
            raise RuntimeError("poison batch")

    skip = _toy_runner(tmp_path / "skip", max_retries_per_step=1,
                       max_skipped_batches=1)
    skip.run(3, fail_hook=always)
    assert skip.skipped_batches == 1 and skip.step == 3
    assert skip.recoveries == 2
    abort = _toy_runner(tmp_path / "abort", max_retries_per_step=1,
                        max_skipped_batches=0)
    with pytest.raises(RuntimeError, match="skip budget"):
        abort.run(3, fail_hook=always)
    assert abort.recoveries == 2


# ---------------------------------------------------------------------------
# The demo
# ---------------------------------------------------------------------------

def test_demo_searches_once_per_geometry():
    res = train.run_spconv_demo(3, device="cpu")
    assert res["mapsearch_calls"] == res["searches_per_cloud"] == 5
    assert res["cache"]["content_hits"] > 0 and res["compiled_steps"] == 1
    assert res["recoveries"] == 0 and len(res["losses"]) == 3
    assert all(np.isfinite(res["losses"]))
    assert len(res["timings"]) == 3 and len(res["save_ms"]) == 5
    fresh = train.run_spconv_demo(2, replay=False, device="cpu")
    assert fresh["mapsearch_calls"] == 2 * fresh["searches_per_cloud"]
    assert fresh["compiled_steps"] == 2


def test_demo_resume_reaches_the_uninterrupted_digest(tmp_path):
    full = train.run_spconv_demo(4, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    part = train.run_spconv_demo(2, total_steps=4, ckpt_dir=ckpt,
                                 device="cpu")
    assert part["state_digest"] != full["state_digest"]
    assert os.path.isdir(ckpt)
    rest = train.run_spconv_demo(4, total_steps=4, ckpt_dir=ckpt,
                                 resume=True, device="cpu")
    assert rest["resumed_from"] == 2 and len(rest["losses"]) == 2
    assert rest["losses"] == full["losses"][2:]
    assert rest["state_digest"] == full["state_digest"]
