"""Parity of the port's SECOND / Gconv3 slice (repro_torch) against the JAX
package.

The same numpy inputs go through both packages on the CPU, the port with
the plain versions of its kernels (``impl="ref"``, or the kernel wrappers'
CPU branch) and the reference's weights carried across by
``params_from_jax``.

* Integer outputs are bit-equal: the Gconv3 scatter maps (with ``n_true``
  and ``overflow``), the Gconv3 plans' kmaps, tiles and output sets, the
  tap tiles of a Gconv3 kmap against the reference's under both of its
  binning modes, the budgets ``with_replan`` tries, and the map-search
  counts.
* ``apply_maps_scatter`` and its gradients: within 1e-5 of ``jax.vjp``.
* ``gconv3``, both dataflows: within the reference's 1e-4 of the
  reference and of each other.
* SECOND at a reduced config (channels (8, 8, 16), two blocks a stage,
  ``bev_hw`` 32, the reference test's widths): ``middle_extractor``,
  ``to_bev`` and ``rpn_head`` within 1e-4 of max |out|, the BEV holding
  the features' mass; ``detection_loss`` within 1e-5 relative and each
  gradient within 1e-4 of its own max |g|. Conv biases that feed a
  training BatchNorm have a gradient that is zero in exact arithmetic:
  both sides below 1e-6 of the model's largest |g|; the BatchNorm
  statistics get exactly zero.

The capacity memo of ``with_replan`` is process-wide in both packages, so
every test that counts searches or budgets uses row counts that no other
test uses.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import mapsearch as jmapsearch
from repro.core import plan as jplan
from repro.core import rulebook as jrulebook
from repro.core import spconv as jspconv
from repro.core import validate as jvalidate
from repro.data import pointcloud as jpointcloud
from repro.kernels.spconv_gemm import ops as jsg_ops
from repro.models import second as jsecond
from repro.runtime import guard as jguard
from repro_torch.core import mapsearch, plan as planlib, rulebook, spconv
from repro_torch.kernels.spconv_gemm import ops as sg_ops
from repro_torch.models import second
from repro_torch.runtime import guard
from tests.proptest import random_cloud

CFG_KW = dict(channels=(8, 8, 16), blocks=2, bev_hw=32, bev_z=4, head_ch=16,
              n_batch=2)
#: rows of the SECOND scenes (each test its own, used by no other test)
SCENE_ROWS = {"ref": 997, None: 999, "loss": 1001}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


def _cloud(seed, n, extent, batch=2, n_valid=None):
    c, b, v = random_cloud(np.random.default_rng(seed), n, extent, batch,
                           n_valid=n_valid)
    return c, b, v


def _assert_maps_equal(jm, m):
    for f in m._fields:
        a, t = np.asarray(getattr(jm, f)), getattr(m, f).numpy()
        assert a.dtype == t.dtype and np.array_equal(a, t), f


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and under parallel
    test workers a thread pool per process mostly waits at barriers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# Gconv3 maps, plans and the capacity replan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("budget", [None, 1, 17, 60, 200])
def test_build_maps_gconv3_bit_equal(seed, budget):
    """Every field, ``n_true`` and ``overflow`` included, at budgets that
    overflow (1, 17, and 60 for most seeds), that fit, and at the full 8N
    candidate space."""
    c, b, v = _cloud(seed, 60, 14, n_valid=50)
    jm = jmapsearch.build_maps_gconv3(jnp.asarray(c), jnp.asarray(b),
                                      jnp.asarray(v), out_budget=budget)
    m = mapsearch.build_maps_gconv3(_t(c), _t(b), _t(v), out_budget=budget)
    _assert_maps_equal(jm, m)
    if budget == 1:
        assert bool(m.overflow) and int(m.n_true) > 1


def test_unique_pairs_truncates_as_the_reference():
    """Fewer unique slots than keys: the representatives past ``size`` are
    dropped, and the ranks of their inputs stay at or past ``size``."""
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 40, 200).astype(np.int32)
    lo = rng.integers(0, 4096, 200).astype(np.int32)
    valid = rng.random(200) < 0.8
    for size in (1, 7, 64, 1600):
        want = jmapsearch.unique_pairs(jnp.asarray(hi), jnp.asarray(lo),
                                       jnp.asarray(valid), size, hi_bits=25)
        got = mapsearch.unique_pairs(_t(hi), _t(lo), _t(valid), size)
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w), g.numpy()), size


def test_single_odd_voxel_overflows_as_the_reference():
    """One voxel at odd coordinates reaches 8 downsampled sites: the
    default budget of 1 raises with needed 8, capacity 1, in both."""
    c = np.ones((1, 3), np.int32)
    b = np.zeros((1,), np.int32)
    v = np.ones((1,), bool)
    with pytest.raises(jvalidate.CapacityOverflow) as jei:
        jplan.gconv3_plan(jnp.asarray(c), jnp.asarray(b), jnp.asarray(v))
    with pytest.raises(planlib.CapacityOverflow, match="overflow") as ei:
        planlib.gconv3_plan(_t(c), _t(b), _t(v))
    assert ei.value.what == jei.value.kind == "candidates"
    assert ei.value.needed == jei.value.needed == 8
    assert ei.value.capacity == jei.value.capacity == 1
    plan = planlib.gconv3_plan(_t(c), _t(b), _t(v), out_budget=8)
    assert int(plan.out_valid.sum()) == 8


@pytest.mark.parametrize("with_tiles", [True, False])
def test_gconv3_plan_bit_equal(with_tiles):
    """kmap, tiles, output set and maps bit-equal, one search each; a plan
    without tiles refuses the fused execution in both packages."""
    c, b, v = _cloud(4, 80, 10, n_valid=70)
    j0, p0 = jplan.MAPSEARCH_CALLS[0], planlib.MAPSEARCH_CALLS[0]
    jp = jplan.gconv3_plan(jnp.asarray(c), jnp.asarray(b), jnp.asarray(v),
                           out_budget=240, bm=16, bo=32,
                           with_tiles=with_tiles)
    p = planlib.gconv3_plan(_t(c), _t(b), _t(v), out_budget=240, bm=16,
                            bo=32, with_tiles=with_tiles)
    assert jplan.MAPSEARCH_CALLS[0] - j0 == planlib.MAPSEARCH_CALLS[0] - p0 \
        == 1
    assert (p.kind, p.n_out, p.n_taps) == (jp.kind, jp.n_out, jp.n_taps)
    for name in ("kmap", "out_coords", "out_batch", "out_valid"):
        assert np.array_equal(np.asarray(getattr(jp, name)),
                              getattr(p, name).numpy()), name
    _assert_maps_equal(jp.maps, p.maps)
    assert not bool(jp.overflow) and not bool(p.maps.overflow)
    if with_tiles:
        for f in p.tiles._fields[:-1]:
            assert np.array_equal(np.asarray(getattr(jp.tiles, f)),
                                  getattr(p.tiles, f).numpy()), f
        assert p.tiles.bo == jp.tiles.bo
        return
    assert p.tiles is None and jp.tiles is None
    f = np.ones((80, 3), np.float32)
    w = np.ones((27, 3, 4), np.float32)
    with pytest.raises(ValueError, match="with_tiles=False"):
        jplan.execute(jp, jnp.asarray(f), jnp.asarray(w), impl="ref")
    with pytest.raises(ValueError, match="with_tiles=False"):
        planlib.execute(p, _t(f), _t(w), impl="ref")
    # the tap scan reads the kmap only, so it runs
    assert planlib.execute(p, _t(f), _t(w), impl="scan").shape == (240, 4)


def _record_budgets(monkeypatch, module):
    seen = []
    build = module.gconv3_plan

    def recording(*args, **kw):
        seen.append(kw["out_budget"])
        return build(*args, **kw)

    monkeypatch.setattr(module, "gconv3_plan", recording)
    return seen


@pytest.mark.parametrize("dataflow", ["output_stationary",
                                      "input_stationary"])
def test_with_replan_budgets_and_searches_as_the_reference(dataflow,
                                                           monkeypatch):
    """A sparse cloud overflows its row budget: the first call probes at
    the rows and rebuilds at the true output count (two searches), the
    second starts at the memoized budget (one search), in both."""
    n = 41 if dataflow == "output_stationary" else 43
    c, b, v = _cloud(5, n, 40, n_valid=n - 3)
    f = np.random.default_rng(5).standard_normal((n, 3)).astype(np.float32)
    w = np.random.default_rng(6).standard_normal((27, 3, 5)).astype(
        np.float32)
    jst = jspconv.SparseTensor(*(jnp.asarray(a) for a in (c, b, v, f)))
    st = spconv.SparseTensor(*(_t(a) for a in (c, b, v, f)))
    jseen = _record_budgets(monkeypatch, jplan)
    seen = _record_budgets(monkeypatch, planlib)
    jcounts, counts = [], []
    for _ in range(2):
        j0, p0 = jplan.MAPSEARCH_CALLS[0], planlib.MAPSEARCH_CALLS[0]
        jout, _ = jspconv.gconv3(jst, {"w": jnp.asarray(w),
                                       "b": jnp.zeros(5)},
                                 dataflow=dataflow, impl="ref")
        out, _ = spconv.gconv3(st, _t(w), torch.zeros(5), dataflow=dataflow,
                               impl="ref")
        jcounts.append(jplan.MAPSEARCH_CALLS[0] - j0)
        counts.append(planlib.MAPSEARCH_CALLS[0] - p0)
    needed = seen[1]
    assert needed > n and seen == jseen == [n, needed, needed]
    assert counts == jcounts == [2, 1]
    assert out.feats.shape[0] == needed == int(out.valid.sum())
    key = ("gconv3", n, 7, 4, dataflow)
    assert guard._CAPACITY_HINTS[key] == jguard._CAPACITY_HINTS[key] == needed
    np.testing.assert_allclose(_np(out.feats), np.asarray(jout.feats),
                               rtol=1e-4, atol=1e-4)


def test_replan_off_and_retries_spent_raise(monkeypatch):
    c, b, v = _cloud(7, 47, 40)
    st = spconv.SparseTensor(_t(c), _t(b), _t(v), torch.ones(47, 2))
    monkeypatch.setenv("REPRO_GUARD_REPLAN", "0")
    assert guard.replan_retries() == jguard.replan_retries() == 0
    with pytest.raises(planlib.CapacityOverflow):
        spconv.gconv3(st, torch.ones(27, 2, 3), None, impl="ref")
    monkeypatch.delenv("REPRO_GUARD_REPLAN")
    assert guard.replan_retries() == 6

    def always(cap):
        raise planlib.CapacityOverflow("candidates", "overflow",
                                       needed=10 * cap, capacity=cap)

    def jalways(cap):
        raise jvalidate.CapacityOverflow("candidates", "overflow",
                                         needed=10 * cap, capacity=cap)

    with guard.scoped_health() as h, jguard.scoped_health() as jh:
        for retries in (0, 2):
            with pytest.raises(planlib.CapacityOverflow):
                guard.with_replan(always, 8, retries=retries)
            with pytest.raises(jvalidate.CapacityOverflow):
                jguard.with_replan(jalways, 8, retries=retries)
        assert h.snapshot() == jh.snapshot() == {"replan.overflow": 2}


# ---------------------------------------------------------------------------
# Execution: the input-stationary scatter, both Gconv3 dataflows, tiles
# ---------------------------------------------------------------------------

def test_apply_maps_scatter_and_vjp_match_reference():
    c, b, v = _cloud(8, 90, 12, n_valid=80)
    rng = np.random.default_rng(8)
    f = rng.standard_normal((90, 6)).astype(np.float32)
    w = rng.standard_normal((27, 6, 7)).astype(np.float32)
    bias = rng.standard_normal(7).astype(np.float32)
    jm = jmapsearch.build_maps_gconv3(jnp.asarray(c), jnp.asarray(b),
                                      jnp.asarray(v), out_budget=300)
    m = mapsearch.build_maps_gconv3(_t(c), _t(b), _t(v), out_budget=300)
    g = rng.standard_normal((300, 7)).astype(np.float32)
    want, vjp = jax.vjp(
        lambda ff, ww, bb: jrulebook.apply_maps_scatter(
            ff, ww, jm, bb, n_out=300, n_taps=27),
        jnp.asarray(f), jnp.asarray(w), jnp.asarray(bias))
    wants = vjp(jnp.asarray(g))
    ts = [_t(a).requires_grad_() for a in (f, w, bias)]
    got = rulebook.apply_maps_scatter(*ts[:2], m, ts[2], n_out=300,
                                      n_taps=27)
    got.backward(_t(g))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    assert not _np(got)[~m.out_valid.numpy()].any()
    for t, wv in zip(ts, wants):
        wv = np.asarray(wv)
        np.testing.assert_allclose(t.grad.numpy(), wv, rtol=0,
                                   atol=1e-5 * float(np.abs(wv).max()))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("impl", ["ref", None])
def test_gconv3_dataflows_match_reference_and_each_other(seed, impl):
    """Both dataflows against the reference's, at budgets that fit (the
    rows of a dense cloud) and that replan (a sparse one); ``impl=None``
    goes through the kernel wrapper, which runs its plain version on CPU
    tensors."""
    n, extent = (53, 6) if seed == 0 else (59, 30)
    n += 2 * (impl is None)                  # rows no other test uses
    c, b, v = _cloud(10 + seed, n, extent, n_valid=n - 4)
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n, 5)).astype(np.float32)
    f[~v] = 0.0
    w = rng.standard_normal((27, 5, 9)).astype(np.float32)
    bias = rng.standard_normal(9).astype(np.float32)
    jst = jspconv.SparseTensor(*(jnp.asarray(a) for a in (c, b, v, f)))
    st = spconv.SparseTensor(*(_t(a) for a in (c, b, v, f)))
    outs = {}
    for df in ("output_stationary", "input_stationary"):
        jout, _ = jspconv.gconv3(jst, {"w": jnp.asarray(w),
                                       "b": jnp.asarray(bias)},
                                 dataflow=df, impl="ref", bm=16)
        out, maps = spconv.gconv3(st, _t(w), _t(bias), dataflow=df,
                                  impl=impl, bm=16)
        for name in ("coords", "batch", "valid"):
            assert np.array_equal(np.asarray(getattr(jout, name)),
                                  getattr(out, name).numpy()), name
        want = np.asarray(jout.feats)
        np.testing.assert_allclose(_np(out.feats), want, rtol=1e-4,
                                   atol=1e-4)
        outs[df] = _np(out.feats)
    np.testing.assert_allclose(outs["output_stationary"],
                               outs["input_stationary"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("seed", [12, 13])
@pytest.mark.parametrize("binning", ["counting", "argsort"])
def test_build_tap_tiles_matches_both_reference_binnings(seed, binning):
    """The port's one layout of a Gconv3 kmap is the reference's under
    either ordering pass, its counting radix and its global argsort."""
    c, b, v = _cloud(seed, 70, 9, n_valid=64)
    jm = jmapsearch.build_maps_gconv3(jnp.asarray(c), jnp.asarray(b),
                                      jnp.asarray(v), out_budget=140)
    kmap = jmapsearch.strided_to_kmap(jm, n_out=140, n_taps=27)
    jt = jsg_ops.build_tap_tiles(kmap, bm=16, bo=32, binning=binning)
    t = sg_ops.build_tap_tiles(_t(kmap), bm=16, bo=32)
    for f in t._fields[:-1]:
        assert np.array_equal(np.asarray(getattr(jt, f)),
                              getattr(t, f).numpy()), f


# ---------------------------------------------------------------------------
# SECOND
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_tree(bn_bias: float | None):
    """Reference init at the reduced config; BatchNorm statistics
    perturbed (``bn_bias`` None) or every BatchNorm bias set to it."""
    cfg = jsecond.SECONDConfig(**CFG_KW)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jsecond.init_model(cfg, jax.random.key(1)))
    rng = np.random.default_rng(0)

    def perturb(node):
        if isinstance(node, dict) and "var" in node:
            c = node["var"].shape[0]
            if bn_bias is not None:
                return {**node, "bias": np.full(c, bn_bias, np.float32)}
            return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": rng.uniform(-0.2, 0.2, c).astype(np.float32),
                    "mean": rng.uniform(-0.1, 0.1, c).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
        if isinstance(node, dict):
            return {k: perturb(v) for k, v in node.items()}
        return node

    return perturb(tree)


def _scene(rows):
    vb = jpointcloud.make_batch(np.random.default_rng(0), "lidar", 2, rows,
                                voxel_size=0.15)
    return {k: np.asarray(v) for k, v in vb._asdict().items()}


def _model(bn_bias=None):
    model = second.SECOND(second.SECONDConfig(**CFG_KW), device="cpu")
    model.load_state_dict(second.params_from_jax(_jax_tree(bn_bias)))
    return model


def test_second_params_from_jax_fill_the_state_dict():
    model = second.SECOND(second.SECONDConfig(**CFG_KW), device="cpu")
    sd = model.state_dict()
    got = second.params_from_jax(_jax_tree(None))
    assert set(got) == set(sd)
    assert all(got[k].shape == sd[k].shape for k in sd)
    hwio = _jax_tree(None)["rpn"]["conv1"]
    assert np.array_equal(got["rpn.conv1"][:, :, 2, 0].numpy(),
                          hwio[2, 0].T)


@pytest.mark.parametrize("impl", ["ref", None])
def test_second_forward_matches_reference(impl):
    """``middle_extractor``, ``to_bev`` and ``rpn_head`` at 1e-4 of their
    max |out|, the output sets bit-equal, the BEV holding the sparse
    features' mass, and equal search counts: 6 searches and one probe,
    since the scene's stage-0 Gconv3 overflows its row budget and
    replans in both packages."""
    jcfg = jsecond.SECONDConfig(**CFG_KW)
    jp = jax.tree_util.tree_map(jnp.asarray, _jax_tree(None))
    b = _scene(SCENE_ROWS[impl])
    keys = ("coords", "batch", "valid", "feats")
    j0 = jplan.MAPSEARCH_CALLS[0]
    jmid = jsecond.middle_extractor(
        jp, jsecond.SparseTensor(*(jnp.asarray(b[k]) for k in keys)), jcfg,
        impl="ref")
    jsearch = jplan.MAPSEARCH_CALLS[0] - j0
    jbev = jsecond.to_bev(jmid, jcfg)
    jcls, jbox = jsecond.rpn_head(jp["rpn"], jbev)

    model = _model()
    st = spconv.SparseTensor(*(_t(b[k]) for k in keys))
    p0 = planlib.MAPSEARCH_CALLS[0]
    with torch.no_grad():
        mid = second.middle_extractor(model, st, impl=impl)
    assert planlib.MAPSEARCH_CALLS[0] - p0 == jsearch
    assert jsearch == 7
    for name in ("coords", "batch", "valid"):
        assert np.array_equal(np.asarray(getattr(jmid, name)),
                              getattr(mid, name).numpy()), name
    bev = second.to_bev(mid, model.cfg)
    cls, box = second.rpn_head(model.rpn, bev)
    for got, want in ((mid.feats, jmid.feats), (bev, jbev), (cls, jcls),
                      (box, jbox)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))
    assert float(np.abs(np.asarray(jcls)).max()) > 0
    np.testing.assert_allclose(float(mid.feats[mid.valid].sum()),
                               float(bev.sum()), rtol=1e-5)
    got_cls, got_box = second.forward(model, st, impl=impl)
    assert torch.equal(got_cls, cls) and torch.equal(got_box, box)


def test_detection_loss_and_grads_match_reference():
    """Value and every gradient against ``jax.value_and_grad`` of the
    reference's ``detection_loss``, with every BatchNorm bias at -1 so
    that the ReLUs kill whole tiles."""
    jcfg = jsecond.SECONDConfig(**CFG_KW)
    b = _scene(SCENE_ROWS["loss"])
    rng = np.random.default_rng(1)
    obj = (rng.random((2, 32, 32)) < 0.1).astype(np.float32)
    boxes = rng.standard_normal((2, 32, 32, 7)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jb.update(objectness=jnp.asarray(obj), boxes=jnp.asarray(boxes))
    jp = jax.tree_util.tree_map(jnp.asarray, _jax_tree(-1.0))
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jsecond.detection_loss(p, jb, jcfg), has_aux=True)(jp)
    want = second.params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))

    model = _model(-1.0)
    pb = {k: _t(v) for k, v in b.items()}
    pb.update(objectness=_t(obj), boxes=_t(boxes))
    loss, aux, grads = second.loss_and_grads(model, pb, impl="ref")
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for k in ("cls", "box"):
        assert abs(float(aux[k]) - float(jaux[k])) <= 1e-5 * abs(
            float(jaux[k]))
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
    # the discarded running statistics: the model's buffers are unchanged
    sd = model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in
               second.params_from_jax(_jax_tree(-1.0)).items()
               if k.endswith((".mean", ".var")))
