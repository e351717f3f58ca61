"""Parity of the port's serving slice (repro_torch) against the JAX package.

The same tiny MinkUNet (the serving tests' config) with the same parameters
— the reference's init carried across by ``params_from_jax``, batch-norm
statistics perturbed so that the folding is exercised — serves the same
requests over two padding buckets through both ``ServeEngine``s. Logits
agree per request within 1e-4 of their scale (float32 summation order
differs through 5 layers), statuses agree, and each fresh geometry costs
2E+1 map searches in both. The fused-epilogue forward matches the unfused
one within the same bound.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import pytest
import torch

from repro.core import plan as jplan
from repro.launch.spconv_serve import ServeEngine as JServeEngine
from repro.models import minkunet as jminkunet
from repro.runtime import admission as jadmission, guard as jguard
from repro_torch.core import plan as planlib
from repro_torch.core.spconv import SparseTensor
from repro_torch.kernels.octent import kernel as oct_kernel
from repro_torch.kernels.spconv_gemm import kernel as sg_kernel
from repro_torch.launch.spconv_serve import ServeEngine
from repro_torch.models import minkunet
from repro_torch.runtime import admission
from tests.proptest import random_cloud

JCFG = jminkunet.MinkUNetConfig(name="minkunet-serve-tiny", in_ch=3,
                                classes=4, stem=8, enc=(8,), dec=(8,),
                                blocks=1, bm=32)
CFG = minkunet.MinkUNetConfig(**dataclasses.asdict(JCFG))
BUCKETS = (48, 96)
SEARCHES_PER_GEOM = 2 * len(CFG.enc) + 1
TOL = 1e-4


@functools.lru_cache(maxsize=1)
def _jax_params():
    tree = jax.tree_util.tree_map(
        np.asarray, jminkunet.init_model(JCFG, jax.random.key(0)))
    rng = np.random.default_rng(0)

    def perturb(node):
        if isinstance(node, dict) and "var" in node:
            c = node["var"].shape[0]
            return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": rng.uniform(-0.2, 0.2, c).astype(np.float32),
                    "mean": rng.uniform(-0.2, 0.2, c).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
        if isinstance(node, dict):
            return {k: perturb(v) for k, v in node.items()}
        return node

    return perturb(tree)


def _model(cfg=CFG):
    m = minkunet.MinkUNet(cfg, device="cpu")
    m.load_state_dict(minkunet.params_from_jax(_jax_params()))
    return m


def _cloud(seed: int, n: int):
    coords, batch, valid = random_cloud(np.random.default_rng(seed), n, 12)
    feats = np.random.default_rng(seed + 1000).standard_normal(
        (n, CFG.in_ch)).astype(np.float32)
    return coords, batch, valid, feats


REQUESTS = [("s0", _cloud(10, 30)), ("b0", _cloud(11, 70)),
            ("s1", _cloud(12, 40)), ("big", _cloud(13, 120))]


def _close(a, b):
    scale = max(1.0, float(np.abs(b).max()))
    assert float(np.abs(a - b).max()) <= TOL * scale


def test_params_from_jax_names_match_state_dict():
    sd = minkunet.params_from_jax(_jax_params())
    assert set(sd) == set(_model().state_dict())
    assert "enc0.block0.bn.var" in sd and "head.w" in sd
    assert sd["stem.conv.w"].shape == (27, CFG.in_ch, CFG.stem)


def test_serve_engine_matches_reference():
    with jguard.scoped_health():
        jplan.reset_mapsearch_counter()
        jeng = JServeEngine(_jax_params(), JCFG, impl="ref",
                            queue=jadmission.AdmissionQueue(
                                capacity=16, buckets=BUCKETS, policy=False))
        for rid, cl in REQUESTS:
            jeng.submit(rid, *cl)
        jres = {r.rid: r for r in jeng.drain()}
        j_searches = jplan.mapsearch_call_count()

    planlib.reset_mapsearch_counter()
    eng = ServeEngine(_model(), device="cpu",
                      queue=admission.AdmissionQueue(capacity=16,
                                                     buckets=BUCKETS))
    for rid, cl in REQUESTS:
        eng.submit(rid, *cl)
    res = {r.rid: r for r in eng.drain()}
    assert planlib.mapsearch_call_count() == j_searches \
        == 3 * SEARCHES_PER_GEOM

    assert {k: (r.status, r.reason, r.bucket) for k, r in res.items()} == \
        {k: (r.status, r.reason, r.bucket) for k, r in jres.items()}
    assert res["big"].status == "rejected" and res["big"].reason == "oversize"
    for rid in ("s0", "b0", "s1"):
        assert res[rid].status == "completed"
        assert res[rid].logits.shape == jres[rid].logits.shape
        _close(res[rid].logits, jres[rid].logits)
    s = eng.stats()
    assert s["completed"] == 3 and s["rejected"] == 1
    assert s["latency_p50_s"] is not None


def test_fused_epilogue_forward_matches_unfused():
    c, b, v, f = REQUESTS[1][1]
    st = SparseTensor(torch.from_numpy(c), torch.from_numpy(b),
                      torch.from_numpy(v), torch.from_numpy(f))
    plans = minkunet.build_plans(st.coords, st.batch, st.valid, CFG,
                                 device="cpu")
    want = minkunet.forward(_model(), st, plans=plans)
    fused = _model(dataclasses.replace(CFG, fused_epilogue=True))
    got = minkunet.forward(fused, st, plans=plans)
    _close(got.numpy(), want.numpy())


def test_cpu_path_launches_no_kernel():
    """On CPU tensors the wrappers take the plain versions and count no
    launch (the counters count CUDA kernel launches only)."""
    oct_kernel.launches = sg_kernel.launches = 0
    c, b, v, f = REQUESTS[0][1]
    st = SparseTensor(*(torch.from_numpy(a) for a in (c, b, v, f)))
    out = _model()(st)
    assert out.shape == (30, CFG.classes) and torch.isfinite(out).all()
    assert oct_kernel.launches == 0 and sg_kernel.launches == 0


def test_large_config_copied_exactly():
    for port, ref in ((minkunet.LARGE, jminkunet.LARGE),
                      (minkunet.SMALL, jminkunet.SMALL)):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("kind", ["lidar", "indoor"])
def test_pointcloud_generator_matches_reference(kind):
    from repro.data import pointcloud as jpc
    from repro_torch.data import pointcloud
    got = pointcloud.make_batch(np.random.default_rng(3), kind, 2, 4096)
    want = jpc.make_batch(np.random.default_rng(3), kind, 2, 4096)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_forward_multicloud_matches_single_forwards():
    model = _model()
    clouds = [SparseTensor(*(torch.from_numpy(a) for a in REQUESTS[i][1]))
              for i in (0, 2)]
    planlib.reset_mapsearch_counter()
    outs = minkunet.forward_multicloud(model, clouds)
    assert planlib.mapsearch_call_count() == 2 * SEARCHES_PER_GEOM
    for st, out in zip(clouds, outs):
        assert torch.equal(out, model(st))
