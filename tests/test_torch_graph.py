"""The serving engine's per-bucket executables and the graph helper on
the CPU, against the JAX package.

* ``split_plans`` of the port's ``MinkPlans`` against the reference's on
  the same quantized request: a tensor leaf for each of the reference's
  arrays, with the same shape and dtype, in the same order, but the
  reference's ``ConvPlan.overflow`` (a bool scalar each Subm3 plan carries
  and the port's ``ConvPlan`` lacks); the same Python values; two
  geometries of one bucket give one skeleton, two buckets two;
  ``merge_plans`` gives back the plans leaf for leaf.
* ``tests/test_serving.py``'s replay (two geometries in each of two
  buckets, each submitted twice) through the port's engine and the
  reference's: ``compiled`` is 2 on both, as is ``serve.compile``, and
  the port's repeats are bit-equal to their first serving.
* ``runtime/graph.Graph`` refuses a device that is not CUDA, and
  ``launch_counts`` reads every kernel module's ``COUNTERS``.

The graphs themselves run only on the card (``tests/test_torch_gpu.py``,
phase ``serve`` of ``chip_smoke.py``).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.launch import spconv_serve as jserve
from repro.models import minkunet as jminkunet
from repro.runtime import admission as jadmission, guard as jguard
from repro_torch.launch import spconv_serve
from repro_torch.models import minkunet
from repro_torch.runtime import admission, graph, guard
from tests.proptest import random_cloud

JCFG = jminkunet.MinkUNetConfig(name="minkunet-serve-tiny", in_ch=3,
                                classes=4, stem=8, enc=(8,), dec=(8,),
                                blocks=1, bm=32)
CFG = minkunet.MinkUNetConfig(**dataclasses.asdict(JCFG))
BUCKETS = (48, 96)


def _cloud(seed: int, n: int):
    coords, batch, valid = random_cloud(np.random.default_rng(seed), n, 12)
    feats = np.random.default_rng(seed + 1000).standard_normal(
        (n, CFG.in_ch)).astype(np.float32)
    return coords, batch, valid, feats


def _request(cl):
    """The request as the queue quantizes it into its bucket."""
    req = admission.AdmissionQueue(buckets=BUCKETS).submit("r", *cl)
    assert isinstance(req, admission.Request)
    return req


def _port_plans(req):
    return minkunet.build_plans(req.coords, req.batch, req.valid, CFG,
                                n_max=req.bucket, device="cpu")


def _ref_plans(req):
    return jminkunet.build_plans(
        jnp.asarray(req.coords), jnp.asarray(req.batch),
        jnp.asarray(req.valid), JCFG, n_max=req.bucket)


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


def test_split_plans_matches_reference_and_merge_round_trips():
    small_a, small_b = _request(_cloud(10, 30)), _request(_cloud(12, 40))
    big = _request(_cloud(11, 70))
    assert small_a.bucket == small_b.bucket != big.bucket
    skeletons = []
    for req in (small_a, small_b, big):
        plans = _port_plans(req)
        dyn, treedef, static, skel = spconv_serve.split_plans(plans)
        jplans = _ref_plans(req)
        jdyn, _, jstatic, _ = jserve.split_plans(jplans)
        paths = [jax.tree_util.keystr(k) for k, _ in
                 jax.tree_util.tree_flatten_with_path(jplans)[0]]
        tensors = [d for d in dyn if d is not None]
        arrays = [d for d, k in zip(jdyn, paths) if d is not None
                  and not (k.endswith("].overflow") and ".maps" not in k)]
        assert len(arrays) == sum(d is not None for d in jdyn) \
            - len(CFG.enc) - 1                     # one a Subm3 plan
        assert len(tensors) == len(arrays) > 0
        assert [(tuple(t.shape), _dt(t.dtype)) for t in tensors] == \
            [(tuple(a.shape), str(a.dtype)) for a in arrays]
        # the Python values, in the same order: kinds, budgets, tap counts
        assert [s for s in static if s is not None] == \
            [s for s in jstatic if s is not None]
        back = spconv_serve.merge_plans(treedef, static, dyn)
        assert type(back) is type(plans)
        got = spconv_serve.split_plans(back)
        assert got[3] == skel
        assert all(a is b for a, b in zip(got[0], dyn))
        skeletons.append(skel)
    hash(skeletons[0])
    assert skeletons[0] == skeletons[1] != skeletons[2]


@functools.lru_cache(maxsize=1)
def _jparams():
    return jminkunet.init_model(JCFG, jax.random.key(0))


def test_compiled_equals_bucket_classes_as_the_reference():
    """``tests/test_serving.py``'s one-executable-per-bucket replay."""
    small, big = _cloud(10, 30), _cloud(11, 70)
    subs = [("s0", small), ("b0", big), ("s1", small), ("b1", big)]
    model = minkunet.MinkUNet(CFG, device="cpu")
    model.load_state_dict(minkunet.params_from_jax(
        jax.tree_util.tree_map(np.asarray, _jparams())))
    port = spconv_serve.ServeEngine(
        model, device="cpu", max_batch=4,
        queue=admission.AdmissionQueue(buckets=BUCKETS))
    ref = jserve.ServeEngine(
        _jparams(), JCFG, impl="ref", max_batch=4,
        queue=jadmission.AdmissionQueue(buckets=BUCKETS))
    notes = []
    for eng, g in ((port, guard), (ref, jguard)):
        with g.scoped_health() as h:
            for rid, cl in subs:
                eng.submit(rid, *(a.copy() for a in cl))
            results = eng.drain()
            notes.append(h.get("serve.compile"))
        assert [r.status for r in results] == ["completed"] * 4
    assert port.compiled == ref.compiled == 2
    assert port.stats()["compiled"] == 2
    assert notes == [2, 2]
    digests = {r.rid: r.digest for r in port.results}
    assert digests["s0"] == digests["s1"] and digests["b0"] == digests["b1"]


def test_graph_refuses_a_cpu_device():
    with pytest.raises(ValueError, match="CUDA device"):
        graph.Graph(lambda x: x, "cpu")


def test_launch_counts_cover_every_kernel_counter():
    counts = graph.launch_counts()
    names = {(mod.__name__.split(".")[-2], c) for mod, c in counts}
    assert names >= {("octent", "launches"), ("octent", "row_launches"),
                     ("spconv_gemm", "launches"),
                     ("spconv_gemm", "plan_launches"),
                     ("spconv_gemm", "reduce_launches"),
                     ("flash_attention", "launches"),
                     ("masked_matmul", "launches"),
                     ("segment_sum", "launches")}
    for (mod, c), n in counts.items():
        assert getattr(mod, c) == n and isinstance(n, int)
