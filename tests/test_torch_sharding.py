"""Parity of the port's sharded OCTENT search and device mesh against the
JAX package.

The port runs one process a rank of a ``torch.distributed`` group (gloo
on the CPU here), spawned by ``launch.spconv_sharded.spawn_ranks``, one
spawn a mesh shape: ``(2,)`` data, ``(4,)`` model and ``(2, 2)`` data x
model. On the clouds of the reference's ``test_sharded_parity_multiway``
(uniform, grid limit, one block, all invalid; seeds 0-1) every rank's
kmap and ``n_blocks`` are bit-equal to ``repro``'s single-device
``build_kmap(impl="ref")``, and ``bounds``, ``tbounds``, each rank's
slices and the ``(S, N, K)`` partials to the reference's
``build_query_table_sharded`` / ``octent_query_sharded`` called with an
explicit ``mesh=`` (the reference's ``impl="sharded"`` dispatch resolves
the active mesh as an ``AbstractMesh`` and is served by its guard's
fallback on jax 0.9, so the port is never held to it). The reference runs
in one subprocess with 4 host devices (``tests.proptest.run_script``) and
hands its arrays over as an ``.npz``.

Also held: the axis helpers and fingerprints (off-mesh, ``pod`` dropped,
one shape over other ranks), the configuration errors, ``search_impl()``'s
``auto`` on 1-way and 2-way meshes, each rank holding only ``n_pad/S``
table slots and ``mb/S`` directory entries, the routing (one answering rank
a stage, the owner of ``bounds`` / ``tbounds``), PlanCache and pinned-table
keys carrying the mesh term, an overflowing sharded plan and its replan at
the reference's budgets, and MinkUNet under ``(2, 2)``: flat searches,
logits within 1e-4 of the reference's meshless forward, and ``apply_tiles``
gradients on a sharded plan equal to a single-device plan's.
"""
from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import plan as jplan
from repro.core.spconv import SparseTensor as JSparseTensor
from repro.data import pointcloud as jpointcloud
from repro.kernels.octent import ops as joct_ops
from repro.models import minkunet as jminkunet
from repro.runtime import guard as jguard
from repro_torch.core import morton
from repro_torch.core import plan as planlib
from repro_torch.core.spconv import SparseTensor
from repro_torch.core.stream import StreamSession
from repro_torch.kernels.octent import ops as oct_ops
from repro_torch.kernels.octent import sharded
from repro_torch.kernels.octent.ref import encode_queries
from repro_torch.launch.spconv_sharded import make_mesh, spawn_ranks
from repro_torch.launch.spconv_stream import CONFIGS
from repro_torch.models import minkunet
from repro_torch.runtime import fault, feature_cache, guard, sharding
from tests.proptest import random_cloud, run_script

N = 120            # the reference test's cloud size
MESHES = {"data2": ((2,), ("data",)), "model4": ((4,), ("model",)),
          "data_model": ((2, 2), ("data", "model"))}
MINK_CFG = dict(stem=8, enc=(8, 16), dec=(16, 8), classes=4, blocks=2)
OVERFLOW_ROWS = 200    # a row count no other test's replan memo uses


def _clouds():
    out = []
    for seed in range(2):
        rng = np.random.default_rng(seed)
        out += [
            ("uniform", random_cloud(rng, N, extent=40, batch=2)),
            ("grid_limit", random_cloud(rng, N, extent=16, batch=2,
                                        origin=2048 - 16)),
            ("one_block", random_cloud(rng, N, extent=14, batch=1)),
            ("all_invalid", random_cloud(rng, N, extent=30, batch=2,
                                         n_valid=0)),
        ]
    return out


_REF_SCRIPT = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core import morton
from repro.kernels.octent import ops as oct_ops, sharded
from tests.proptest import random_cloud

N = {n}
clouds = []
for seed in range(2):
    rng = np.random.default_rng(seed)
    clouds += [
        random_cloud(rng, N, extent=40, batch=2),
        random_cloud(rng, N, extent=16, batch=2, origin=2048 - 16),
        random_cloud(rng, N, extent=14, batch=1),
        random_cloud(rng, N, extent=30, batch=2, n_valid=0),
    ]
offs = jnp.asarray(morton.subm3_offsets())
out = {{}}
for i, cloud in enumerate(clouds):
    c, b, v = map(jnp.asarray, cloud)
    km, nb = oct_ops.build_kmap(c, b, v, max_blocks=N, impl="ref")
    out[f"ref_{{i}}_kmap"] = np.asarray(km)
    out[f"ref_{{i}}_nb"] = np.asarray(nb)
keys = ("ublocks", "tkey", "tval", "bounds", "tbounds", "kmap", "nb",
        "pranks", "partials")


def sharded_arrays(c, b, v, mesh):
    sqt = sharded.build_query_table_sharded(c, b, v, max_blocks=N,
                                            mesh=mesh)
    res = sharded.octent_query_sharded(c, b, v, offs, sqt, mesh=mesh,
                                       return_partials=True)
    return (sqt.ublocks, sqt.tkey, sqt.tval, sqt.bounds, sqt.tbounds) + res


for tag, (shape, names) in {meshes!r}.items():
    nd = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:nd]).reshape(shape), names)
    # one trace a mesh: every cloud has N rows
    fn = jax.jit(lambda c, b, v: sharded_arrays(c, b, v, mesh))
    for i, cloud in enumerate(clouds):
        for k, a in zip(keys, fn(*map(jnp.asarray, cloud))):
            out[f"{{tag}}_{{i}}_{{k}}"] = np.asarray(a)
np.savez({path!r}, **out)
print("REF_SHARDED_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's single-device and explicit-``mesh=`` sharded
    arrays of every cloud and mesh."""
    path = str(tmp_path_factory.mktemp("ref") / "sharded.npz")
    out = run_script(_REF_SCRIPT.format(n=N, meshes=MESHES, path=path),
                     n_devices=4)
    assert "REF_SHARDED_OK" in out
    with np.load(path) as z:
        return dict(z)


def _spawn(tmp_path_factory, fn, world, *args):
    init = str(tmp_path_factory.mktemp("rdv") / "init")
    return spawn_ranks(fn, world, backend="gloo", init_file=init, args=args,
                       timeout_s=240)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# The rank bodies (module level: spawned processes unpickle them by name)
# ---------------------------------------------------------------------------

def _parity(mesh, clouds) -> list:
    """Every cloud under ``mesh``: the kmap through ``build_kmap``'s
    dispatch, then the table and the partials through the module's own
    functions."""
    offs = torch.as_tensor(morton.subm3_offsets())
    out = []
    with sharding.set_mesh(mesh):
        impl = oct_ops.search_impl()
        for c, b, v in clouds:
            c, b, v = _t(c), _t(b), _t(v)
            km, nb = oct_ops.build_kmap(c, b, v, max_blocks=N)
            sqt = sharded.build_query_table_sharded(c, b, v, max_blocks=N)
            km2, nb2, pr, pa = sharded.octent_query_sharded(
                c, b, v, offs, sqt, return_partials=True)
            out.append({"impl": impl, "kmap": km.numpy(), "nb": int(nb),
                        "kmap2": km2.numpy(), "nb2": int(nb2),
                        "ublocks": sqt.ublocks.numpy(),
                        "tkey": sqt.tkey.numpy(), "tval": sqt.tval.numpy(),
                        "bounds": sqt.bounds.numpy(),
                        "tbounds": sqt.tbounds.numpy(),
                        "shard": sqt.shard, "n_shards": sqt.n_shards,
                        "pranks": pr.numpy(), "partials": pa.numpy()})
    return out


def _rank_data2(rank, clouds, budgets_cloud):
    mesh = make_mesh((2,), ("data",))
    res = {"parity": _parity(mesh, clouds)}
    pod_model = make_mesh((1, 2), ("pod", "model"))
    pod = make_mesh((2,), ("pod",))
    one = [make_mesh((1,), ("data",), ranks=[r]) for r in range(2)]
    res["fp"] = {"off": sharding.mesh_fingerprint(),
                 "data2": sharding.mesh_fingerprint(mesh),
                 "pod_model": sharding.mesh_fingerprint(pod_model),
                 "one": [sharding.mesh_fingerprint(m) for m in one]}
    res["axes"] = {"off": (sharding.blockkey_axes(),
                           sharding.blockkey_shards()),
                   "pod_model": (sharding.blockkey_axes(pod_model),
                                 sharding.blockkey_shards(pod_model))}
    with sharding.set_mesh(mesh):
        res["axes"]["data2"] = (sharding.blockkey_axes(),
                                sharding.blockkey_shards(),
                                sharding.active_axes(),
                                sharding.axis_size("data"),
                                sharding.axis_size("model"))
        res["auto2"] = oct_ops.search_impl()
    with sharding.set_mesh(one[rank]):
        res["auto1"] = oct_ops.search_impl()
    c, b, v = map(_t, clouds[0])
    with sharding.set_mesh(pod):
        try:
            oct_ops.build_kmap(c, b, v, max_blocks=N, impl="sharded")
        except ValueError as e:
            res["pod_error"] = str(e)

    # the plan cache and the pinned table key on the mesh
    cache = planlib.PlanCache(pinned=feature_cache.PinnedStore())
    with sharding.set_mesh(one[0]):
        pa = planlib.subm3_plan(c, b, v, max_blocks=N, bm=8,
                                search_impl="ref", cache=cache)
        fp = planlib.content_fingerprint((c, b, v))
        res["pinned"] = (("qtable", fp, N, 7, 4,
                          sharding.mesh_fingerprint()) in cache.pinned,
                         ("qtable", fp, N, 7, 4) in cache.pinned)
    with sharding.set_mesh(one[1]):
        pb = planlib.subm3_plan(c, b, v, max_blocks=N, bm=8,
                                search_impl="ref", cache=cache)
    with sharding.set_mesh(one[0]):
        pc = planlib.subm3_plan(c, b, v, max_blocks=N, bm=8,
                                search_impl="ref", cache=cache)
    res["cache"] = (pb is not pa, pc is pa, cache.misses, cache.hits)
    sess = StreamSession(CONFIGS["tiny"], 64, device="cpu")
    with sharding.set_mesh(mesh):
        res["stream_pin"] = (sess._pin_key(("fp",), 64)[-1],
                             sharding.mesh_fingerprint())

    # a sharded plan that overflows its directory, then its replan
    c, b, v = map(_t, budgets_cloud)
    with sharding.set_mesh(mesh):
        try:
            planlib.subm3_plan(c, b, v, max_blocks=2, bm=8,
                               search_impl="sharded")
        except planlib.CapacityOverflow as e:
            res["overflow"] = (e.needed, e.capacity)
        seen = []

        def build(mb):
            seen.append(mb)
            return planlib.subm3_plan(c, b, v, max_blocks=mb, bm=8)

        with guard.scoped_health() as h:
            plan = guard.with_replan(build, 2)
            res["replan"] = (seen, h.snapshot(), plan.kmap.numpy())

    # a search fault planted on rank 1 alone fires twice, the fallback
    # chain on: both searches fail on both ranks, the third serves both
    os.environ["REPRO_GUARD_FALLBACK"] = "1"
    c, b, v = map(_t, clouds[0])
    plan = fault.FaultPlan(schedule={"search": [0, 1]}) if rank else None
    res["fault"] = []
    with sharding.set_mesh(mesh), guard.scoped_health() as h, \
            fault.inject(plan):
        for _ in range(3):
            try:
                km, _ = oct_ops.build_kmap(c, b, v, max_blocks=N)
                res["fault"].append(km.numpy())
            except Exception as e:          # noqa: BLE001
                res["fault"].append(type(e).__name__)
        res["fault_health"] = h.snapshot()
    del os.environ["REPRO_GUARD_FALLBACK"]
    return res


def _rank_parity(rank, shape, names, clouds):
    return {"parity": _parity(make_mesh(shape, names), clouds)}


def _rank_data_model(rank, clouds, state, mink_clouds, grad_case):
    mesh = make_mesh((2, 2), ("data", "model"))
    res = {"parity": _parity(mesh, clouds)}
    cfg = minkunet.MinkUNetConfig(**MINK_CFG)
    model = minkunet.MinkUNet(cfg, device="cpu")
    model.load_state_dict(state)
    sts = [SparseTensor(*map(_t, cl)) for cl in mink_clouds]
    planlib.reset_mapsearch_counter()
    with sharding.set_mesh(mesh):
        outs = minkunet.forward_multicloud(model, sts)
    res["searches"] = planlib.mapsearch_call_count()
    res["logits"] = [o.numpy() for o in outs]

    c, b, v, feats, w, bias = map(_t, grad_case)
    n = c.shape[0]
    plan_ref = planlib.subm3_plan(c, b, v, max_blocks=n, bm=8,
                                  search_impl="kernel")
    with sharding.set_mesh(mesh):
        plan_sh = planlib.subm3_plan(c, b, v, max_blocks=n, bm=8)
    res["plan_kmaps"] = (plan_ref.kmap.numpy(), plan_sh.kmap.numpy())
    grads = []
    for plan in (plan_ref, plan_sh):
        args = [t.clone().requires_grad_() for t in (feats, w, bias)]
        (planlib.execute(plan, *args) ** 2).sum().backward()
        grads.append([a.grad.numpy() for a in args])
    res["grads"] = grads
    return res


# ---------------------------------------------------------------------------
# The spawns, one a mesh shape
# ---------------------------------------------------------------------------

def _budget_cloud():
    return random_cloud(np.random.default_rng(0), OVERFLOW_ROWS, extent=40,
                        batch=2)


@pytest.fixture(scope="module")
def data2(tmp_path_factory):
    clouds = [cl for _, cl in _clouds()]
    return _spawn(tmp_path_factory, _rank_data2, 2, clouds, _budget_cloud())


@pytest.fixture(scope="module")
def model4(tmp_path_factory):
    clouds = [cl for _, cl in _clouds()]
    return _spawn(tmp_path_factory, _rank_parity, 4, (4,), ("model",),
                  clouds)


def _mink_reference():
    """The reference test's small MinkUNet, its two indoor clouds and its
    meshless logits; the gradient case of its VJP check."""
    cfg = jminkunet.MinkUNetConfig(**MINK_CFG)
    params = jminkunet.init_model(cfg, jax.random.key(0))
    rng = np.random.default_rng(2)
    clouds, logits = [], []
    for _ in range(2):
        vb = jpointcloud.make_batch(rng, "indoor", batch_size=1,
                                    max_voxels=128)
        cl = (vb.coords, vb.batch, vb.valid, vb.feats)
        clouds.append(cl)
        logits.append(np.asarray(jminkunet.forward(
            params, JSparseTensor(*map(jnp.asarray, cl)), cfg, impl="ref")))
    state = minkunet.params_from_jax(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(3)
    n, cin, cout = 40, 8, 12
    c, b, v = random_cloud(rng, n, extent=14, batch=2)
    feats = rng.standard_normal((n, cin)).astype(np.float32)
    w = (rng.standard_normal((27, cin, cout)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    return state, clouds, logits, (c, b, v, feats, w, bias)


@pytest.fixture(scope="module")
def data_model(tmp_path_factory):
    clouds = [cl for _, cl in _clouds()]
    state, mink_clouds, logits, grad_case = _mink_reference()
    ranks = _spawn(tmp_path_factory, _rank_data_model, 4, clouds, state,
                   mink_clouds, grad_case)
    return ranks, logits


def _ranks(request, tag):
    got = request.getfixturevalue(tag)
    return got[0] if tag == "data_model" else got


# ---------------------------------------------------------------------------
# Off-mesh and in-process
# ---------------------------------------------------------------------------

def test_axis_helpers_off_mesh():
    assert sharding.get_mesh() is None
    assert sharding.active_axes() == ()
    assert sharding.axis_size("data") == 1
    assert sharding.blockkey_axes() == ()
    assert sharding.blockkey_shards() == 1
    assert sharding.mesh_fingerprint() == ()
    assert sharding.SHARD_AXES == ("data", "model")


def test_search_impl_names():
    """Off-mesh the automatic rule keeps kernel 1 (the meshes' cases are
    in ``test_search_impl_auto_one_way_and_two_way``)."""
    assert oct_ops.search_impl() == "kernel"


@pytest.mark.parametrize("fallback", ["0", "1"])
def test_sharded_without_a_mesh_raises_before_dispatch(monkeypatch,
                                                       fallback):
    """The configuration error reaches the caller even with the fallback
    chain on: nothing is dispatched, so nothing is served by ``ref``."""
    monkeypatch.setenv("REPRO_GUARD_FALLBACK", fallback)
    c, b, v = map(_t, random_cloud(np.random.default_rng(0), 32, extent=20))
    with guard.scoped_health() as h:
        with pytest.raises(ValueError, match="needs an active device mesh"):
            oct_ops.build_kmap(c, b, v, max_blocks=32, impl="sharded")
        with pytest.raises(ValueError, match="needs an active device mesh"):
            planlib.subm3_plan(c, b, v, max_blocks=32,
                               search_impl="sharded")
        assert h.snapshot() == {}
    with pytest.raises(ValueError, match="builds its own search structure"):
        oct_ops.build_kmap(c, b, v, max_blocks=32, impl="sharded",
                           table=oct_ops.build_query_table(c, b, v,
                                                           max_blocks=32))
    assert "sharded" not in guard.FALLBACK_CHAINS["search"]


def test_owner_shard_is_a_lower_bound():
    bounds = torch.tensor([3, 10, 20, 2 ** 31 - 1], dtype=torch.int32)
    keys = torch.tensor([3, 9, 10, 19, 20, 2 ** 30], dtype=torch.int32)
    assert sharded.owner_shard(bounds, keys).tolist() == [0, 0, 1, 1, 2, 2]


# ---------------------------------------------------------------------------
# Against the reference, every mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", list(MESHES))
def test_kmaps_bit_equal_to_single_device_reference(request, ref, tag):
    ranks = _ranks(request, tag)
    s_n = int(np.prod(MESHES[tag][0]))
    assert len(ranks) == s_n
    for rank in ranks:
        for i, r in enumerate(rank["parity"]):
            assert r["impl"] == "sharded"
            for km, nb in ((r["kmap"], r["nb"]), (r["kmap2"], r["nb2"])):
                np.testing.assert_array_equal(km, ref[f"ref_{i}_kmap"],
                                              err_msg=f"{tag} cloud {i}")
                assert nb == int(ref[f"ref_{i}_nb"])


@pytest.mark.parametrize("tag", list(MESHES))
def test_tables_and_partials_bit_equal_to_reference(request, ref, tag):
    """Each rank's slices are its range of the reference's padded arrays,
    and only that range: ``mb/S`` directory entries, ``n_pad/S`` slots."""
    ranks = _ranks(request, tag)
    s_n = len(ranks)
    seen = set()
    for rank in ranks:
        for i, r in enumerate(rank["parity"]):
            s = r["shard"]
            assert r["n_shards"] == s_n
            seen.add(s)
            for k in ("ublocks", "tkey", "tval"):
                full = ref[f"{tag}_{i}_{k}"]
                size = full.shape[0] // s_n
                assert r[k].shape == (size,)
                np.testing.assert_array_equal(
                    r[k], full[s * size:(s + 1) * size], err_msg=f"{k} {i}")
            for k in ("bounds", "tbounds", "pranks", "partials"):
                np.testing.assert_array_equal(r[k], ref[f"{tag}_{i}_{k}"],
                                              err_msg=f"{tag} {k} {i}")
    assert seen == set(range(s_n))


@pytest.mark.parametrize("tag", list(MESHES))
def test_routing_one_answer_from_the_owner(request, tag):
    r0 = _ranks(request, tag)[0]["parity"]
    offs = torch.as_tensor(morton.subm3_offsets())
    for (_, (c, b, v)), r in zip(_clouds(), r0):
        pr, pa, km = r["pranks"], r["partials"], r["kmap"]
        hit = km >= 0
        assert ((pa >= 0).sum(0) == hit).all()
        assert ((pr >= 0).sum(0) <= 1).all()
        inb, bkey, bank, row = encode_queries(_t(c), _t(b), _t(v), offs,
                                              grid_bits=7)
        own1 = sharded.owner_shard(_t(r["bounds"]), bkey).numpy()
        dir_hit = (pr >= 0).any(0)
        assert (np.argmax(pr >= 0, 0)[dir_hit] == own1[dir_hit]).all()
        key2 = (pr.max(0) * morton.TABLE_SIZE
                + bank.numpy() * morton.BANK_ROWS + row.numpy())
        own2 = sharded.owner_shard(_t(r["tbounds"]), _t(key2)).numpy()
        assert (np.argmax(pa >= 0, 0)[hit] == own2[hit]).all()


# ---------------------------------------------------------------------------
# Mesh state, keys, overflow: the (2,) data spawn
# ---------------------------------------------------------------------------

def test_axis_helpers_and_fingerprints_on_meshes(data2):
    for rank, r in enumerate(data2):
        assert r["axes"]["off"] == ((), 1)
        assert r["axes"]["data2"] == (("data",), 2, ("data",), 2, 1)
        assert r["axes"]["pod_model"] == (("model",), 2)
        fp = r["fp"]
        assert fp["off"] == ()
        assert fp["data2"] == (("data", 2), (0, 1))
        assert fp["pod_model"] == (("pod", 1), ("model", 2), (0, 1))
        # one shape over other ranks: another fingerprint
        assert fp["one"] == [(("data", 1), (0,)), (("data", 1), (1,))]


def test_search_impl_auto_one_way_and_two_way(data2):
    for r in data2:
        assert r["auto1"] == "kernel"
        assert r["auto2"] == "sharded"


def test_pod_only_mesh_has_nothing_to_partition(data2):
    for r in data2:
        assert "nothing to partition" in r["pod_error"]


def test_plan_cache_and_pinned_key_carry_the_mesh(data2):
    for r in data2:
        assert r["pinned"] == (True, False)
        missed_other_mesh, hit_again, misses, hits = r["cache"]
        assert missed_other_mesh and hit_again and (misses, hits) == (2, 1)


def test_stream_pin_key_carries_the_mesh(data2):
    sess = StreamSession(CONFIGS["tiny"], 64, device="cpu")
    assert sess._pin_key(("fp",), 64)[-1] == () == sharding.mesh_fingerprint()
    assert sess._pin_key(None, 64) is None
    for r in data2:
        key_term, fp = r["stream_pin"]
        assert key_term == fp == (("data", 2), (0, 1))


def test_sharded_overflow_and_replan_at_the_reference_budgets(data2):
    c, b, v = map(jnp.asarray, _budget_cloud())
    jseen = []

    def jbuild(mb):
        jseen.append(mb)
        return jplan.subm3_plan(c, b, v, max_blocks=mb, bm=8,
                                search_impl="ref")

    with jguard.scoped_health() as jh:
        jp = jguard.with_replan(jbuild, 2)
        jhealth = jh.snapshot()
    needed = int(joct_ops.build_kmap(c, b, v, max_blocks=OVERFLOW_ROWS,
                                     impl="ref")[1])
    assert needed > 2
    for r in data2:
        assert r["overflow"] == (needed, 2)
        seen, health, kmap = r["replan"]
        assert seen == jseen == [2, needed]
        assert health == jhealth == {"replan.overflow": 1,
                                     "replan.recovered": 1}
        np.testing.assert_array_equal(kmap, np.asarray(jp.kmap))


def test_fault_on_one_rank_fails_the_search_on_every_rank(ref, data2):
    """A ``search`` fault planted on rank 1 alone, with the fallback chain
    on: no rank retries, quarantines or serves ``ref`` by itself. Both
    faulted searches raise on both ranks (rank 1 its InjectedFault), and
    the next one gives both the single-device kmap."""
    for rank, r in enumerate(data2):
        first, second, third = r["fault"]
        want = "InjectedFault" if rank else "RuntimeError"
        assert [f if isinstance(f, str) else "a kmap"
                for f in (first, second)] == [want, want]
        np.testing.assert_array_equal(third, ref["ref_0_kmap"])
        assert r["fault_health"] == ({"fault.search": 2} if rank else {})
# ---------------------------------------------------------------------------

def test_minkunet_under_data_model_mesh(data_model):
    ranks, logits = data_model
    per_cloud = len(MINK_CFG["enc"]) + len(MINK_CFG["enc"]) + 1
    for r in ranks:
        assert r["searches"] == per_cloud * len(logits)
        for got, want in zip(r["logits"], logits):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        for got, rank0 in zip(r["logits"], ranks[0]["logits"]):
            np.testing.assert_array_equal(got, rank0)


def test_apply_tiles_grads_on_a_sharded_plan(data_model):
    ranks, _ = data_model
    for r in ranks:
        np.testing.assert_array_equal(*r["plan_kmaps"])
        for a, b_ in zip(*r["grads"]):
            np.testing.assert_allclose(a, b_, rtol=1e-5, atol=1e-6)
