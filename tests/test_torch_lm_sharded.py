"""The LM's tensor sharding over a ``torch.distributed`` mesh on the CPU,
against the port's single-device path and the JAX package.

One gloo spawn of four ranks (``launch/spconv_sharded.spawn_ranks``), a
module fixture as in ``tests/test_torch_sharding.py``, at reduced configs
(float32; TinyLlama at two layers), parameters placed by
``launch.shardings.param_shardings`` and ``distribute``; each rank on one
thread:

* TinyLlama's ``make_train_step`` on a (2, 2) ``data`` x ``model`` mesh and
  on a (1, 4) one, where its 2 KV heads are replicated beside 4 sharded q
  heads (the reference's "GQA trap": each rank takes the KV head of its q
  head). Loss within rtol 2e-3 and parameters within 3e-2 of the port's
  single-device step and of the reference's jitted one, the reference's
  own ``test_sharded_train_step_matches_single_device`` bounds; the
  errors reached are far tighter (the test asserts 1e-5 against the port
  and prints them). ``grad_norm`` (AdamW's ``global_norm`` over DTensor
  shards, reduced from ``Partial``) within 1e-6 relative of one device's.
* Prefill logits under either mesh within 1e-5 of the meshless ones.
* Mixtral's MoE feed-forward at capacity factor 1.25 (copies drop)
  under the (2, 2) mesh: ``set_moe_impl
  ("shard_map")`` equals ``einsum`` and the meshless function (output,
  aux metrics, every gradient), with x replicated over ``model`` (and,
  for ``shard_map``, sharded on D over it, as a sharded norm weight
  leaves it), and the routing run on each rank's local
  rows gives ``gather_tok`` bit-equal to one device's and ``slot_gate``
  with the same zeros, its values within 2 float32 ulp (ROADMAP §3 item
  4).
* ``checkpoint.restore(shardings=)`` gives each rank its shards of a saved
  state bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.checkpoint import checkpoint
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import shardings
from repro_torch.launch.spconv_sharded import spawn_ranks
from repro_torch.launch.train import make_train_step
from repro_torch.models import api, moe, transformer
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as rs

MESHES = {"data_model": (2, 2), "model4": (1, 4)}
BATCH, SEQ = 8, 32
#: TinyLlama's reduced depth: two layers have a seam between layers, and
#: each layer more costs the ranks a few dozen collectives a step
LAYERS = 2


def _full(x):
    return x.full_tensor() if rs.is_dtensor(x) else x


def _lm_rank(flat, batch, mesh_shape):
    """TinyLlama single-device and under ``mesh_shape``: the step's loss,
    grad norm and new parameters, and the prefill logits."""
    cfg = dataclasses.replace(
        configs.get_config("tinyllama-1.1b").reduced(), n_layers=LAYERS)
    model = api.build_model(cfg, device="cpu")
    step = make_train_step(model, adamw.AdamWConfig())
    out = {}
    if mesh_shape is None:
        params, mesh = flat, None
        opt, b = adamw.init(params), batch
    else:
        mesh = meshlib.make_test_mesh(*mesh_shape)
        opt = adamw.init(flat)
        params = shardings.distribute(
            flat, shardings.param_shardings(flat, mesh))
        opt = shardings.distribute(opt, shardings.opt_state_shardings(
            opt, mesh))
        b = shardings.distribute(batch, shardings.batch_shardings(
            batch, mesh))
        out["placements"] = {k: tuple(p.placements)
                             for k, p in params.items()}
    with rs.set_mesh(mesh):
        (p, _), m = step((params, opt), b)
        logits, _ = model.prefill(model.nest(params), b, SEQ)
    out.update(loss=float(_full(m["loss"])),
               grad_norm=float(_full(m["grad_norm"])),
               params={k: _full(v) for k, v in p.items()},
               logits=_full(logits))
    return out


def _moe_rank(mparams, x, ct):
    """Mixtral's MoE layer meshless and under (2, 2) with both
    dispatches: output, metrics and gradients; and the local routing."""
    # capacity 1.25 (the served one): copies drop, as at full size
    cfg = dataclasses.replace(configs.get_config("mixtral-8x7b").reduced(),
                              capacity_factor=1.25)
    mesh = meshlib.make_test_mesh(2, 2)
    res = {}

    def run(params, xx, cc, impl, m):
        moe.set_moe_impl(impl)
        try:
            leaves = {k: v.detach().requires_grad_() for k, v in
                      params.items()}
            xl = xx.detach().requires_grad_()
            with rs.set_mesh(m):
                out, met = moe.moe_ffn(leaves, xl, cfg)
                obj = (out * cc).sum() + 0.5 * met["moe_aux"]
                grads = torch.autograd.grad(obj, [xl, *leaves.values()])
        finally:
            moe.set_moe_impl("einsum")
        return {"out": _full(out).detach(),
                "aux": float(_full(met["moe_aux"])),
                "drop": float(_full(met["moe_drop_frac"])),
                "grads": [_full(g) for g in grads]}

    res["meshless"] = run(mparams, x, ct, "einsum", None)
    psh = shardings.param_shardings(mparams, mesh)
    dp = shardings.distribute(mparams, psh)
    bsh = shardings.batch_shardings({"x": x, "ct": ct}, mesh)
    dx = shardings.place(x, bsh["x"])
    dct = shardings.place(ct, bsh["ct"])
    for impl in ("einsum", "shard_map"):
        res[impl] = run(dp, dx, dct, impl, mesh)
    # x sharded on D over 'model', as a sharded norm weight leaves it
    dxd = shardings.place(x, shardings.Sharding(
        ("data", None, "model"), rs.placements(("data", None, "model"),
                                               mesh), mesh))
    res["shard_map_d"] = run(dp, dxd, dct, "shard_map", mesh)
    # the routing on each rank's local rows vs one device's
    e, k = cfg.n_experts, cfg.top_k
    cap = moe.capacity(cfg, x.shape[1])
    with rs.set_mesh(mesh):
        logits = dx.float() @ dp["router"]
        tok, gate, dropped = moe._routing(dx, logits, k, e, cap)
    res["routing"] = [_full(t) for t in (tok, gate, dropped)]
    res["routing_ref"] = list(moe._dispatch_one(
        x, x.float() @ mparams["router"], k, e, cap))
    return res


def _restore_rank(ckpt_dir, flat):
    """Each rank's shards of the saved parameters, and the slices of the
    full tensors they must equal."""
    mesh = meshlib.make_test_mesh(2, 2)
    psh = shardings.param_shardings(flat, mesh)
    like = {k: torch.zeros_like(v) for k, v in flat.items()}
    got = checkpoint.restore(ckpt_dir, 1, like, shardings=psh)
    return {k: (got[k].to_local(), shardings._local(flat[k], psh[k]),
                tuple(got[k].placements) == psh[k].placements)
            for k in flat}


def _rank(rank, flat, batch, mparams, x, ct, ckpt_dir):
    # tiny tensors and a collective every few ops: intra-op threads only
    # contend with the other ranks
    torch.set_num_threads(1)
    out = {}
    for name, shape in MESHES.items():
        out[name] = _lm_rank(flat, batch, shape)
    out["moe"] = _moe_rank(mparams, x, ct)
    out["restore"] = _restore_rank(ckpt_dir, flat)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    # the JAX package is imported here, not by the module, which the
    # spawned ranks import
    import jax
    from repro import configs as jconfigs
    from repro.launch import train as jtrain
    from repro.models import api as japi
    from repro.models import transformer as jtransformer
    from repro.optim import adamw as jadamw
    cfg = dataclasses.replace(
        configs.get_config("tinyllama-1.1b").reduced(), n_layers=LAYERS)
    jcfg = dataclasses.replace(
        jconfigs.get_config("tinyllama-1.1b").reduced(), n_layers=LAYERS)
    jparams = jtransformer.init_lm(jcfg, jax.random.key(0))
    flat = transformer.lm_params_from_jax(jax.tree.map(np.asarray, jparams))
    batch = {k: torch.as_tensor(v) for k, v in TokenStream(
        vocab=cfg.vocab, batch=BATCH, seq=SEQ, seed=0).batch_at(0).items()}
    # the reference's single-device jitted step on the same weights/batch
    jstep = jax.jit(jtrain.make_train_step(japi.build_model(jcfg),
                                           jadamw.AdamWConfig()))
    (jp, _), jm = jstep((jparams, jadamw.init(jparams)),
                        {k: v.numpy() for k, v in batch.items()})
    ref = {"loss": float(jm["loss"]),
           "params": transformer.lm_params_from_jax(
               jax.tree.map(np.asarray, jp))}
    mcfg = configs.get_config("mixtral-8x7b").reduced()
    gen = torch.Generator().manual_seed(3)
    mparams = moe.init_moe(gen, mcfg, torch.float32)
    rng = np.random.default_rng(4)
    # a shared component crowds the experts it favours
    x = torch.from_numpy((rng.standard_normal((4, 24, mcfg.d_model))
                          + 1.5 * rng.standard_normal(mcfg.d_model))
                         .astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt"))
    checkpoint.save(ckpt_dir, 1, flat)
    init = str(tmp_path_factory.mktemp("rdv") / "init")
    outs = spawn_ranks(_rank, 4, backend="gloo", init_file=init,
                       args=(flat, batch, mparams, x, ct, ckpt_dir),
                       timeout_s=240)
    assert not dist.is_initialized()
    # the single-device step once, here, not on every rank
    return {"ranks": outs, "ref": ref, "flat": flat,
            "single": _lm_rank(flat, batch, None)}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _maxdiff(a: dict, b: dict) -> float:
    return max(float((a[k].float() - torch.as_tensor(b[k]).float())
                     .abs().max()) for k in b)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_train_step_matches_single_device(run, mesh_name):
    ref, single = run["ref"], run["single"]
    for r in run["ranks"]:
        got = r[mesh_name]
        # the reference's bounds, against the port and the reference
        assert _rel(got["loss"], single["loss"]) <= 2e-3
        assert _rel(got["loss"], ref["loss"]) <= 2e-3
        assert _maxdiff(got["params"], single["params"]) <= 3e-2
        assert _maxdiff(got["params"], ref["params"]) <= 3e-2
        # what they reach
        err = (_rel(got["loss"], single["loss"]),
               _maxdiff(got["params"], single["params"]),
               _rel(got["loss"], ref["loss"]),
               _maxdiff(got["params"], ref["params"]))
        print(f"{mesh_name}: loss rel {err[0]:.2e} params {err[1]:.2e} "
              f"vs the port; {err[2]:.2e} / {err[3]:.2e} vs the reference")
        assert err[0] <= 1e-5 and err[1] <= 1e-5
        assert _rel(got["grad_norm"], single["grad_norm"]) <= 1e-6
    # the placements are the rules': q/k/v column-sharded, wo row-sharded
    from torch.distributed.tensor import Replicate, Shard
    pl = run["ranks"][0][mesh_name]["placements"]
    assert pl["layers.0.attn.wq"] == (Replicate(), Shard(1))
    assert pl["layers.0.attn.wo"] == (Replicate(), Shard(0))
    assert pl["layers.0.ln1.w"] == (Replicate(), Shard(0))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_prefill_logits_match_meshless(run, mesh_name):
    want = run["single"]["logits"]
    for r in run["ranks"]:
        got = r[mesh_name]["logits"]
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-5


def test_moe_shard_map_equals_einsum(run):
    for r in run["ranks"]:
        m = r["moe"]
        base = m["meshless"]
        for impl in ("einsum", "shard_map", "shard_map_d"):
            got = m[impl]
            assert float((got["out"] - base["out"]).abs().max()) <= 1e-5
            assert got["aux"] == pytest.approx(base["aux"], rel=1e-6)
            assert got["drop"] == base["drop"]
            for g, w in zip(got["grads"], base["grads"]):
                scale = max(float(w.abs().max()), 1e-30)
                assert float((g - w).abs().max()) <= 1e-5 * scale
        tok, gate, dropped = m["routing"]
        rtok, rgate, rdropped = m["routing_ref"]
        assert torch.equal(tok, rtok) and torch.equal(dropped, rdropped)
        assert torch.equal(gate == 0, rgate == 0)
        ulp = torch.finfo(torch.float32).eps * rgate.abs()
        assert bool(((gate - rgate).abs() <= 2 * ulp).all())
        assert m["meshless"]["drop"] > 0      # the crowded experts drop


def test_restore_places_each_rank_shards(run):
    for r in run["ranks"]:
        for key, (local, want, placed) in r["restore"].items():
            assert placed, key
            assert torch.equal(local, want), key
    # and the shards differ between ranks where a leaf is sharded
    a, b = (run["ranks"][i]["restore"]["layers.0.attn.wq"][0]
            for i in (0, 1))
    assert not torch.equal(a, b)


def test_meshes_of_a_fake_world_leave_no_group():
    """``fake_world`` lays the production meshes over 256 and 512 fake
    ranks and leaves no process group behind."""
    for n, multi in ((256, False), (512, True)):
        with meshlib.fake_world(n):
            mesh = meshlib.make_production_mesh(multi_pod=multi)
            assert mesh.mesh_dim_names == (
                ("pod", "data", "model") if multi else ("data", "model"))
            assert mesh.size() == n
        assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with meshlib.fake_world(8):
            meshlib.make_production_mesh()
    assert not dist.is_initialized()
