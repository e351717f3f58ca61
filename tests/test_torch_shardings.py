"""The port's sharding rules (``launch/shardings.py``, ``launch/mesh.py``,
``runtime/sharding.resolve``) against the JAX package's.

The reference runs once, in one subprocess with 512 host devices
(``tests.proptest.run_script``), and builds ``param_shardings``,
``opt_state_shardings``, ``batch_shardings`` and ``cache_shardings`` from
``jax.eval_shape`` trees (no compile) for all ten configs at full width,
on ``make_production_mesh()``, ``make_production_mesh(multi_pod=True)``
and ``make_test_mesh(2, 4)``, under ``tp`` and ``pure_dp`` (batch axes
``pod``, ``data``, ``model``, as its ``run_cell`` sets them) and, for the
caches, both KV layouts. It hands each leaf's spec and each device's bytes
over as JSON. The port builds the same on ``meta`` tensors over a fake
world of as many ranks.

Every leaf's spec in the port equals the reference's with the stacked
layer dim dropped. The one rule that shards the layer dim itself,
``pure_dp``'s ZeRO-1 placement of m and v, moves those axes onto the
first dim of the port's one-layer leaf they divide
(``shardings._drop_layer``): there the test holds the same axes used and
the leaf's bytes a device summed over the layers equal, except on the
three Mamba2 leaves of :data:`PARTIAL_MOVES`, whose 80 elements take only
16 of the reference's 32 ways (their m and v hold twice the reference's
bytes a device). Each device's argument bytes (parameters, optimizer state,
inputs, cache) equal the reference's, the cache's ``step`` included (a
replicated int32 scalar on both sides). So do those of the
reduced TinyLlama train cell that ``tests/test_torch_dryrun.py`` runs,
as ``launch.dryrun.build_cell`` places them.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math

import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import shardings
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as rs
from tests.proptest import run_script

MESHES = {"single": 256, "multi": 512, "test": 8}
STRATEGIES = ("tp", "pure_dp")
KV_LAYOUTS = ("kv", "ctx")

_REF_SCRIPT = """
import dataclasses, json, math
import numpy as np, jax
from repro.configs import SHAPE_CELLS, cell_applicable, get_config, list_archs
from repro.launch import shardings
from repro.launch.mesh import make_production_mesh, make_test_mesh
from repro.models import api
from repro.optim import adamw
from repro.runtime import sharding as rs

def spec_json(spec):
    return [list(d) if isinstance(d, tuple) else d for d in spec]

def leaves(tree, sh):
    out = {{}}
    for (path, leaf), (_, s) in zip(
            jax.tree_util.tree_leaves_with_path(tree),
            jax.tree_util.tree_leaves_with_path(sh)):
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        b = math.prod(s.shard_shape(tuple(leaf.shape))) * \\
            np.dtype(leaf.dtype).itemsize
        out[key] = [spec_json(tuple(s.spec) + (None,) * (
            len(leaf.shape) - len(s.spec))), b]
    return out

meshes = {{"single": make_production_mesh(),
           "multi": make_production_mesh(multi_pod=True),
           "test": make_test_mesh(2, 4)}}
out = {{}}
for arch in list_archs():
    # one eval_shape pass an arch, shared by every mesh and strategy
    cfg = get_config(arch)
    model = api.build_model(cfg)
    pa = model.abstract_params()
    opt = jax.eval_shape(adamw.init, pa)
    cells = {{name: (cell, model.input_specs(cell),
                    api.abstract_cache(model, cell)
                    if cell.kind == "decode" else None)
             for name, cell in SHAPE_CELLS.items()
             if cell_applicable(cfg, cell)[0]}}
    for mk, mesh in meshes.items():
        for strategy in ("tp", "pure_dp"):
            rs.set_batch_axes(("pod", "data", "model")
                              if strategy == "pure_dp" else ("pod", "data"))
            rec = {{"params": leaves(pa, shardings.param_shardings(
                        pa, mesh, strategy)),
                    "opt": leaves(opt, shardings.opt_state_shardings(
                        opt, mesh, strategy)),
                    "batch": {{}}, "cache": {{}}}}
            for name, (cell, b, c) in cells.items():
                rec["batch"][name] = leaves(b, shardings.batch_shardings(
                    b, mesh))
                if c is not None:
                    rec["cache"][name] = {{kv: leaves(
                        c, shardings.cache_shardings(c, mesh, kv))
                        for kv in ("kv", "ctx")}}
            out[f"{{mk}}/{{strategy}}/{{arch}}"] = rec
rs.set_batch_axes(("pod", "data"))

def dev_bytes(tree, sh):
    return sum(math.prod(s.shard_shape(tuple(l.shape)))
               * np.dtype(l.dtype).itemsize
               for l, s in zip(jax.tree.leaves(tree), jax.tree.leaves(sh)))

# the reduced TinyLlama train cell of the reference's slow dry-run test
cfg = get_config("tinyllama-1.1b").reduced()
model = api.build_model(cfg)
mesh = meshes["test"]
pa = model.abstract_params()
opt = jax.eval_shape(adamw.init, pa)
batch = model.input_specs(dataclasses.replace(
    SHAPE_CELLS["train_4k"], seq_len=64, global_batch=8))
out["reduced_cell"] = {{
    "params": dev_bytes(pa, shardings.param_shardings(pa, mesh)),
    "optimizer": dev_bytes(opt, shardings.opt_state_shardings(opt, mesh)),
    "batch": dev_bytes(batch, shardings.batch_shardings(batch, mesh))}}
with open({path!r}, "w") as f:
    json.dump(out, f)
print("REF_SPECS_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "specs.json")
    out = run_script(_REF_SCRIPT.format(path=path), n_devices=512)
    assert "REF_SPECS_OK" in out
    with open(path) as f:
        return json.load(f)


def _ref_key(key: str) -> str:
    """The reference's path of a port ``state_dict`` key: a stacked
    layer's index dropped."""
    parts = key.split(".")
    if len(parts) > 2 and parts[0] in shardings.STACKED_KEYS \
            and parts[1].isdigit():
        del parts[1]
    return ".".join(parts)


def _spec(spec) -> list:
    return [list(d) if isinstance(d, tuple) else d for d in spec]


def _axes(spec) -> list:
    return sorted(a for d in spec for a in
                  ((d,) if isinstance(d, str) else (d or ())))


#: ZeRO-1 leaves whose layer-dim axes no dim of the port's one-layer leaf
#: takes in full (shardings._drop_layer): (where, reference leaf) ->
#: the extent left replicated. Mamba2's (80,) leaves on 64 layers, whose
#: layer dim the reference shards over ('pod', 'data'), 32 ways: 16 of
#: those move onto the 80, the pod's 2 replicate.
PARTIAL_MOVES = {
    (f"multi/pure_dp/mamba2-2.7b {part}", f"layers.{leaf}"): 2
    for part in ("m", "v") for leaf in ("A_log", "D_skip", "dt_bias")}


def _check_tree(port: dict, sh: dict, ref: dict, where: str):
    """Each port leaf's spec against the reference's, and the bytes a
    device per reference leaf (summed over a stacked leaf's layers)."""
    got_bytes: dict[str, int] = {}
    for key, t in port.items():
        rk = _ref_key(key)
        assert rk in ref, f"{where}: {key} has no reference leaf"
        rspec, _ = ref[rk]
        spec = _spec(sh[key].spec)
        if rk != key and rspec[0] is not None:
            # ZeRO-1 on the layer dim: the axes moved onto the leaf
            moved = set(_axes(spec))
            assert moved <= set(_axes(rspec)) and moved, (where, key, spec)
            if (where, rk) not in PARTIAL_MOVES:
                assert _axes(spec) == _axes(rspec), (where, key, spec, rspec)
        else:
            want = rspec[1:] if rk != key else rspec
            assert spec == want, (where, key, spec, rspec)
        got_bytes[rk] = got_bytes.get(rk, 0) + math.prod(
            sh[key].local_shape(t.shape)) * t.element_size()
    assert set(got_bytes) == set(ref), where
    want_bytes = {k: b * PARTIAL_MOVES.get((where, k), 1)
                  for k, (_, b) in ref.items()}
    assert got_bytes == want_bytes, where


@functools.lru_cache(maxsize=None)
def _port_trees(arch: str):
    """The arch's ``meta`` parameters and AdamW state (one build an arch,
    read by every mesh and strategy)."""
    cfg = configs.get_config(arch)
    model = api.build_model(cfg, device="meta")
    flat = dict(model.module(api.common.META).state_dict())
    opt = adamw.init(flat)
    return cfg, model, flat, opt


@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_specs_and_bytes_equal_reference(ref, mesh_kind):
    """All ten configs, both strategies, every applicable cell's inputs
    and, in a decode cell, both KV layouts of the cache."""
    with meshlib.fake_world(MESHES[mesh_kind]):
        mesh = {"single": meshlib.make_production_mesh,
                "multi": lambda: meshlib.make_production_mesh(
                    multi_pod=True),
                "test": lambda: meshlib.make_test_mesh(2, 4)}[mesh_kind]()
        for strategy in STRATEGIES:
            rs.set_batch_axes(("pod", "data", "model")
                              if strategy == "pure_dp" else ("pod", "data"))
            try:
                for arch in configs.list_archs():
                    where = f"{mesh_kind}/{strategy}/{arch}"
                    r = ref[where]
                    cfg, model, flat, opt = _port_trees(arch)
                    _check_tree(flat, shardings.param_shardings(
                        flat, mesh, strategy), r["params"], where + " params")
                    osh = shardings.opt_state_shardings(opt, mesh, strategy)
                    for part in ("m", "v"):
                        _check_tree(
                            opt[part], osh[part],
                            {k[len(part) + 1:]: v for k, v in r["opt"].items()
                             if k.startswith(part + ".")}, where + " " + part)
                    assert _spec(osh["count"].spec) == r["opt"]["count"][0]
                    for cname, cell in configs.SHAPE_CELLS.items():
                        if not configs.cell_applicable(cfg, cell)[0]:
                            assert cname not in r["batch"]
                            continue
                        b = model.input_specs(cell)
                        _check_tree(b, shardings.batch_shardings(b, mesh),
                                    r["batch"][cname], f"{where} {cname}")
                        if cell.kind != "decode":
                            continue
                        c = api.abstract_cache(model, cell)
                        tensors = {k: t for k, t in c.items()
                                   if isinstance(t, torch.Tensor)}
                        assert set(c) == set(tensors)
                        for kv in KV_LAYOUTS:
                            rc = dict(r["cache"][cname][kv])
                            assert set(rc) == set(tensors), (where, cname)
                            _check_tree(tensors, shardings.cache_shardings(
                                c, mesh, kv), rc, f"{where} {cname} {kv}")
            finally:
                rs.set_batch_axes(("pod", "data"))
    assert not dist.is_initialized()


def test_reduced_train_cell_bytes_equal_reference(ref):
    """Each device's parameter, optimizer and batch bytes of the reduced
    TinyLlama train cell (seq 64, batch 8) on the fake (2, 4) mesh, as
    ``launch.dryrun`` builds it, against the reference's ``NamedSharding``
    shard shapes; ``tests/test_torch_dryrun.py`` holds ``run_cell``'s
    record to the same build."""
    from repro_torch.launch import dryrun
    cfg = configs.get_config("tinyllama-1.1b").reduced()
    cell = dataclasses.replace(configs.SHAPE_CELLS["train_4k"], seq_len=64,
                               global_batch=8)
    with meshlib.fake_world(8):
        built = dryrun.build_cell(api.build_model(cfg, device="meta"), cell,
                                  meshlib.make_test_mesh(2, 4))
        assert dryrun.device_bytes(built) == ref["reduced_cell"]
    assert not dist.is_initialized()


def test_resolve_and_placements():
    """``resolve``'s divisibility filter, one use an axis, ``batch``, and
    ``placements`` (a dim over two axes takes ``Shard`` on both); off-mesh
    every entry is None and ``shard`` the identity."""
    from torch.distributed.tensor import Replicate, Shard
    assert rs.resolve("batch", None, "model", shape=(8, 3, 16)) == \
        (None, None, None)
    x = torch.ones(4, 6)
    assert rs.shard(x, "batch", "model") is x
    with meshlib.fake_world(512):
        mesh = meshlib.make_production_mesh(multi_pod=True)
        with rs.set_mesh(mesh):
            assert rs.resolve("batch", None, "model", shape=(64, 3, 32)) == \
                (("pod", "data"), None, "model")
            # 8 KV heads on a 16-way model axis: replicated (the GQA trap)
            assert rs.resolve("batch", None, "model", None,
                              shape=(32, 5, 8, 64)) == \
                (("pod", "data"), None, None, None)
            # 2 divides but 32 does not: pod kept, data dropped
            assert rs.resolve("batch", shape=(2,)) == ("pod",)
            # model taken once
            assert rs.resolve("model", "model", shape=(16, 16)) == \
                ("model", None)
            spec = rs.resolve("batch", "model", shape=(64, 32))
            assert rs.placements(spec, mesh) == (Shard(0), Shard(0),
                                                 Shard(1))
            assert rs.placements((None, None), mesh) == (Replicate(),) * 3
            assert shardings.Sharding(spec, rs.placements(spec, mesh),
                                      mesh).local_shape((64, 32)) == (2, 2)
    assert not dist.is_initialized()


def test_distribute_slices_each_rank_locally():
    """``distribute`` on one rank of a fake (2, 4) world: each DTensor's
    local tensor is this rank's slice of the full tensor (rank 0: the
    first block of each sharded dim), with no collective."""
    with meshlib.fake_world(8):
        mesh = meshlib.make_test_mesh(2, 4)
        full = {"layers.0.attn.wq": torch.arange(64.).reshape(4, 16),
                "embed": torch.arange(32.).reshape(8, 4)}
        sh = shardings.param_shardings(full, mesh)
        assert sh["layers.0.attn.wq"].spec == (None, "model")
        assert sh["embed"].spec == ("model", None)
        d = shardings.distribute(full, sh)
        assert torch.equal(d["layers.0.attn.wq"].to_local(),
                           full["layers.0.attn.wq"][:, :4])
        assert torch.equal(d["embed"].to_local(), full["embed"][:2])
        assert d["embed"].shape == (8, 4)
    assert not dist.is_initialized()
