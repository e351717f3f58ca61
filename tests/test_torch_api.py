"""The port's model API against the JAX package's, on the CPU.

* ``ShapeCell``, ``SHAPE_CELLS`` and ``cell_applicable`` field for field,
  every arch x cell.
* For every arch of ``list_archs()`` at its full config:
  ``Model.abstract_params()`` (each stacked layer or group split into its
  own entries), and for every applicable cell ``input_specs`` and, in a
  decode cell, ``abstract_cache``, have the shapes and dtypes of the
  reference's ``jax.eval_shape`` trees, all on the ``meta`` device (no
  allocation, no draws); the cache's ``step`` is the host integer 0.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro_torch import configs
from repro_torch.models import api, common

STACKED = ("layers", "groups")


def _dt(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.dtype(x.dtype).name


def _ref_shapes(tree) -> dict:
    """{state_dict key: (shape, dtype)} of a reference ShapeDtypeStruct
    parameter tree, each stacked axis split as ``params_from_jax`` does."""
    out = {}

    def walk(prefix, node, split):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v, split)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}.", v, split)
        elif split is None:
            out[prefix[:-1]] = (tuple(node.shape), _dt(node))
        else:
            for i in range(node.shape[0]):
                out[f"{split}.{i}.{prefix[:-1]}"] = (tuple(node.shape[1:]),
                                                     _dt(node))

    for key, node in tree.items():
        walk("" if key in STACKED else f"{key}.", node,
             key if key in STACKED else None)
    return out


def test_shape_cells_equal_reference():
    assert list(configs.SHAPE_CELLS) == list(jconfigs.SHAPE_CELLS)
    for name, cell in configs.SHAPE_CELLS.items():
        assert dataclasses.asdict(cell) == \
            dataclasses.asdict(jconfigs.SHAPE_CELLS[name])
    for arch in configs.list_archs():
        for name, cell in configs.SHAPE_CELLS.items():
            assert configs.cell_applicable(configs.get_config(arch), cell) \
                == jconfigs.cell_applicable(jconfigs.get_config(arch),
                                            jconfigs.SHAPE_CELLS[name])


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_abstract_specs_match_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    model = api.build_model(cfg, device="cpu")
    jmodel = japi.build_model(jcfg)
    tree = model.abstract_params()
    flat = common.ParamTree(tree).state_dict()
    assert all(t.device.type == "meta" for t in flat.values())
    got = {k: (tuple(t.shape), _dt(t)) for k, t in flat.items()}
    assert got == _ref_shapes(jmodel.abstract_params())
    n_cells = 0
    for name, cell in configs.SHAPE_CELLS.items():
        if not configs.cell_applicable(cfg, cell)[0]:
            continue
        n_cells += 1
        specs = model.input_specs(cell)
        want = jmodel.input_specs(jconfigs.SHAPE_CELLS[name])
        assert set(specs) == set(want)
        for k, t in specs.items():
            assert t.device.type == "meta"
            assert (tuple(t.shape), _dt(t)) == \
                (tuple(want[k].shape), _dt(want[k])), (name, k)
        if cell.kind != "decode":
            continue
        cache = api.abstract_cache(model, cell)
        jcache = japi.abstract_cache(jmodel, jconfigs.SHAPE_CELLS[name])
        assert set(cache) == set(jcache)
        # ``step`` too: an int32 scalar, as the reference's
        for k, t in cache.items():
            assert t.device.type == "meta"
            assert (tuple(t.shape), _dt(t)) == \
                (tuple(jcache[k].shape), _dt(jcache[k])), (name, k)
    assert n_cells >= 2
