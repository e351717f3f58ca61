"""The port's flags against the JAX package's, on the CPU.

* ``REPRO_SPAC_BLOCK=0``: ``kernel_inputs`` gives the reference's
  tile-grain ``tile_bk_nz`` (the tile liveness widened over the Cin
  blocks), ``1`` (the default) its block grain, both bit-equal to the
  reference's ``tile_liveness`` / ``tile_block_liveness``; the layer's
  output is bit-identical under both and within 1e-5 of the reference's
  math. The flag is re-read on every call, as the reference's
  ``spac_block_enabled``.
* ``REPRO_PLANCACHE_CONTENT=0``: ``PlanCache()`` keys by identity only, as
  the reference's does; an explicit ``content=`` wins.
* ``REPRO_SERVE_MAX_BATCH=3``: ``ServeEngine(max_batch=None)`` drains 3 a
  tick, as the reference's; the default is 8 and an explicit value wins.
* The registry ``runtime/flags.py``: every ``REPRO_*`` name the port's
  code uses (a string in ``src/repro_torch/`` or ``chip_smoke.py``, not a
  docstring) is documented there, every documented name is used or listed
  in ``flags.NOT_READ``, and every flag of the reference's registry is
  documented.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import mapsearch as jmapsearch
from repro.core import plan as jplan
from repro.kernels.spconv_gemm import ops as jsg_ops
from repro.launch import spconv_serve as jserve
from repro.models import minkunet as jminkunet
from repro.runtime import flags as jflags
from repro_torch.core import morton, plan, sparsity
from repro_torch.kernels.spconv_gemm import ops as sg_ops
from repro_torch.launch import spconv_serve
from repro_torch.models import minkunet
from repro_torch.runtime import flags
from tests.proptest import random_cloud

REPO = Path(__file__).resolve().parents[1]
NAME = re.compile(r"REPRO_[A-Z0-9_]*[A-Z0-9]")


def test_spac_block_flag_matches_reference(monkeypatch):
    c, b, v = random_cloud(np.random.default_rng(7), 72, 7)
    kmap = jmapsearch.build_kmap_hash(c, b, v, morton.subm3_offsets())
    rng = np.random.default_rng(3)
    n, c_in, bk = kmap.shape[0], 96, 32
    f = np.maximum(rng.standard_normal((n, c_in)), 0).astype(np.float32)
    f[rng.random(n) < 0.25] = 0.0
    f.reshape(n, c_in // bk, bk)[rng.random((n, c_in // bk)) < 0.4] = 0.0
    w = rng.standard_normal((27, c_in, 40)).astype(np.float32)
    tiles = sg_ops.build_tap_tiles(torch.from_numpy(kmap), bm=16, bo=32)
    jtiles = jsg_ops.build_tap_tiles(jnp.asarray(kmap), bm=16, bo=32)
    ft, wt = torch.from_numpy(f), torch.from_numpy(w)
    row_nz = sparsity.row_nonzero(ft)
    jrow = jnp.asarray(row_nz.numpy())
    jblk = jnp.asarray(sparsity.row_block_nonzero(ft, bk).numpy()) & \
        jrow[:, None]
    want = {"1": np.asarray(jsg_ops.tile_block_liveness(jtiles, jblk)),
            "0": np.repeat(np.asarray(jsg_ops.tile_liveness(jtiles, jrow))
                           [:, None], c_in // bk, axis=1)}
    assert not np.array_equal(want["0"], want["1"])   # the grains differ
    out = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("REPRO_SPAC_BLOCK", flag)
        assert sg_ops.spac_block_enabled() == jsg_ops.spac_block_enabled() \
            == (flag == "1")
        args, _ = sg_ops.kernel_inputs(ft, wt, tiles, n_out=n, row_nz=row_nz,
                                       bk=bk)
        assert np.array_equal(args[-1].numpy(), want[flag])
        out[flag] = sg_ops.apply_tiles(ft, wt, tiles, n_out=n, row_nz=row_nz,
                                       bk=bk)
    assert torch.equal(out["0"], out["1"])
    ref = np.asarray(jsg_ops._exec_ref_math(
        jnp.asarray(f), jnp.asarray(w), jtiles.gather_idx, jtiles.tile_tap,
        jtiles.tile_nz, jtiles.scatter_idx, n_out=n, bm=16, bn=128))
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(out["0"].numpy() - ref).max()) <= 1e-5 * scale


def test_plancache_content_flag_matches_reference(monkeypatch):
    for flag, want in (("0", False), ("1", True), (None, True)):
        if flag is None:
            monkeypatch.delenv("REPRO_PLANCACHE_CONTENT", raising=False)
        else:
            monkeypatch.setenv("REPRO_PLANCACHE_CONTENT", flag)
        assert plan.PlanCache().content is jplan.PlanCache().content is want
        for explicit in (False, True):
            assert plan.PlanCache(content=explicit).content is explicit
            assert jplan.PlanCache(content=explicit).content is explicit


def test_serve_max_batch_flag_matches_reference(monkeypatch):
    model = minkunet.MinkUNet(minkunet.SMALL, device="cpu")

    def both(**kw):
        port = spconv_serve.ServeEngine(model, device="cpu", **kw)
        ref = jserve.ServeEngine(None, jminkunet.SMALL, **kw)
        return port.max_batch, ref.max_batch

    monkeypatch.delenv("REPRO_SERVE_MAX_BATCH", raising=False)
    assert both() == (8, 8)
    monkeypatch.setenv("REPRO_SERVE_MAX_BATCH", "3")
    assert both() == (3, 3)
    assert both(max_batch=5) == (5, 5)
    # the engine reads the flag when it is built
    port = spconv_serve.ServeEngine(model, device="cpu")
    monkeypatch.setenv("REPRO_SERVE_MAX_BATCH", "6")
    assert port.max_batch == 3


def _code_names(path: Path) -> set[str]:
    """``REPRO_*`` names in the string constants of ``path``, docstrings
    left out."""
    tree = ast.parse(path.read_text(), str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            names |= set(NAME.findall(node.value))
    return names


def test_flag_registry_covers_the_port():
    files = [REPO / "chip_smoke.py",
             *sorted((REPO / "src" / "repro_torch").rglob("*.py"))]
    registry = REPO / "src" / "repro_torch" / "runtime" / "flags.py"
    used = set()
    for p in files:
        if p != registry:
            used |= _code_names(p)
    documented = set(NAME.findall(flags.__doc__))
    assert {"REPRO_SPAC_BLOCK", "REPRO_PLANCACHE_CONTENT",
            "REPRO_SERVE_MAX_BATCH", "REPRO_TORCH_BUILD_DIR",
            "REPRO_GUARD_FALLBACK"} <= used
    assert used <= documented, sorted(used - documented)
    assert documented <= used | set(flags.NOT_READ), \
        sorted(documented - used - set(flags.NOT_READ))
    assert not used & set(flags.NOT_READ)
    # every flag of the reference is either read or listed as not read
    assert set(NAME.findall(jflags.__doc__)) <= documented
