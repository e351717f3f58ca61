"""Parity of the port's tap-scan oracle (``impl="scan"``) against the JAX
package's ``impl="xla"``.

Within 1e-5 of the scale (float32 summation order only):
``apply_kmap_gather`` and ``apply_kmap_gather_spac``, forward and the
gradients of features and weights against ``jax.vjp``, on clouds with
exactly-zero rows, whose gradient must be ``Wᵀ·g`` and not 0.
``plan.execute(impl="scan")`` against ``execute(impl="xla")``, with and
without SPAC, a threaded ``act`` and the BN/ReLU epilogue. Within 1e-4 of
the largest logit (float32 order through 13 layers): a MinkUNet ``SMALL``
forward with ``impl="scan"`` against the reference's ``impl="xla"``, with
and without ``fused_epilogue``, and against the port's own kernel path.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import plan as jplan
from repro.core import rulebook as jrulebook
from repro.core import sparsity as jsparsity
from repro.core.spconv import SparseTensor as JSparseTensor
from repro.data import pointcloud as jpointcloud
from repro.kernels.spconv_gemm import ops as jsg_ops
from repro.models import minkunet as jminkunet
from repro_torch.core import plan as planlib
from repro_torch.core import rulebook, sparsity
from repro_torch.core.spconv import SparseTensor
from repro_torch.kernels.spconv_gemm import ops as sg_ops
from repro_torch.models import minkunet
from tests.proptest import random_cloud

TOL = 1e-5
TOL_LOGITS = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, tol=TOL):
    p, r = port.detach().numpy(), np.asarray(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    scale = max(1.0, float(np.abs(r).max(initial=0.0)))
    assert float(np.abs(p - r).max(initial=0.0)) <= tol * scale


def _zero_row_layer(seed, n=40, c_in=6, c_out=10, zero_frac=0.5):
    """A Subm3 layer whose mixed-sign features hold exactly-zero rows."""
    rng = np.random.default_rng(seed)
    c, b, v = random_cloud(rng, n, 5)
    kmap = jplan.subm3_plan(jnp.asarray(c), jnp.asarray(b), jnp.asarray(v),
                            max_blocks=n, bm=8).kmap
    f = rng.standard_normal((n, c_in)).astype(np.float32)
    zero = rng.random(n) < zero_frac
    f[zero] = 0.0
    w = rng.standard_normal((27, c_in, c_out)).astype(np.float32)
    g = rng.standard_normal((n, c_out)).astype(np.float32)
    return np.asarray(kmap), f, w, g, zero


def _port_grads(fn, f, w, g):
    ft = _t(f).requires_grad_()
    wt = _t(w).requires_grad_()
    out = fn(ft, wt)
    out.backward(_t(g))
    return out, ft.grad, wt.grad


@pytest.mark.parametrize("seed", range(3))
def test_apply_kmap_gather_forward_and_grads(seed):
    kmap, f, w, g, _ = _zero_row_layer(seed)
    out, df, dw = _port_grads(
        lambda ft, wt: rulebook.apply_kmap_gather(ft, wt, _t(kmap)), f, w, g)
    jout, vjp = jax.vjp(
        lambda a, b: jrulebook.apply_kmap_gather(a, b, jnp.asarray(kmap)),
        jnp.asarray(f), jnp.asarray(w))
    jdf, jdw = vjp(jnp.asarray(g))
    _close(out, jout)
    _close(df, jdf)
    _close(dw, jdw)


@pytest.mark.parametrize("seed", range(3))
def test_apply_kmap_gather_spac_forward_and_grads(seed):
    kmap, f, w, g, zero = _zero_row_layer(seed + 10, zero_frac=0.6)
    row_nz = (f != 0).any(-1)
    out, df, dw = _port_grads(
        lambda ft, wt: rulebook.apply_kmap_gather_spac(ft, wt, _t(kmap),
                                                       _t(row_nz)), f, w, g)
    jout, vjp = jax.vjp(
        lambda a, b: jrulebook.apply_kmap_gather_spac(
            a, b, jnp.asarray(kmap), jnp.asarray(row_nz)),
        jnp.asarray(f), jnp.asarray(w))
    jdf, jdw = vjp(jnp.asarray(g))
    _close(out, jout)
    _close(df, jdf)
    _close(dw, jdw)
    # the forward elided maps, yet exactly-zero rows get W^T g, not 0
    assert int((sparsity.compact_kmap(_t(kmap), _t(row_nz)) >= 0).sum()) \
        < int((kmap >= 0).sum())
    assert float(df[_t(zero)].abs().max()) > 0
    _, df_off, dw_off = _port_grads(
        lambda ft, wt: rulebook.apply_kmap_gather(ft, wt, _t(kmap)), f, w, g)
    _close(df, df_off.numpy())
    _close(dw, dw_off.numpy())


def _plan_pair(seed, n=48):
    c, b, v = random_cloud(np.random.default_rng(seed), n, 6)
    jp = jplan.subm3_plan(jnp.asarray(c), jnp.asarray(b), jnp.asarray(v),
                          max_blocks=n, bm=16)
    p = planlib.subm3_plan(_t(c), _t(b), _t(v), max_blocks=n, bm=16)
    assert np.array_equal(p.kmap.numpy(), np.asarray(jp.kmap))
    return p, jp, v


@pytest.mark.parametrize("spac", [True, False])
def test_execute_scan_matches_xla(spac):
    p, jp, _ = _plan_pair(1)
    rng = np.random.default_rng(2)
    f = np.maximum(rng.standard_normal((48, 12)), 0).astype(np.float32)
    f[rng.random(48) < 0.3] = 0.0
    w = rng.standard_normal((27, 12, 20)).astype(np.float32)
    bias = rng.standard_normal(20).astype(np.float32)
    got = planlib.execute(p, _t(f), _t(w), _t(bias), spac=spac, impl="scan")
    want = jplan.execute(jp, jnp.asarray(f), jnp.asarray(w),
                         jnp.asarray(bias), spac=spac, impl="xla")
    _close(got, want)
    # the scan and the kernel path compute the same function
    _close(got, planlib.execute(p, _t(f), _t(w), _t(bias), spac=spac)
           .numpy())


def test_execute_scan_epilogue_and_act_match_xla():
    p, jp, v = _plan_pair(3)
    rng = np.random.default_rng(4)
    f = np.maximum(rng.standard_normal((48, 16)), 0).astype(np.float32)
    w = rng.standard_normal((27, 16, 24)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    shift = rng.uniform(-0.5, 0.5, 24).astype(np.float32)
    epi = sg_ops.FusedEpilogue(_t(scale), _t(shift), _t(v))
    jepi = jsg_ops.FusedEpilogue(jnp.asarray(scale), jnp.asarray(shift),
                                 jnp.asarray(v))
    act = sparsity.act_from_feats(_t(f))
    jact = jsparsity.act_from_feats(jnp.asarray(f))
    y, out_act = planlib.execute(p, _t(f), _t(w), act=act, epilogue=epi,
                                 impl="scan")
    jy, jout_act = jplan.execute(jp, jnp.asarray(f), jnp.asarray(w),
                                 act=jact, epilogue=jepi, impl="xla")
    _close(y, jy)
    assert out_act.blk == jout_act.blk
    # liveness is a sweep of the port's own output
    padded = torch.nn.functional.pad(y, (0, 104))
    assert torch.equal(out_act.blk_nz, (padded.reshape(48, 1, 128) != 0)
                       .any(-1))
    with pytest.raises(ValueError, match="bias and epilogue"):
        planlib.execute(p, _t(f), _t(w), _t(shift), epilogue=epi,
                        impl="scan")


JCFG = jminkunet.SMALL
CFG = minkunet.SMALL


@functools.lru_cache(maxsize=1)
def _small():
    """SMALL's reference parameters with perturbed batch-norm statistics,
    and one indoor scene."""
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

    vb = jpointcloud.make_batch(np.random.default_rng(1), "indoor", 1, 384)
    return perturb(tree), vb


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_minkunet_small_scan_forward_matches_xla(fused):
    tree, vb = _small()
    jcfg = dataclasses.replace(JCFG, fused_epilogue=fused)
    cfg = dataclasses.replace(CFG, fused_epilogue=fused)
    jst = JSparseTensor(*(jnp.asarray(a) for a in (vb.coords, vb.batch,
                                                   vb.valid, vb.feats)))
    want = np.asarray(jminkunet.forward(tree, jst, jcfg, impl="xla"))
    model = minkunet.MinkUNet(cfg, device="cpu")
    model.load_state_dict(minkunet.params_from_jax(tree))
    st = SparseTensor(*(_t(a) for a in (vb.coords, vb.batch, vb.valid,
                                        vb.feats)))
    got = minkunet.forward(model, st, impl="scan")
    assert got.shape == (384, CFG.classes)
    _close(got, want, tol=TOL_LOGITS)
    # and the port's kernel path (plain versions on the CPU) agrees
    _close(got, minkunet.forward(model, st).numpy(), tol=TOL_LOGITS)
