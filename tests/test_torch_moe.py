"""Parity of the port's MoE feed-forward (``repro_torch.models.moe``) and of
``examples/moe_ragged_torch.py`` against the JAX package, on the CPU at
``mixtral-8x7b.reduced()`` (d 64, f 128, 4 experts, top-2), float32.

Routing is integer work: ``gather_tok`` and ``dropped`` of
``_dispatch_one`` bit for bit against the reference's vmapped one on the
same logits, at capacity factor 4.0 (drop-free) and 1.25 (copies dropped:
the inputs share a component that crowds a few experts); ``slot_gate``
has the reference's zero pattern bit for bit and its values within 2
float32 ulp: they are a softmax, and PyTorch's ``exp`` and XLA's differ
in the last bit for about a tenth of their arguments. ``moe_ffn``'s
output and ``moe_aux`` within 1e-5 x max abs (float32, another summation
order), ``moe_drop_frac`` equal, and its gradients for x and every MoE
parameter, the router included, against ``jax.vjp`` with cotangents on
both the output and ``moe_aux``, each within 1e-5 x its own max abs. The
example's tiles (``gather_idx``, ``tile_tap``, ``tile_nz``) bit-equal to
the reference example's, and its rows to the reference's kernel run in
interpret mode and to the dense loop (1e-4, the example's own).
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.spconv_gemm import ops as jsg_ops
from repro.kernels.spconv_gemm.kernel import spconv_gemm as jspconv_gemm
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import moe

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5     # float32, another summation order, x max |value|


def _close(port, ref, tol=TOL):
    p = port.detach().float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape, (p.shape, r.shape)
    scale = max(1e-30, float(np.abs(r).max(initial=0.0)))
    assert float(np.abs(p - r).max(initial=0.0)) <= tol * scale


def _setup(cf, s=40):
    cfg = dataclasses.replace(configs.get_config("mixtral-8x7b").reduced(),
                              capacity_factor=cf)
    jcfg = dataclasses.replace(jconfigs.get_config("mixtral-8x7b").reduced(),
                               capacity_factor=cf)
    p = jax.tree.map(np.asarray,
                     jmoe.init_moe(jax.random.key(3), jcfg, jnp.float32))
    rng = np.random.default_rng(4)
    # a shared component crowds the experts it favours: drops at 1.25
    x = (rng.standard_normal((2, s, cfg.d_model))
         + 1.5 * rng.standard_normal(cfg.d_model)).astype(np.float32)
    return cfg, jcfg, p, x


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("cf", [4.0, 1.25])
def test_dispatch_matches_reference(cf):
    cfg, jcfg, p, x = _setup(cf)
    e, k = cfg.n_experts, cfg.top_k
    cap = moe.capacity(cfg, x.shape[1])
    assert cap == jmoe.capacity(jcfg, x.shape[1])
    logits = (x @ p["router"]).astype(np.float32)
    tok, gate, dropped = moe._dispatch_one(torch.from_numpy(x),
                                           torch.from_numpy(logits), k, e,
                                           cap)
    jtok, jgate, jdropped = jax.vmap(
        lambda xx, ll: jmoe._dispatch_one(xx, ll, k, e, cap))(x, logits)
    assert tok.dtype == torch.int32 and gate.dtype == torch.float32
    assert np.array_equal(tok.numpy(), np.asarray(jtok))
    assert np.array_equal(gate.numpy() == 0, np.asarray(jgate) == 0)
    np.testing.assert_array_max_ulp(gate.numpy(), np.asarray(jgate),
                                    maxulp=2)
    assert np.array_equal(dropped.numpy(), np.asarray(jdropped))
    assert (int(dropped.sum()) == 0) == (cf == 4.0)


def test_top_k_breaks_ties_by_index():
    logits = np.array([[1.0, 3.0, 3.0, 0.5], [2.0, 2.0, 2.0, 2.0]],
                      np.float32)
    vals, idx = moe.top_k(torch.from_numpy(logits), 2)
    jvals, jidx = jax.lax.top_k(logits, 2)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("cf", [4.0, 1.25])
def test_moe_ffn_matches_reference(cf):
    cfg, jcfg, p, x = _setup(cf)
    out, m = moe.moe_ffn(_t(p), torch.from_numpy(x), cfg)
    jout, jm = jmoe.moe_ffn(p, x, jcfg)
    _close(out, jout)
    _close(m["moe_aux"], jm["moe_aux"])
    assert float(m["moe_drop_frac"]) == float(jm["moe_drop_frac"])
    assert (float(m["moe_drop_frac"]) > 0) == (cf == 1.25)


@pytest.mark.parametrize("cf", [4.0, 1.25])
def test_moe_ffn_grads_match_reference(cf):
    cfg, jcfg, p, x = _setup(cf)
    rng = np.random.default_rng(5)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    aux_ct = np.float32(0.7)

    (jout, jm), vjp = jax.vjp(lambda pp, xx: jmoe.moe_ffn(pp, xx, jcfg), p, x)
    jm_ct = {"moe_aux": jnp.asarray(aux_ct),
             "moe_drop_frac": jnp.zeros_like(jm["moe_drop_frac"])}
    jgp, jgx = vjp((jnp.asarray(ct), jm_ct))

    tp = {k: v.requires_grad_() for k, v in _t(p).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, m = moe.moe_ffn(tp, tx, cfg)
    obj = (out * torch.from_numpy(ct)).sum() + aux_ct * m["moe_aux"]
    grads = torch.autograd.grad(obj, [tx, *tp.values()])
    _close(grads[0], jgx)
    for (name, _), g in zip(tp.items(), grads[1:]):
        assert float(np.abs(np.asarray(jgp[name])).max()) > 0, name
        _close(g, jgp[name])


def test_set_moe_impl():
    """Both of the reference's dispatches are accepted (``shard_map`` no
    longer raises); off-mesh ``shard_map`` is the ``einsum`` function, bit
    for bit (under a mesh: ``tests/test_torch_lm_sharded.py``)."""
    cfg, _, p, x = _setup(1.25)
    tp, tx = _t(p), torch.from_numpy(x)
    moe.set_moe_impl("einsum")
    want, wm = moe.moe_ffn(tp, tx, cfg)
    try:
        moe.set_moe_impl("shard_map")
        assert moe.moe_impl() == "shard_map"
        got, gm = moe.moe_ffn(tp, tx, cfg)
    finally:
        moe.set_moe_impl("einsum")
    assert torch.equal(got, want)
    assert all(torch.equal(gm[k], wm[k]) for k in wm)
    with pytest.raises(ValueError):
        moe.set_moe_impl("dense")


def _example():
    spec = importlib.util.spec_from_file_location(
        "moe_ragged_torch", REPO / "examples" / "moe_ragged_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_moe_ragged_example_matches_reference():
    ex = _example()
    t, d, f, e, k = ex.T, ex.D, ex.F, ex.E, ex.K
    assert (t, d, f, e, k, ex.BM) == (256, 64, 128, 4, 2, 8)  # the reference's
    x, w_router, w_in = ex.make_inputs(t, d, f, e, device="cpu")
    res = ex.run(x, w_router, w_in, k=k, bm=ex.BM)

    # the reference example's own steps, on the same numpy draws
    jx, jr, jw = (jnp.asarray(a.numpy()) for a in (x, w_router, w_in))
    top = jax.lax.top_k(jx @ jr, k)[1]
    kmap = jnp.full((t, e), -1, jnp.int32).at[
        jnp.arange(t)[:, None], top].set(
        jnp.broadcast_to(jnp.arange(t)[:, None], (t, k)))
    tiles = jsg_ops.build_tap_tiles(kmap, bm=8)
    assert np.array_equal(res["kmap"].numpy(), np.asarray(kmap))
    got = res["tiles"]
    for name in ("gather_idx", "tile_tap", "tile_nz", "slot_valid"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(tiles, name))), name
    lhs = jnp.where(tiles.slot_valid[:, None],
                    jnp.take(jx, tiles.gather_idx, axis=0), 0)
    h = jspconv_gemm(lhs, jw, tiles.tile_tap, tiles.tile_nz, bm=8, bn=128,
                     interpret=True)
    np.testing.assert_allclose(res["h"].numpy(), np.asarray(h), rtol=ex.TOL,
                               atol=ex.TOL)
    np.testing.assert_allclose(res["got"].numpy(), res["want"].numpy(),
                               rtol=ex.TOL, atol=ex.TOL)


def test_moe_ragged_example_cli(capsys):
    _example().main(["--device", "cpu"])
    assert "kernel matches dense loop" in capsys.readouterr().out
