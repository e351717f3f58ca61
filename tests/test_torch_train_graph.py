"""The training steps in the form the reference compiles them, on the CPU.

* The MinkUNet backward (``spconv_gemm_fused_ref_vjp`` over a
  ``SlotIndex``) on Subm3, Gconv2 and Tconv2 tiles and on a kmap whose
  source rows repeat within a tap: against the per-tap form it replaced
  (a ``torch.nonzero`` per tap, ``index_add_``), within 1e-5 of the scale
  (float32 summation order only), and against ``jax.grad`` through the
  reference's ``apply_tiles``, within 1e-5 of the scale; the tiles' ten
  streams stay bit-equal to the reference's. The plain forward
  (``impl="ref"``) over the same index, against its per-tap form; bit-equal
  to each output row's products added in ascending slot order (the
  products as it computes them, the sums spelt out here, on every layer
  kind and on a cloud with a duplicate voxel), and within 1e-5 of the
  scale of the reference's fused kernel (interpret mode). The
  backward, the plain forward over a built index and the in-place AdamW
  dispatch no op that reads back to the host, and the MinkUNet step no
  op that the card runs in a varying order.
* ``adamw.update_`` writes what ``adamw.update`` returns, bit for bit.
* ``run_spconv_demo``'s ``compiled_steps`` equals the reference's on a
  replayed and on a fresh scene (``tests/test_cache_content.py``), and its
  memo is a FIFO of 8: a ninth plan set evicts the first.
* ``TrainRunner`` restores into the state's own tensors.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels.spconv_gemm import ops as jsg_ops
from repro.launch import train as jtrain
from repro_torch.core import plan as planlib
from repro_torch.data import pointcloud
from repro_torch.kernels.spconv_gemm import kernel as sg_kernel
from repro_torch.kernels.spconv_gemm import ops as sg_ops
from repro_torch.launch import train
from repro_torch.models import minkunet
from repro_torch.optim import adamw
from repro_torch.runtime.fault import RunnerConfig, TrainRunner
from tests.proptest import random_cloud

TOL = 1e-5
BM = BO = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (small tensors under parallel test workers)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, tol=TOL):
    p, r = np.asarray(port), np.asarray(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    scale = max(1.0, float(np.abs(r).max(initial=0.0)))
    assert float(np.abs(p - r).max(initial=0.0)) <= tol * scale


# ---------------------------------------------------------------------------
# The backward
# ---------------------------------------------------------------------------

def _kmap(kind: str, rng):
    """``(kmap, n_in)`` of one layer kind on a random cloud (``duplicate``:
    a Subm3 map over a cloud whose row 1 repeats row 0's voxel)."""
    c, b, v = (_t(a) for a in random_cloud(rng, 300, 8))
    if kind == "duplicate":
        c[1] = c[0]
        kind = "subm3"
    if kind == "subm3":
        return planlib.subm3_plan(c, b, v, max_blocks=300, bm=8).kmap, 300
    down = planlib.gconv2_plan(c, b, v, bm=8)
    if kind == "gconv2":
        return down.kmap, 300
    up = planlib.tconv2_plan(down.maps, c, b, v, bm=8)
    return up.kmap, down.n_out


def _layer(kind: str, seed: int, c_in=6, c_out=10):
    rng = np.random.default_rng(seed)
    if kind == "repeats":
        # any map: a source row may feed one tap from several outputs
        n_in, n_out, k = 40, 120, 5
        kmap = rng.integers(-1, n_in, (n_out, k)).astype(np.int32)
    else:
        kmap, n_in = _kmap(kind, rng)
        kmap = kmap.numpy()
        n_out, k = kmap.shape
    f = rng.standard_normal((n_in, c_in)).astype(np.float32)
    f[: n_in // 3] = 0.0                       # dead rows: W^T g still flows
    w = rng.standard_normal((k, c_in, c_out)).astype(np.float32)
    g = rng.standard_normal((n_out, c_out)).astype(np.float32)
    return kmap, f, w, g


def _per_tap_vjp(feats, weights, g, t: sg_ops.TapTiles):
    """The backward this slice replaced: the live slots of each tap read
    back with ``torch.nonzero``, the source rows summed by ``index_add_``."""
    bm, c_out = t.bm, weights.shape[-1]
    local = t.scatter_idx - t.tile_ob.repeat_interleave(bm) * t.bo
    live = ((local >= 0) & (local < t.bo)
            & (t.tile_nz != 0).repeat_interleave(bm))
    slot_tap = t.tile_tap.repeat_interleave(bm)
    dfeats = torch.zeros(feats.shape)
    dweights = torch.zeros(weights.shape)
    for k in range(weights.shape[0]):
        sel = torch.nonzero(live & (slot_tap == k)).squeeze(1)
        if sel.numel():
            src = t.gather_idx[sel].long()
            gs = g[t.scatter_idx[sel].long(), :c_out]
            dweights[k] = feats[src].t() @ gs
            dfeats.index_add_(0, src, gs @ weights[k].t())
    return dfeats, dweights


def _jax_grads(kmap, f, w, g):
    tiles = jsg_ops.build_tap_tiles(jnp.asarray(kmap), None, bm=BM, bo=BO)

    def loss(a, b):
        out = jsg_ops.apply_tiles(a, b, tiles, n_out=kmap.shape[0],
                                  impl="ref")
        return jnp.sum(out * jnp.asarray(g))

    return tiles, jax.grad(loss, argnums=(0, 1))(jnp.asarray(f),
                                                 jnp.asarray(w))


@pytest.mark.parametrize("kind", ["subm3", "gconv2", "tconv2", "repeats"])
def test_fixed_order_backward_matches_per_tap_form_and_jax_grad(kind):
    kmap, f, w, g = _layer(kind, seed=len(kind))
    tiles = sg_ops.build_tap_tiles(_t(kmap), bm=BM, bo=BO)
    ft, wt = _t(f).requires_grad_(), _t(w).requires_grad_()
    sg_ops.apply_tiles(ft, wt, tiles, n_out=kmap.shape[0],
                       impl="ref").backward(_t(g))
    n_pad = -(-kmap.shape[0] // BO) * BO
    g_pad = torch.zeros((n_pad, 128))
    g_pad[:kmap.shape[0], :g.shape[1]] = _t(g)
    df, dw = _per_tap_vjp(_t(f), _t(w), g_pad, tiles)
    _close(ft.grad, df)
    _close(wt.grad, dw)
    jtiles, (jdf, jdw) = _jax_grads(kmap, f, w, g)
    _close(ft.grad, jdf)
    _close(wt.grad, jdw)
    assert float(ft.grad[: f.shape[0] // 3].abs().max()) > 0
    # the slot index is an extra beside the tiles: their streams stay the
    # reference's
    for name in jtiles._fields[:-1]:
        assert np.array_equal(np.asarray(getattr(jtiles, name)),
                              getattr(tiles, name).numpy()), name
    index = sg_ops.backward_index(tiles, f.shape[0])
    assert index is sg_ops.backward_index(tiles, f.shape[0])
    if kind == "repeats":
        assert index.by_row.shape[1] > kmap.shape[1]


def _per_tap_forward(feats, weights, t: sg_ops.TapTiles, n_out):
    """The plain forward this slice replaced: each tap's live slots read
    back with ``torch.nonzero``."""
    bm = t.bm
    local = t.scatter_idx - t.tile_ob.repeat_interleave(bm) * t.bo
    live = ((local >= 0) & (local < t.bo)
            & (t.tile_nz != 0).repeat_interleave(bm))
    slot_tap = t.tile_tap.repeat_interleave(bm)
    out = torch.zeros((-(-n_out // t.bo) * t.bo, weights.shape[-1]))
    for k in range(weights.shape[0]):
        sel = torch.nonzero(live & (slot_tap == k)).squeeze(1)
        out.index_add_(0, t.scatter_idx[sel].long(),
                       feats[t.gather_idx[sel].long()] @ weights[k])
    return out[:n_out]


@pytest.mark.parametrize("kind", ["subm3", "gconv2", "tconv2", "repeats"])
def test_plain_forward_over_slot_index_matches_per_tap_form(kind):
    """``impl="ref"`` runs the plain forward over the tiles' slot index,
    with no host read once the index is built: within 1e-5 of the scale of
    the per-tap form, bit-equal to the kernel wrapper's CPU path (which
    builds the index itself)."""
    from repro_torch.kernels.spconv_gemm.ref import spconv_gemm_fused_ref
    kmap, f, w, _ = _layer(kind, seed=len(kind) + 7)
    n_out = kmap.shape[0]
    tiles = sg_ops.build_tap_tiles(_t(kmap), bm=BM, bo=BO)
    ref = sg_ops.apply_tiles(_t(f), _t(w), tiles, n_out=n_out, impl="ref")
    _close(ref, _per_tap_forward(_t(f), _t(w), tiles, n_out))
    assert torch.equal(ref, sg_ops.apply_tiles(_t(f), _t(w), tiles,
                                               n_out=n_out, impl="kernel"))
    args, kw = sg_ops.kernel_inputs(_t(f), _t(w), tiles, n_out=n_out)
    index = sg_ops.backward_index(tiles, f.shape[0])
    with _Ops() as ops:
        out = spconv_gemm_fused_ref(*args, **kw, index=index)
    assert torch.equal(out[:n_out, :w.shape[-1]], ref)
    assert not _names(ops.calls) & HOST_READS


@pytest.mark.parametrize("kind", ["subm3", "gconv2", "tconv2", "repeats",
                                  "duplicate"])
def test_plain_forward_sums_each_output_row_in_slot_order(kind):
    """The plain forward adds each output row's products in ascending slot
    order (tap after tap, slot order within a tap), the order
    ``SlotIndex.by_out`` fixes: bit-equal to that sum spelt out here in
    float32 from the same products, whose slots and order are derived
    here from the tiles; within 1e-5 of the scale of the reference's
    fused kernel in interpret mode."""
    from repro_torch.kernels.spconv_gemm.ref import spconv_gemm_fused_ref
    kmap, f, w, _ = _layer(kind, seed=len(kind) + 13)
    n_out, c_out = kmap.shape[0], w.shape[-1]
    tiles = sg_ops.build_tap_tiles(_t(kmap), bm=BM, bo=BO)
    args, kw = sg_ops.kernel_inputs(_t(f), _t(w), tiles, n_out=n_out)
    index = sg_ops.backward_index(tiles, f.shape[0])
    out = spconv_gemm_fused_ref(*args, **kw, index=index)
    # the live slots, tap after tap, and each one's product as the plain
    # version computes it: one product a tap
    bm = tiles.bm
    gather, scatter = tiles.gather_idx.numpy(), tiles.scatter_idx.numpy()
    slot_tap = np.repeat(tiles.tile_tap.numpy(), bm)
    local = scatter - np.repeat(tiles.tile_ob.numpy(), bm) * tiles.bo
    live = (local >= 0) & (local < tiles.bo) & np.repeat(
        tiles.tile_nz.numpy() != 0, bm)
    slots = [s for k in range(w.shape[0])
             for s in np.flatnonzero(live & (slot_tap == k))]
    prods = {}
    for k in range(w.shape[0]):
        sel = [s for s in slots if slot_tap[s] == k]
        if sel:
            p = (_t(f)[torch.as_tensor(gather[sel]).long()]
                 @ _t(w)[k]).numpy()
            prods.update(zip(sel, p))
    want = np.zeros((out.shape[0], c_out), np.float32)
    per_row = np.zeros(out.shape[0], np.int64)
    for s in slots:                       # ascending order within each row
        want[scatter[s]] += prods[s]
        per_row[scatter[s]] += 1
    assert index.by_out.shape[1] == per_row.max()
    assert np.array_equal(out[:, :c_out].numpy(), want)
    if kind == "duplicate":
        # rows 0 and 1 hold one voxel: the same slots' products, in the
        # same order, give the same bits
        assert per_row[0] == per_row[1] > 0
        assert torch.equal(out[0], out[1])
    jtiles = jsg_ops.build_tap_tiles(jnp.asarray(kmap), None, bm=BM, bo=BO)
    jout = jsg_ops.apply_tiles(jnp.asarray(f), jnp.asarray(w), jtiles,
                               n_out=n_out, impl="interpret")
    _close(out[:n_out, :c_out], jout)


class _Ops(TorchDispatchMode):
    """The names of the aten ops dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.calls: list = []
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.paused:
            self.calls.append((func, args, kwargs))
        return func(*args, **kwargs)


#: ops that read a value back to the host, or size their output by one
HOST_READS = {"_local_scalar_dense", "nonzero", "masked_select", "unique",
              "_unique2", "unique_consecutive", "item", "repeat_interleave"}
#: ops the card runs with atomics in no fixed order (``torch.use_
#: deterministic_algorithms``'s list; a gather's backward is a scatter-add)
UNORDERED = {"index_add", "index_add_", "scatter_add", "scatter_add_",
             "scatter_reduce", "scatter_reduce_", "index_reduce",
             "index_reduce_", "put_", "embedding_dense_backward",
             "_embedding_bag_dense_backward", "nll_loss_forward",
             "nll_loss2d_forward", "histc", "index_copy", "index_copy_"}


def _names(calls):
    out = set()
    for func, args, kwargs in calls:
        name = func.__name__.split(".")[0]
        accumulate = kwargs.get("accumulate", args[3] if len(args) > 3
                                and name in ("index_put", "index_put_",
                                             "_index_put_impl_") else False)
        if name in ("index_put", "index_put_", "_index_put_impl_"):
            name = f"{name}(accumulate={bool(accumulate)})"
        if name == "cumsum" and args[0].is_floating_point():
            name = "cumsum(float)"
        out.add(name)
    return out


def test_backward_and_adamw_have_no_host_read():
    kmap, f, w, g = _layer("subm3", seed=11)
    tiles = sg_ops.build_tap_tiles(_t(kmap), bm=BM, bo=BO)
    index = sg_ops.backward_index(tiles, f.shape[0])   # built at plan time
    n_pad = -(-kmap.shape[0] // BO) * BO
    params = {"w": _t(w), "b": torch.zeros(10)}
    state = adamw.init(params)
    with _Ops() as ops:
        from repro_torch.kernels.spconv_gemm.ref import (
            spconv_gemm_fused_ref_vjp)
        df, dw = spconv_gemm_fused_ref_vjp(_t(f), _t(w),
                                           torch.ones((n_pad, 128)), index)
        adamw.update_(adamw.AdamWConfig(), {"w": dw, "b": params["b"]},
                      state, params)
    seen = _names(ops.calls)
    assert not seen & HOST_READS, seen & HOST_READS
    assert not seen & (UNORDERED | {"index_put(accumulate=True)",
                                    "index_put_(accumulate=True)",
                                    "_index_put_impl_(accumulate=True)",
                                    "cumsum(float)"})


def test_minkunet_step_dispatches_no_unordered_op(monkeypatch):
    """The whole donated step, forward, backward and AdamW, on the CPU;
    the kernel's plain version (the forward's, which the card replaces
    with kernel 2) is left out of the audit."""
    cfg = train.DEMO_CFG
    model = minkunet.MinkUNet(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    vb = pointcloud.make_batch(np.random.default_rng(0), "indoor", 1, 256)
    batch = {k: _t(v) for k, v in vb._asdict().items()}
    batch["labels"] = batch["labels"].clamp(0, cfg.classes - 1)
    plans = minkunet.build_plans(batch["coords"], batch["batch"],
                                 batch["valid"], cfg, device="cpu")
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = (params, adamw.init(params))
    step = train.make_spconv_step(model, adamw.AdamWConfig(), plans,
                                  donate=True)
    step(state, batch)                   # builds the slot indexes
    audit = _Ops()
    plain = sg_kernel.spconv_gemm_fused_ref

    def kernel_stand_in(*a, **kw):
        audit.paused = True
        try:
            return plain(*a, **kw)
        finally:
            audit.paused = False

    monkeypatch.setattr(sg_kernel, "spconv_gemm_fused_ref", kernel_stand_in)
    with audit:
        out, _ = step(state, batch)
    assert out[0] is params
    seen = _names(audit.calls)
    bad = seen & (UNORDERED | {"index_put(accumulate=True)",
                               "index_put_(accumulate=True)",
                               "_index_put_impl_(accumulate=True)",
                               "cumsum(float)", "gather"})
    assert not bad, bad


# ---------------------------------------------------------------------------
# AdamW in place
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_update_in_place_is_bit_equal(dtype):
    gen = torch.Generator().manual_seed(3)
    params = {k: torch.randn(s, generator=gen).to(dtype)
              for k, s in (("a", (5, 7)), ("b", (7,)), ("c", ()))}
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    out_params, out_state = params, adamw.init(params)
    in_params = {k: p.clone() for k, p in params.items()}
    in_state = adamw.init(in_params)
    held = list(in_params.values()) + list(in_state["m"].values())
    for _ in range(4):
        grads = {k: torch.randn(p.shape, generator=gen).to(dtype) * 3
                 for k, p in params.items()}
        out_params, out_state, om = adamw.update(cfg, grads, out_state,
                                                 out_params)
        im = adamw.update_(cfg, grads, in_state, in_params)
        for k in params:
            assert torch.equal(in_params[k], out_params[k]), k
            assert torch.equal(in_state["m"][k], out_state["m"][k]), k
            assert torch.equal(in_state["v"][k], out_state["v"][k]), k
        assert torch.equal(in_state["count"], out_state["count"])
        assert torch.equal(im["lr"], om["lr"])
        assert torch.equal(im["grad_norm"], om["grad_norm"])
    assert all(a is b for a, b in zip(held, list(in_params.values())
                                      + list(in_state["m"].values())))


# ---------------------------------------------------------------------------
# The compiled-step memo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("replay", [True, False])
def test_compiled_steps_match_reference(replay):
    res = train.run_spconv_demo(2, voxels=96, replay=replay, device="cpu")
    ref = jtrain.run_spconv_demo(steps=2, voxels=96, impl="ref",
                                 replay=replay)
    assert res["compiled_steps"] == ref["compiled_steps"] == (
        1 if replay else 2)
    assert res["mapsearch_calls"] == ref["mapsearch_calls"]
    assert [t["graph"] for t in res["timings"]] == ["eager"] * 2


def test_step_memo_is_a_fifo_of_eight(monkeypatch):
    released = []
    monkeypatch.setattr(train.CompiledStep, "release",
                        lambda self: released.append(self))
    made = []
    init = train.CompiledStep.__init__

    def record(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(train.CompiledStep, "__init__", record)
    res = train.run_spconv_demo(train.STEP_MEMO + 1, voxels=64,
                                replay=False, device="cpu")
    assert res["compiled_steps"] == len(made) == 9
    assert released == made[:1]


def test_runner_restores_into_the_state_tensors(tmp_path):
    w = torch.zeros(3)

    def step(state, batch):
        state["w"].mul_(0.5).add_(batch)       # donated: in place
        return state, {"loss": float(state["w"].sum())}

    runner = TrainRunner(RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=1),
                         step, lambda s: torch.full((3,), float(s + 1)),
                         {"w": w})
    runner.run(3)
    want = w.clone()
    w.fill_(7.0)
    again = TrainRunner(RunnerConfig(ckpt_dir=str(tmp_path)), step,
                        lambda s: torch.zeros(3), runner.state)
    assert again.restore_latest() and again.step == 3
    assert again.state["w"] is w and torch.equal(w, want)
