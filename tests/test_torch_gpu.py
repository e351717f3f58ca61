"""Kernel-vs-plain checks of the port's CUDA kernels on the card.

Every test here is marked ``gpu`` and skips with a reason on a host with no
CUDA device (decided inside the ``cuda`` fixture, never at import). This
file imports no JAX: run it on the card's machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The OCTENT kernel must equal its plain version bit for bit (dense, grid
edge, sparse and multi-batch clouds, duplicate coordinates, fewer directory
slots than blocks, one block holding all 4,096 voxels, offsets that leave
the 3x3x3 blocks, an all-invalid cloud); ``apply_tiles`` must be
differentiable on the card with the plain version's CPU gradient; one
training step of the demo MinkUNet must give the loss (1e-4 relative) and
every gradient (1e-3 x its own max |g|) through the kernels that it gives
through the plain versions; the content fingerprint of a tensor on the
card must equal its CPU fingerprint, and a re-allocated cloud must hit
the plan cache with no search; the
gather-GEMM
kernel must stay within 1e-4 of the plain version's scale (float32, other
summation order), at the edge cases: Cin = 4, all-dead tiles, empty output
blocks, out-of-grid queries, tile heights of 32, 96 and 256 slots with
output blocks of 64 and 192 rows, (block, tap) groups of 1, 15, 16, 17,
127 and 128 maps (the 16-row fragment edges), at most 1, 2, 3, 4 or 64
CTAs per output block, and the fused epilogue after the split-sum kernel;
its planning kernel must equal its plain version bit for bit, repeated
calls must give the same bits, and neither it nor the block-masked matmul
may synchronise with the host. The materialized
GEMM and the block-masked matmul are held to the same 1e-4 at all-dead
tiles, the Cin = 4 stem, Cin = Cout = 512, tile heights other than 128
(the materialized GEMM also at Cin 2,304 and 38, a run of six same-tap
tiles, all-live layouts at bm 8 and 128 and nine 128-column slabs, live
tiles marked dead giving zeros), a
caller's mask that kills a nonzero tile, masks whose tiles straddle the
kernel's 128 x 32 steps, ragged M, N and K (K and N not multiples of 4
included), and shapes that are not tile multiples through
``sparse_dense_matmul``. The flash-attention kernel is
held to its plain version in float32 (2e-5: summation order, the
reference's own) and bf16 (2^-7 relative plus 2e-3: one ulp of the bf16
output plus the float32 summation order), for each
head dim of the repo's configs, a window shorter than one KV block, a
window of 1, a fully masked leading block, Sq < Skv with ragged edges,
Sq = Skv at and around the bf16 route's block edges (1, 64, 65, 127, 128,
129) and Sq = Skv - 7 at every head dim, MQA, Hq / Hkv = 32 and non-causal
attention; a bf16 view whose base is not 16-byte aligned raises. A small
TinyLlama prefill through the kernel is held to the same prefill through
the plain version. With grad enabled the kernel path's attention Function
launches the kernel once in its forward and returns the plain version's
gradients (float32 and bf16); the MoE feed-forward on the card gives its
CPU result (routing integers equal, output and gradients within 1e-4),
and a two-layer Mixtral ``lm_loss`` through the kernel (4 launches under
remat ``full``) holds its loss and gradients to the plain version's. The output-stationary Gconv3 goes through the
gather-GEMM kernel with more output rows than input rows (after a replan
to a row count that is not a multiple of 128) and with fewer, its plan
bit-equal to the CPU's and its output and gradients to the plain
version's; a small SECOND's forward (1e-3 of the plain max) and its
``detection_loss`` gradients (the plain run's ReLU masks pinned to the
kernel run's) are held to the plain versions. The fixed-order sums
(``segment.ordered_sum`` and its backward, ``scatter_valid``,
``to_bev``) give their CPU bits on the card, with no host read over a
prebuilt index; ``apply_kmap``, ``apply_maps_scatter`` with its
gradients, and the small SECOND's forward and ``detection_loss`` with
every gradient are bit-equal across two runs. Kernel 1's row-list mode is
held to its plain version on a spliced streaming table (an empty list,
one row, 200 rows, evicted slots, -1 pads), and a TINY stream's delta and
scratch sessions agree bit for bit on the card. The serving engine retries
a one-shot injected ``gemm`` fault with the kernel to the clean request's
bits (no fallback served), a persistent ``gemm`` or ``search`` fault
raises even with the fallback chain on, and plans persisted from the card
decode back onto it (their tiles rebuilt) bit-equal, with no search. The
dense-table and sorted searches on the card equal their CPU runs bit for
bit, on clouds without and with duplicate rows (the dense table keeps the
last, as the host hash does; the sorted search the first, as kernel 1
does), and the dense search is never reached through the guard's chain.
One NCCL rank under a 1-way mesh keeps kernel 1 by ``auto`` and its
forced sharded search equals kernel 1's kmap on a 4,096-row LiDAR cloud.
Narrow RecurrentGemma (D 256, MQA, past its window), HuBERT (D 80,
non-causal) and LLaVA (D 128, GQA, patches) prefills launch the kernel
once an attention layer and hold their output to the plain version's
(1e-3 x max in float32, 2e-2 in bf16); a narrow Mamba2 on the card gives
its CPU logits and decodes a 2-token prompt as its teacher-forced
prefill. The serving engine's CUDA graph (one executable for a bucket
class) serves two scenes of one bucket in one tick, each bit-equal to an
eager forward of its tensors and plans, and a replay adds the captured
forward's launches to the counters; each family with a decode step,
narrow, replays it from a graph in ``generate``, its tokens and each
step's logits equal to an eager ``decode_step`` loop's; a capture that meets a host
read raises, and the card stays usable. A donated graph replays into its
caller's state tensors; the demo MinkUNet training step, captured after
one eager step, replays bit for bit against an eager step from the same
state and batch, and a whole step runs under
``torch.use_deterministic_algorithms(True)``; each family's narrow LM
training step replays within 1e-6 of an eager step.
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import mapsearch, morton, sparsity
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.masked_matmul import kernel as mm_kernel
from repro_torch.kernels.masked_matmul import ops as mm_ops
from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref
from repro_torch.kernels.octent import kernel as oct_kernel, ops as oct_ops
from repro_torch.kernels.octent.ref import octent_query_ref
from repro_torch.kernels.spconv_gemm import kernel as sg_kernel
from repro_torch.kernels.spconv_gemm import ops as sg_ops
from repro_torch.kernels.spconv_gemm.ref import (spconv_gemm_fused_ref,
                                                 spconv_gemm_ref)
from repro_torch.models import transformer

pytestmark = pytest.mark.gpu
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on "
                    "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cloud(rng, n, extent, n_valid, origin=0, batch=1):
    seen, rows = set(), []
    while len(rows) < n_valid:
        c = tuple(int(x) for x in rng.integers(origin, origin + extent, 3))
        b = int(rng.integers(0, batch))
        if (b, c) not in seen:
            seen.add((b, c))
            rows.append((b, c))
    coords = np.zeros((n, 3), np.int32)
    bidx = np.zeros(n, np.int32)
    valid = np.zeros(n, bool)
    for i, (b, c) in enumerate(rows):
        coords[i], bidx[i], valid[i] = c, b, True
    return coords, bidx, valid


def _dev(dev, *arrays):
    return [torch.as_tensor(a, device=dev) for a in arrays]


def _full_block(rng):
    """All 4,096 voxels of one 16^3 block (more than the kernel stages) and
    a shell of voxels in its neighbours, shuffled."""
    g = np.stack(np.meshgrid(*[np.arange(16, 32)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    shell = rng.integers(12, 36, (600, 3))
    c = np.unique(np.concatenate([g, shell]), axis=0).astype(np.int32)
    c = c[rng.permutation(c.shape[0])]
    return c, np.zeros(c.shape[0], np.int32), np.ones(c.shape[0], bool)


def _octent_case(case, rng):
    """(coords, batch, valid, grid_bits, max_blocks, offsets, host_check)."""
    gb, offs, host = 7, morton.subm3_offsets(), True
    if case == "dense":
        c, b, v = _cloud(rng, 4096, 24, 3000)
    elif case == "edge":         # queries step out of the grid
        gb = 5
        c, b, v = _cloud(rng, 1000, 10, 900, origin=(1 << gb) * 16 - 10)
    elif case == "sparse":       # mostly empty blocks
        c, b, v = _cloud(rng, 2048, 1500, 1200)
    elif case == "multibatch":
        c, b, v = _cloud(rng, 3000, 16, 2500, batch=4)
    elif case == "duplicates":   # a run of equal keys: the first slot wins
        c, b, v = _cloud(rng, 3000, 20, 2000)
        dup = rng.integers(0, 2000, 1000)
        c[2000:], v[2000:] = c[dup], True
        host = False
    elif case == "overflow":     # fewer directory slots than blocks
        c, b, v = _cloud(rng, 3000, 120, 2500)
        host = False
    elif case == "full_block":
        c, b, v = _full_block(rng)
    elif case == "far_offsets":  # taps that leave the 3x3x3 blocks
        c, b, v = _cloud(rng, 2048, 200, 1800)
        offs = rng.integers(-20, 21, (27, 3)).astype(np.int32)
        host = False
    else:                        # all_invalid
        c, b, v = _cloud(rng, 1000, 16, 800)
        v[:] = False
    max_blocks = 64 if case == "overflow" else c.shape[0]
    return c, b, v, gb, max_blocks, offs, host


@pytest.mark.parametrize("case", ["dense", "edge", "sparse", "multibatch",
                                  "duplicates", "overflow", "full_block",
                                  "far_offsets", "all_invalid"])
def test_octent_kernel_bit_identical(cuda, case):
    rng = np.random.default_rng(0)
    c, b, v, gb, max_blocks, offs, host = _octent_case(case, rng)
    c, b, v = _dev(cuda, c, b, v)
    qt = oct_ops.build_query_table(c, b, v, max_blocks=max_blocks,
                                   grid_bits=gb)
    if case == "overflow":
        assert int(qt.n_blocks) > max_blocks
    offs = torch.as_tensor(offs, device=cuda)
    before = oct_kernel.launches
    got = oct_kernel.octent_query(c, b, v, offs, qt.ublocks, qt.tkey,
                                  qt.tval, qt.n_blocks, grid_bits=gb)
    torch.cuda.synchronize()
    assert oct_kernel.launches == before + 1
    want = octent_query_ref(c, b, v, offs, qt.ublocks, qt.tkey, qt.tval,
                            qt.n_blocks, grid_bits=gb)
    assert torch.equal(got, want)
    if case == "all_invalid":
        assert bool((got == -1).all())
    if host:
        host_kmap = mapsearch.build_kmap_hash(
            *(t.cpu().numpy() for t in (c, b, v)), morton.subm3_offsets())
        assert np.array_equal(got.cpu().numpy(), host_kmap)


def test_apply_tiles_grads_on_card(cuda):
    """The fused path is differentiable on the card, with the plain
    version's gradient over the geometry liveness, computed on the CPU."""
    rng = np.random.default_rng(5)
    kmap = _subm_kmap(1500, 16, 1200)
    n = kmap.shape[0]
    f = rng.standard_normal((n, 32)).astype(np.float32)
    f[: n // 2] = 0.0                  # whole tiles dead in the forward
    w = rng.standard_normal((27, 32, 64)).astype(np.float32)
    g = rng.standard_normal((n, 64)).astype(np.float32)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        ft, wt = (torch.as_tensor(a, device=dev).requires_grad_()
                  for a in (f, w))
        tiles = sg_ops.build_tap_tiles(torch.as_tensor(kmap, device=dev),
                                       bm=64, bo=128)
        before = sg_kernel.launches
        out = sg_ops.apply_tiles(ft, wt, tiles, n_out=n,
                                 row_nz=sparsity.row_nonzero(ft))
        assert out.grad_fn is not None
        assert sg_kernel.launches == before + int(dev.type == "cuda")
        out.backward(torch.as_tensor(g, device=dev))
        grads[dev.type] = (ft.grad.cpu(), wt.grad.cpu())
    for got, want in zip(grads["cuda"], grads["cpu"]):
        _close(got, want)
    assert float(grads["cuda"][0][: n // 2].abs().max()) > 0


def test_segmentation_loss_grads_kernel_vs_plain_on_card(cuda):
    """One training step at the demo config: loss and gradients through
    the kernels (``impl="kernel"``) against the plain versions on the same
    plans, weights and batch. Every conv bias feeds a training BatchNorm,
    so its gradient is zero in exact arithmetic: both sides must stay
    below 1e-5 of the model's largest |g| there."""
    from repro_torch.data import pointcloud
    from repro_torch.launch import train
    from repro_torch.models import minkunet
    cfg = train.DEMO_CFG
    model = minkunet.MinkUNet(cfg, device=cuda,
                              generator=torch.Generator().manual_seed(0))
    vb = pointcloud.make_batch(np.random.default_rng(0), "indoor", 1, 4096)
    batch = {k: torch.as_tensor(np.array(v), device=cuda)
             for k, v in vb._asdict().items()}
    batch["labels"] = batch["labels"].clamp(0, cfg.classes - 1)
    plans = minkunet.build_plans(batch["coords"], batch["batch"],
                                 batch["valid"], cfg, device=cuda)
    params = {k: v.clone() for k, v in model.state_dict().items()}
    before = sg_kernel.launches
    lk, _, gk = train.loss_and_grads(model, params, batch, plans=plans,
                                     impl="kernel")
    n_layers = 1 + (1 + cfg.blocks) * (len(cfg.enc) + len(cfg.dec))
    assert sg_kernel.launches - before == n_layers
    lr, _, gr = train.loss_and_grads(model, params, batch, plans=plans,
                                     impl="ref")
    assert sg_kernel.launches - before == n_layers
    assert torch.isfinite(lk) and abs(float(lk - lr)) <= 1e-4 * abs(
        float(lr))
    gmax = max(float(g.abs().max()) for g in gr.values())
    for k in gr:
        if k.endswith((".conv.b", ".mean", ".var")):
            assert max(float(gk[k].abs().max()),
                       float(gr[k].abs().max())) <= 1e-5 * gmax, k
        else:
            scale = float(gr[k].abs().max())
            assert scale > 0 and float((gk[k] - gr[k]).abs().max()) \
                <= 1e-3 * scale, k


def test_content_fingerprint_on_card_equals_cpu(cuda):
    """Fingerprint words computed on the card equal the CPU's (int32,
    bool, int64 with differing high words), and a re-allocated cloud hits
    the plan cache by content with no search and no kernel-1 launch."""
    from repro_torch.core import plan as planlib
    from repro_torch.models import minkunet
    rng = np.random.default_rng(11)
    coords, batch, valid = _cloud(rng, 3000, 40, 2500)
    wide = np.arange(5000, dtype=np.int64) * 3 + (1 << 33)
    for a in (coords, valid, wide):
        t = torch.from_numpy(a)
        assert planlib.array_fingerprint(t.to(cuda)) == \
            planlib.array_fingerprint(t)
    cfg = minkunet.MinkUNetConfig(stem=8, enc=(8, 16), dec=(16, 8),
                                  classes=4)
    cache = planlib.PlanCache()
    planlib.reset_mapsearch_counter()

    def build():
        return minkunet.build_plans(*(torch.as_tensor(a, device=cuda)
                                      for a in (coords, batch, valid)),
                                    cfg, cache=cache, device=cuda)

    first = build()
    launches = oct_kernel.launches
    again = build()
    assert planlib.mapsearch_call_count() == 2 * len(cfg.enc) + 1
    assert oct_kernel.launches == launches
    assert again.subm[0] is first.subm[0] and cache.content_hits > 0


def _check_gemm(dev, kmap, c_in, c_out, *, bm, bo, dead_rows=0.25,
                epilogue=False, seed=0):
    rng = np.random.default_rng(seed)
    n = kmap.shape[0]
    f = np.maximum(rng.standard_normal((n, c_in)), 0).astype(np.float32)
    f[rng.random(n) < dead_rows] = 0.0
    w = rng.standard_normal((kmap.shape[1], c_in, c_out)).astype(np.float32)
    f, w = _dev(dev, f, w)
    tiles = sg_ops.build_tap_tiles(torch.as_tensor(kmap, device=dev), bm=bm,
                                   bo=bo)
    epi = None
    if epilogue:
        valid = torch.as_tensor(rng.random(n) < 0.9, device=dev)
        epi = sg_ops.FusedEpilogue(
            scale=torch.as_tensor(rng.uniform(0.5, 1.5, c_out), device=dev),
            shift=torch.as_tensor(rng.uniform(-0.5, 0.5, c_out), device=dev),
            valid=valid)
    row_nz = sparsity.row_nonzero(f)
    before = sg_kernel.launches
    got = sg_ops.apply_tiles(f, w, tiles, n_out=n, row_nz=row_nz,
                             epilogue=epi)
    torch.cuda.synchronize()
    assert sg_kernel.launches == before + 1
    want = sg_ops.apply_tiles(f, w, tiles, n_out=n, row_nz=row_nz,
                              epilogue=epi, impl="ref")
    if epilogue:
        (got, act), (want, _) = got, want
        nzb = torch.nn.functional.pad(got, (0, -c_out % 128))
        sweep = (nzb.reshape(n, -1, 128) != 0).any(-1)
        assert torch.equal(act.blk_nz, sweep)
    err = (got - want).abs().max().item() if got.numel() else 0.0
    assert err <= TOL * max(1.0, want.abs().max().item())
    return got


def _subm_kmap(n, extent, n_valid, seed=1):
    c, b, v = _cloud(np.random.default_rng(seed), n, extent, n_valid)
    return mapsearch.build_kmap_hash(c, b, v, morton.subm3_offsets())


def test_gemm_stem_cin4(cuda):
    _check_gemm(cuda, _subm_kmap(3000, 20, 2500), 4, 32, bm=128, bo=512)


@pytest.mark.parametrize("c_in,c_out", [(64, 64), (160, 128), (320, 192)])
def test_gemm_wide_layers(cuda, c_in, c_out):
    _check_gemm(cuda, _subm_kmap(2500, 18, 2000), c_in, c_out, bm=128,
                bo=512)


def test_gemm_all_dead_tiles(cuda):
    got = _check_gemm(cuda, _subm_kmap(1500, 16, 1200), 64, 128, bm=128,
                      bo=512, dead_rows=1.0)
    assert not got.any()


def test_gemm_empty_output_blocks(cuda):
    # a Gconv2 kmap over a mostly empty budget: most output blocks have no
    # map at all and get a single all-pad tile
    c, b, v = _cloud(np.random.default_rng(2), 8192, 40, 1500)
    c, b, v = _dev(cuda, c, b, v)
    maps = mapsearch.build_maps_gconv2(c, b, v)
    kmap = mapsearch.strided_to_kmap(maps, n_out=8192, n_taps=8)
    _check_gemm(cuda, kmap.cpu().numpy(), 128, 256, bm=128, bo=512)


@pytest.mark.parametrize("bm,bo", [(32, 64), (96, 192), (128, 128)])
def test_gemm_tile_heights(cuda, bm, bo):
    _check_gemm(cuda, _subm_kmap(1200, 14, 1000), 32, 128, bm=bm, bo=bo)


@pytest.mark.parametrize("c_in,c_out", [(4, 32), (128, 256), (192, 200)])
def test_gemm_epilogue(cuda, c_in, c_out):
    _check_gemm(cuda, _subm_kmap(2000, 16, 1700), c_in, c_out, bm=128,
                bo=512, epilogue=True)


def test_gemm_kernel_vs_plain_full_output(cuda):
    """The raw wrapper output, every padded row included."""
    kmap = torch.as_tensor(_subm_kmap(700, 12, 600), device=cuda)
    tiles = sg_ops.build_tap_tiles(kmap, bm=64, bo=128)
    rng = np.random.default_rng(3)
    f, w = _dev(cuda, rng.standard_normal((700, 64)).astype(np.float32),
                rng.standard_normal((27, 64, 128)).astype(np.float32))
    args = (f, w, tiles.gather_idx, tiles.scatter_idx, tiles.tile_tap,
            tiles.tile_nz, tiles.tile_ob)
    got = sg_kernel.spconv_gemm_fused(*args, bm=64, bo=128, n_out_pad=768)
    want = spconv_gemm_fused_ref(*args, bm=64, bo=128, n_out_pad=768)
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()


@contextlib.contextmanager
def _max_splits(n):
    """The fused wrapper with at most n CTAs per output block."""
    old, sg_kernel.MAX_SPLITS = sg_kernel.MAX_SPLITS, n
    try:
        yield
    finally:
        sg_kernel.MAX_SPLITS = old


def _fused(dev, kmap, c_in, c_out, *, bm, bo, splits, dead_rows=0.25,
           epilogue=False, seed=0):
    """The fused wrapper with at most ``splits`` CTAs per output block
    against its
    plain version on the raw padded output (and, with the epilogue, the
    liveness against a sweep of the kernel's own output). Returns the
    wrapper's arguments and the kernel output."""
    rng = np.random.default_rng(seed)
    n = kmap.shape[0]
    f = np.maximum(rng.standard_normal((n, c_in)), 0).astype(np.float32)
    f[rng.random(n) < dead_rows] = 0.0
    w = rng.standard_normal((kmap.shape[1], c_in, c_out)).astype(np.float32)
    f, w, km = _dev(dev, f, w, kmap)
    tiles = sg_ops.build_tap_tiles(km, bm=bm, bo=bo)
    epi = None
    if epilogue:
        epi = sg_ops.FusedEpilogue(
            scale=torch.as_tensor(rng.uniform(0.5, 1.5, c_out), device=dev),
            shift=torch.as_tensor(rng.uniform(-0.5, 0.5, c_out), device=dev),
            valid=torch.as_tensor(rng.random(n) < 0.9, device=dev))
    args, kw = sg_ops.kernel_inputs(f, w, tiles, n_out=n,
                                    row_nz=sparsity.row_nonzero(f),
                                    epilogue=epi)
    before = (sg_kernel.launches, sg_kernel.reduce_launches,
              sg_kernel.plan_launches)
    with _max_splits(splits):
        got = sg_kernel.spconv_gemm_fused(*args, **kw)
    torch.cuda.synchronize()
    assert sg_kernel.launches == before[0] + 1
    assert sg_kernel.reduce_launches == before[1] + int(splits > 1)
    assert sg_kernel.plan_launches == before[2] + 1
    want = spconv_gemm_fused_ref(*args, **kw)
    if epilogue:
        (got, nz), (want, _) = got, want
        sweep = (got.reshape(got.shape[0], -1, 128) != 0).any(-1)
        assert torch.equal(nz, sweep.int())
    _close(got, want)
    return args, kw, got


def _group_kmap(count, bo, n_blocks, seed=4):
    """A kmap in which every (output block, tap 0) group holds exactly
    ``count`` maps (the block's first rows), tap 1 the block's other rows,
    and tap 2 one map per block."""
    rng = np.random.default_rng(seed)
    n = bo * n_blocks
    km = np.full((n, 3), -1, np.int32)
    local = np.arange(n) % bo
    km[local < count, 0] = rng.integers(0, n, int((local < count).sum()))
    km[local >= count, 1] = rng.integers(0, n, int((local >= count).sum()))
    km[local == bo - 1, 2] = rng.integers(0, n, n_blocks)
    return km


@pytest.mark.parametrize("count", [1, 15, 16, 17, 127, 128])
@pytest.mark.parametrize("splits", [1, 2])
def test_gemm_group_live_counts(cuda, count, splits):
    """The kernel multiplies each tile only up to its last valid slot, in
    16-row fragments: group sizes at and around the fragment and tile
    edges."""
    _fused(cuda, _group_kmap(count, 256, 6), 64, 128, bm=128, bo=256,
           splits=splits, dead_rows=0.0)


def _empty_block_kmap(dev):
    c, b, v = _cloud(np.random.default_rng(2), 8192, 40, 1500)
    c, b, v = _dev(dev, c, b, v)
    maps = mapsearch.build_maps_gconv2(c, b, v)
    return mapsearch.strided_to_kmap(maps, n_out=8192,
                                     n_taps=8).cpu().numpy()


@pytest.mark.parametrize("splits", [1, 2, 64])
@pytest.mark.parametrize("case", ["empty_blocks", "all_dead", "subm"])
def test_gemm_splits(cuda, splits, case):
    """At most 1, 2 and more CTAs per block than the tiles of any run, over
    empty output blocks (their CTA walks no tile and must give zeros),
    all-dead tiles and a Subm3 layer."""
    if case == "empty_blocks":
        kmap, dead = _empty_block_kmap(cuda), 0.25
    else:
        kmap, dead = _subm_kmap(1500, 16, 1200), float(case == "all_dead")
    _, _, got = _fused(cuda, kmap, 64, 128, bm=128, bo=512, splits=splits,
                       dead_rows=dead)
    if case == "all_dead":
        assert not got.any()


@pytest.mark.parametrize("bm,bo", [(32, 64), (96, 192), (32, 192),
                                   (96, 64)])
@pytest.mark.parametrize("splits", [1, 3])
def test_gemm_split_tile_heights(cuda, bm, bo, splits):
    _fused(cuda, _subm_kmap(1200, 14, 1000), 32, 128, bm=bm, bo=bo,
           splits=splits)


@pytest.mark.parametrize("c_in,c_out", [(4, 32), (160, 128), (320, 192)])
@pytest.mark.parametrize("splits", [1, 4])
def test_gemm_split_widths(cuda, c_in, c_out, splits):
    _fused(cuda, _subm_kmap(2000, 16, 1700), c_in, c_out, bm=128, bo=512,
           splits=splits)


@pytest.mark.parametrize("c_in,c_out", [(4, 32), (128, 256), (320, 192)])
def test_gemm_epilogue_split(cuda, c_in, c_out):
    """The epilogue after the split-sum kernel: values and liveness."""
    _fused(cuda, _subm_kmap(2000, 16, 1700), c_in, c_out, bm=128, bo=512,
           splits=3, epilogue=True)


def test_gemm_tall_tiles(cuda):
    """bm = 256: each tile is walked as two 128-slot pieces."""
    _fused(cuda, _subm_kmap(3000, 14, 2600), 64, 128, bm=256, bo=512,
           splits=2)


@pytest.mark.parametrize("splits", [1, 3])
def test_gemm_bit_identical_repeats(cuda, splits):
    """No float atomics: the same layer twice gives the same bits."""
    args, kw, got = _fused(cuda, _subm_kmap(2500, 18, 2000), 128, 256,
                           bm=128, bo=512, splits=splits, epilogue=True)
    with _max_splits(splits):
        again = sg_kernel.spconv_gemm_fused(*args, **kw)
        third = sg_kernel.spconv_gemm_fused(*args, **kw)
    assert torch.equal(got, again[0]) and torch.equal(got, third[0])
    assert torch.equal(again[1], third[1])


@pytest.mark.parametrize("case", ["deep", "res0", "all_dead", "short"])
@pytest.mark.parametrize("max_splits", [1, 8, 64])
def test_split_plan_kernel_vs_plain(cuda, case, max_splits):
    """The planning kernel equals its plain version bit for bit: a deep
    layer (a dozen live blocks of 128, a long all-pad tail), a res-0 layer
    (every block live), all-dead tiles, and runs shorter than the cap."""
    rng = np.random.default_rng(len(case) + max_splits)
    n_blocks, n_slabs = 128, 4
    lengths = np.ones(n_blocks, np.int64)
    if case == "deep":
        lengths[:12] = rng.integers(20, 60, 12)
        lengths[-1] = 15000
    elif case == "short":
        n_blocks, n_slabs = 3, 1
        lengths = np.array([2, 1, 3])
    else:
        lengths[:] = rng.integers(20, 45, n_blocks)
        lengths[-1] = 5000
    ob = np.repeat(np.arange(n_blocks), lengths).astype(np.int32)
    nz = (rng.random(ob.size) < 0.8).astype(np.int32)
    nz[np.isin(ob, np.arange(12, n_blocks)) & (case == "deep")] = 0
    if ob.size > 4000:
        nz[-4000:] = 0                    # the all-pad tail of the last run
    if case == "all_dead":
        nz[:] = 0
    tile_ob, tile_nz = _dev(cuda, ob, nz)
    n_ctas, busy_min = sg_kernel.plan_shape(n_blocks, n_slabs, 132,
                                            max_splits)
    kw = dict(n_blocks=n_blocks, n_ctas=n_ctas, max_splits=max_splits,
              busy_min=busy_min)
    before = sg_kernel.plan_launches
    work, blk = sg_kernel.split_plan(tile_ob, tile_nz, **kw)
    torch.cuda.synchronize()
    assert sg_kernel.plan_launches == before + 1
    want_work, want_blk = sg_kernel.split_plan_ref(tile_ob, tile_nz, **kw)
    assert torch.equal(work, want_work) and torch.equal(blk, want_blk)
    if case == "deep" and max_splits > 1:
        assert int(blk[:12, 1].min()) > 1


def test_wrappers_make_no_host_sync(cuda):
    """The kernel 2 and kernel 4 wrappers only enqueue work: under the sync
    debug mode "error" any host synchronisation would raise."""
    kmap = torch.as_tensor(_subm_kmap(1500, 16, 1200), device=cuda)
    tiles = sg_ops.build_tap_tiles(kmap, bm=128, bo=512)
    rng = np.random.default_rng(6)
    f, w = _dev(cuda, rng.standard_normal((1500, 64)).astype(np.float32),
                rng.standard_normal((27, 64, 128)).astype(np.float32))
    args, kw = sg_ops.kernel_inputs(f, w, tiles, n_out=1500)
    a, b = _dev(cuda, rng.standard_normal((256, 128)).astype(np.float32),
                rng.standard_normal((128, 128)).astype(np.float32))
    mask = torch.ones((2, 1), dtype=torch.int32, device=cuda)
    # first calls build and load the kernels outside the checked region
    sg_kernel.spconv_gemm_fused(*args, **kw)
    mm_kernel.masked_matmul(a, b, mask)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for splits in (sg_kernel.MAX_SPLITS, 1, 3):
            with _max_splits(splits):
                sg_kernel.spconv_gemm_fused(*args, **kw)
        mm_kernel.masked_matmul(a, b, mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _close(got, want):
    err = (got - want).abs().max().item() if got.numel() else 0.0
    assert err <= TOL * max(1.0, want.abs().max().item())


def _check_materialized(dev, kmap, c_in, c_out, *, bm, dead_rows=0.25,
                        seed=0):
    """The materialized kernel against its plain version on the raw
    (M_pad, Cout_pad) partial products, with every third live tile marked
    dead although its lhs rows are nonzero (the kernel must give zeros
    there, not the product), then apply_kmap against the fused path."""
    rng = np.random.default_rng(seed)
    n = kmap.shape[0]
    f = rng.standard_normal((n, c_in)).astype(np.float32)
    f[rng.random(n) < dead_rows] = 0.0
    w = rng.standard_normal((kmap.shape[1], c_in, c_out)).astype(np.float32)
    f, w, km = _dev(dev, f, w, kmap)
    row_nz = sparsity.row_nonzero(f)
    tiles = sg_ops.build_tap_tiles(km, row_nz, bm=bm)
    lhs = f[tiles.gather_idx.long()]
    lhs.masked_fill_(~tiles.slot_valid[:, None], 0.0)
    wp = torch.nn.functional.pad(w, (0, -c_out % 128)).contiguous()
    nz = tiles.tile_nz.clone()
    killed = torch.nonzero(nz).squeeze(1)[::3]
    nz[killed] = 0
    lhs_t = lhs.reshape(-1, bm, c_in)
    assert all(bool(lhs_t[t].any()) for t in killed.tolist())
    before = sg_kernel.materialized_launches
    got = sg_kernel.spconv_gemm(lhs, wp, tiles.tile_tap, nz, bm=bm)
    torch.cuda.synchronize()
    assert sg_kernel.materialized_launches == before + 1
    want = spconv_gemm_ref(lhs, wp, tiles.tile_tap, nz, bm=bm)
    _close(got, want)
    dead = (nz == 0).repeat_interleave(bm)
    assert int(dead.sum()) > 0 and not got[dead].any()
    assert dead_rows == 1.0 or killed.numel() > 0
    out = sg_ops.apply_kmap(f, w, km, bm=bm)
    fused = sg_ops.apply_tiles(f, w, sg_ops.build_tap_tiles(km, bm=bm),
                               n_out=n, row_nz=row_nz)
    _close(out, fused)
    return got


def test_materialized_stem_cin4(cuda):
    _check_materialized(cuda, _subm_kmap(3000, 20, 2500), 4, 32, bm=128)


@pytest.mark.parametrize("c_in,c_out", [(64, 64), (512, 512), (320, 192)])
def test_materialized_wide_layers(cuda, c_in, c_out):
    _check_materialized(cuda, _subm_kmap(2500, 18, 2000), c_in, c_out,
                        bm=128)


def test_materialized_all_dead_tiles(cuda):
    got = _check_materialized(cuda, _subm_kmap(1500, 16, 1200), 64, 128,
                              bm=128, dead_rows=1.0)
    assert not got.any()


@pytest.mark.parametrize("bm", [32, 96, 256])
def test_materialized_tile_heights(cuda, bm):
    _check_materialized(cuda, _subm_kmap(1200, 14, 1000), 32, 128, bm=bm)


def _check_k3_layout(dev, taps, live, *, c_in, c_out_pad, bm, seed=0):
    """The materialized kernel on a layout given tile by tile (``taps``,
    ``live``), lhs and weights drawn from ``seed`` with the dead tiles' rows
    nonzero too: within 1e-4 of the plain version, the dead tiles exact
    zeros, one launch."""
    rng = np.random.default_rng(seed)
    lhs = rng.standard_normal((len(taps) * bm, c_in)).astype(np.float32)
    w = rng.standard_normal((max(taps) + 1, c_in, c_out_pad)).astype(
        np.float32)
    lhs, w = _dev(dev, lhs, w)
    tap = torch.tensor(taps, dtype=torch.int32, device=dev)
    nz = torch.tensor(live, dtype=torch.int32, device=dev)
    before = sg_kernel.materialized_launches
    got = sg_kernel.spconv_gemm(lhs, w, tap, nz, bm=bm)
    torch.cuda.synchronize()
    assert sg_kernel.materialized_launches == before + 1
    _close(got, spconv_gemm_ref(lhs, w, tap, nz, bm=bm))
    dead = (nz == 0).repeat_interleave(bm)
    assert not got[dead].any()


def test_materialized_deep_cin(cuda):
    # 72 ring steps of 32 a CTA
    _check_k3_layout(cuda, [0, 0, 1, 2, 2, 2], [1, 0, 1, 1, 1, 0],
                     c_in=2304, c_out_pad=256, bm=128)


def test_materialized_cin38(cuda):
    # rows of 152 bytes: 4-byte copies, a ragged last Cin step
    _check_materialized(cuda, _subm_kmap(1200, 14, 1000), 38, 128, bm=128)


def test_materialized_same_tap_run(cuda):
    # six consecutive tiles of tap 3 (one dead inside the run), then four
    # of tap 1 and two of tap 3 again
    _check_k3_layout(cuda, [3] * 6 + [1] * 4 + [3] * 2,
                     [1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 0, 1],
                     c_in=256, c_out_pad=512, bm=128, seed=1)


@pytest.mark.parametrize("bm", [8, 128])
def test_materialized_all_live(cuda, bm):
    taps = np.random.default_rng(bm).integers(0, 27, 40).tolist()
    _check_k3_layout(cuda, taps, [1] * 40, c_in=64, c_out_pad=128, bm=bm,
                     seed=2)


def test_materialized_wide_cout(cuda):
    # nine 128-column slabs
    _check_k3_layout(cuda, [0, 1, 1, 2, 3, 3, 3], [1, 1, 0, 1, 1, 0, 1],
                     c_in=96, c_out_pad=1152, bm=128, seed=3)


def _check_masked(dev, a, b, mask, *, bm, bn, bk):
    a, b = _dev(dev, a, b)
    mask = mask.to(dev)
    before = mm_kernel.launches
    got = mm_kernel.masked_matmul(a, b, mask, bm=bm, bn=bn, bk=bk)
    torch.cuda.synchronize()
    assert mm_kernel.launches == before + 1
    want = masked_matmul_ref(a, b, mask, bm=bm, bk=bk)
    _close(got, want)
    return got, want


def _tiled(rng, m, k, bm, bk, dead):
    a = rng.standard_normal((m, k)).astype(np.float32)
    kill = np.repeat(np.repeat(rng.random((m // bm, k // bk)) < dead, bm, 0),
                     bk, 1)
    a[kill] = 0.0
    return a


@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (4096, 512, 512, 128, 128, 128),     # Cin = Cout = 512
    (1024, 128, 128, 128, 128, 128),     # the stem's Cin = 4 padded to 128
    (96, 96, 48, 16, 16, 48),            # steps straddle live and dead
    (256, 64, 40, 8, 8, 8)])
def test_masked_matmul_kills_nonzero_tile(cuda, m, k, n, bm, bn, bk):
    rng = np.random.default_rng(m + k)
    a = _tiled(rng, m, k, bm, bk, dead=0.4)
    if m == 1024:
        a[:, 4:] = 0.0
    b = rng.standard_normal((k, n)).astype(np.float32)
    mask = sparsity.block_mask(torch.as_tensor(a), bm, bk).int()
    live = torch.nonzero(mask)
    i, j = live[len(live) // 2].tolist()
    assert np.abs(a[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk]).max() > 0
    mask[i, j] = 0                        # a caller's mask kills it
    got, _ = _check_masked(cuda, a, b, mask, bm=bm, bn=bn, bk=bk)
    full = torch.as_tensor(a, device=cuda) @ torch.as_tensor(b, device=cuda)
    assert (got - full).abs().max().item() > 1e-3


@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (200, 52, 72, 8, 8, 4),              # every step straddles tiles
    (96, 50, 30, 16, 10, 2),             # K, N not multiples of 4
    (384, 96, 136, 64, 8, 48),           # bk straddles the 32-wide steps
    (260, 68, 132, 20, 12, 17),          # bm straddles 128 rows, bk odd
    (640, 160, 264, 128, 8, 32)])        # ragged N past two CTA columns
def test_masked_matmul_straddling_and_ragged(cuda, m, k, n, bm, bn, bk):
    rng = np.random.default_rng(m * k + n)
    a = _tiled(rng, m, k, bm, bk, dead=0.5)
    b = rng.standard_normal((k, n)).astype(np.float32)
    mask = sparsity.block_mask(torch.as_tensor(a), bm, bk).int()
    # a caller's mask that also kills a third of the nonzero tiles
    live = torch.nonzero(mask)
    for i, j in live[::3].tolist():
        mask[i, j] = 0
    _check_masked(cuda, a, b, mask, bm=bm, bn=bn, bk=bk)


def test_masked_matmul_all_dead(cuda):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((512, 256)).astype(np.float32)
    b = rng.standard_normal((256, 128)).astype(np.float32)
    got, _ = _check_masked(cuda, a, b, torch.zeros(4, 2, dtype=torch.int32),
                           bm=128, bn=128, bk=128)
    assert not got.any()


@pytest.mark.parametrize("m,k,n", [(130, 70, 50), (65536, 4, 32),
                                   (1000, 513, 200)])
def test_sparse_dense_matmul_non_multiple(cuda, m, k, n):
    rng = np.random.default_rng(m)
    a = rng.standard_normal((m, k)).astype(np.float32)
    a[rng.random(m) < 0.5] = 0.0
    a[m // 2:] = 0.0
    b = rng.standard_normal((k, n)).astype(np.float32)
    a, b = _dev(cuda, a, b)
    before = mm_kernel.launches
    got = mm_ops.sparse_dense_matmul(a, b)
    torch.cuda.synchronize()
    assert mm_kernel.launches == before + 1 and got.shape == (m, n)
    # the CPU route of the wrapper is the plain version
    _close(got, mm_ops.sparse_dense_matmul(a.cpu(), b.cpu()).to(cuda))
    _close(got, a @ b)


# the bf16 route's blocks: 128 q rows and 128 keys (64 and 64 at D = 256)
_FLASH_EDGES = (
    [(1, 4, 2, s, s, d, True, 0) for s in (1, 64, 65, 127, 128, 129)
     for d in fa_kernel.HEAD_DIMS]
    + [(1, 4, 2, 249, 256, d, True, 0) for d in fa_kernel.HEAD_DIMS]
    + [(1, 4, 2, 200, 200, d, True, 1) for d in (64, 256)]    # window 1
    + [(1, 32, 1, 130, 130, d, True, 0) for d in (64, 128)])  # Hq/Hkv 32


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", [
    (2, 8, 2, 256, 256, 64, True, 0),
    (1, 4, 4, 200, 200, 80, False, 0),       # hubert: no mask, ragged
    (1, 4, 2, 256, 256, 128, True, 0),
    (1, 4, 1, 256, 256, 256, True, 100),     # recurrentgemma: MQA + window
    (1, 4, 2, 256, 256, 64, True, 20),       # window < one KV block
    (2, 8, 2, 100, 333, 128, True, 0),       # Sq < Skv, ragged edges
    (1, 8, 1, 128, 128, 64, True, 0),        # MQA
    (1, 4, 2, 64, 300, 64, True, 40),        # leading blocks fully masked
    *_FLASH_EDGES,
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_vs_plain(cuda, b, hq, hkv, sq, skv, d,
                                         causal, window, dtype):
    _check_flash(cuda, b, hq, hkv, sq, skv, d, causal, window, dtype)


def _f32_blocks(d):
    """(q rows, keys) of a block of the float32 route at head dim d."""
    return (64, 32) if d == 256 else (128, 64)


# the float32 route's blocks: a q block of warps of 16 rows, and KV tiles
# (_f32_blocks); each size one below, at and one above, at every D
_FLASH_F32_EDGES = (
    [(1, 4, 2, s, s, d, True, 0) for d in fa_kernel.HEAD_DIMS
     for s in sorted({15, 16, 17} | {n + e for n in _f32_blocks(d)
                                      for e in (-1, 0, 1)})]
    + [(1, 4, 2, 200, 200, d, True, 1) for d in fa_kernel.HEAD_DIMS]
    # Sq < Skv: the leading KV blocks outside the band, and tiles that
    # some warps of the q block see and others skip
    + [(1, 4, 2, 128, 300, d, True, 20) for d in fa_kernel.HEAD_DIMS]
    + [(2, 8, 2, 100, 333, d, True, 0) for d in fa_kernel.HEAD_DIMS]
    + [(1, 4, 4, 33, 97, d, False, 0) for d in fa_kernel.HEAD_DIMS])


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window",
                         _FLASH_F32_EDGES)
def test_flash_attention_f32_route_edges(cuda, b, hq, hkv, sq, skv, d,
                                         causal, window):
    _check_flash(cuda, b, hq, hkv, sq, skv, d, causal, window,
                 torch.float32)


def _check_flash(cuda, b, hq, hkv, sq, skv, d, causal, window, dtype):
    g = torch.Generator(device=cuda).manual_seed(sq + skv + d)
    q = torch.randn((b, hq, sq, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, hkv, skv, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, hkv, skv, d), generator=g, device=cuda).to(dtype)
    before = fa_kernel.launches
    got = fa_kernel.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_kernel.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and torch.isfinite(got).all()
    rtol, atol = (2.0 ** -7, 2e-3) if dtype == torch.bfloat16 else (2e-5,
                                                                      2e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_flash_attention_rejects_misaligned_bf16(cuda):
    """TMA needs a 16-byte-aligned base: a contiguous bf16 view 8 bytes
    into its storage raises before any launch."""
    n = 1 * 2 * 64 * 64
    buf = torch.zeros(n + 4, dtype=torch.bfloat16, device=cuda)
    q = buf[4:].view(1, 2, 64, 64)
    k = v = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16, device=cuda)
    assert q.is_contiguous() and q.data_ptr() % 16 == 8
    before = fa_kernel.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa_kernel.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa_kernel.flash_attention(k, k, q)
    assert fa_kernel.launches == before


def test_lm_prefill_kernel_vs_plain(cuda):
    """Four TinyLlama layers at full width: every prefill layer launches
    the kernel, and the logits agree with the plain-version prefill."""
    import dataclasses
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=4,
                              dtype="float32")
    model = transformer.DecoderLM(
        cfg, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 100)), device=cuda)
    before = fa_kernel.launches
    got, cache = transformer.prefill(model.params(), toks, cfg,
                                     max_context=128)
    torch.cuda.synchronize()
    assert fa_kernel.launches == before + cfg.n_layers
    want, _ = transformer.prefill(model.params(), toks, cfg,
                                  max_context=128, impl="ref")
    assert cache["k"].shape == (4, 2, 128, 4, 64)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-3 * scale


#: narrow configs of the families with attention, at their real head dims
#: (RecurrentGemma 256 with MQA and a window the prompt passes, HuBERT 80
#: non-causal, LLaVA 128 with GQA): (arch, replacements, launches a prefill)
FAMILY_CARD_CFGS = [
    ("recurrentgemma-2b", dict(n_layers=4, d_model=512, n_heads=2,
                               n_kv_heads=1, d_ff=1024, vocab=1000,
                               lru_width=512, local_window=64), 1),
    ("hubert-xlarge", dict(n_layers=2, d_model=320, n_heads=4, n_kv_heads=4,
                           d_ff=640, frontend_dim=64), 2),
    ("llava-next-mistral-7b", dict(n_layers=2, d_model=512, n_heads=4,
                                   n_kv_heads=2, d_ff=1024, vocab=1000,
                                   n_patches=40, vision_dim=64), 2),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,repl,launches", FAMILY_CARD_CFGS)
def test_family_prefill_kernel_vs_plain(cuda, arch, repl, launches, dtype):
    """A narrow two-attention-layer (RecurrentGemma: one group and a tail
    layer) model of each family with attention: the prefill (the
    encoder's encode) through the kernel against the same through the
    plain version, 1e-3 x max in float32, 2e-2 in bf16."""
    import dataclasses
    from repro_torch.models import api
    cfg = dataclasses.replace(get_config(arch), dtype=dtype, **repl)
    model = api.build_model(cfg, device=cuda)
    params = model.init(torch.Generator(cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    if cfg.family == "encoder":
        batch = {"frames": torch.as_tensor(rng.standard_normal(
            (2, 150, cfg.frontend_dim)), device=cuda).to(getattr(torch,
                                                                 dtype))}
    else:
        batch = {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab, (2, 150)), device=cuda)}
        if cfg.family == "vlm":
            batch["patches"] = torch.as_tensor(rng.standard_normal(
                (2, cfg.n_patches, cfg.vision_dim)), device=cuda).to(
                getattr(torch, dtype))
    before = fa_kernel.launches
    got = model.prefill(params, batch, 256)
    torch.cuda.synchronize()
    assert fa_kernel.launches == before + launches
    want = model.prefill(params, batch, 256, impl="ref")
    assert fa_kernel.launches == before + launches
    if cfg.family != "encoder":
        got, want = got[0], want[0]
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-3 if dtype == "float32" else 2e-2
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol * scale


def test_mamba2_on_card_matches_cpu_and_decodes_short_prompt(cuda):
    """A narrow two-layer Mamba2 (64-token chunks) in float32: the card's
    prefill of a 100-token prompt (not a chunk multiple) equals the CPU's
    on the same weights (1e-4 x max), no kernel launches, and a 2-token
    prompt decodes 3 steps, each held to the teacher-forced prefill."""
    import dataclasses
    from repro_torch.models import mamba2
    cfg = dataclasses.replace(get_config("mamba2-2.7b"), n_layers=2,
                              d_model=256, vocab=1000, ssm_state=64,
                              ssm_chunk=64, dtype="float32")
    lm = mamba2.Mamba2LM(cfg, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(0))
    params = lm.params()
    cpu = {k: v.cpu() for k, v in lm.state_dict().items()}
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 100)))
    before = fa_kernel.launches
    got, _ = mamba2.prefill(params, toks.to(cuda), cfg, max_context=128)
    want, _ = mamba2.prefill(mamba2.common.nest_params(cpu), toks, cfg,
                             max_context=128)
    assert fa_kernel.launches == before
    assert (got.cpu() - want).abs().max().item() <= \
        1e-4 * want.abs().max().item()
    seq = toks[:, :2].to(cuda)
    logits, cache = mamba2.prefill(params, seq, cfg, max_context=8)
    for _ in range(3):
        nxt = logits.reshape(2, -1).argmax(-1)[:, None]
        seq = torch.cat([seq, nxt], 1)
        logits, cache = mamba2.decode_step(params, cache, nxt, cfg)
        full, _ = mamba2.prefill(params, seq, cfg, max_context=8)
        assert (logits[:, 0] - full).abs().max().item() <= \
            1e-4 * full.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_function_grad_on_card(cuda, dtype):
    """The forward launches the kernel once; the gradients are the plain
    version's VJP from the same q, k, v (the same math on the same card)."""
    from repro_torch.kernels.flash_attention import ops as attn_ops
    g = torch.Generator(device=cuda).manual_seed(3)
    shapes = ((2, 8, 200, 128), (2, 2, 200, 128), (2, 2, 200, 128))
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               .requires_grad_() for s in shapes)
    ct = torch.randn(shapes[0], generator=g, device=cuda).to(dtype)
    before = fa_kernel.launches
    out = attn_ops.attention(q, k, v, window=64)
    got = torch.autograd.grad(out, (q, k, v), ct)
    torch.cuda.synchronize()
    assert fa_kernel.launches == before + 1
    want_out = attention_ref(q, k, v, window=64)
    want = torch.autograd.grad(want_out, (q, k, v), ct)
    rtol, atol = (2.0 ** -7, 2e-3) if dtype == torch.bfloat16 else (2e-5,
                                                                      2e-5)
    torch.testing.assert_close(out.float(), want_out.float(), rtol=rtol,
                               atol=atol)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert (a.float() - b.float()).abs().max().item() <= \
            1e-5 * b.float().abs().max().item()


def test_moe_ffn_on_card_matches_cpu(cuda):
    import dataclasses
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              capacity_factor=1.25)
    gen = torch.Generator().manual_seed(2)
    params = moe.init_moe(gen, cfg, torch.float32)
    x = (torch.randn((2, 40, cfg.d_model), generator=gen)
         + 1.5 * torch.randn(cfg.d_model, generator=gen))
    ct = torch.randn(x.shape, generator=gen)
    logits = x @ params["router"]
    cap = moe.capacity(cfg, x.shape[1])
    want = moe._dispatch_one(x, logits, cfg.top_k, cfg.n_experts, cap)
    got = moe._dispatch_one(x.to(cuda), logits.to(cuda), cfg.top_k,
                            cfg.n_experts, cap)
    # the integers bit for bit; the gates are a softmax, whose exp differs
    # between the card and the CPU in the last bit
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[2].cpu(), want[2])
    assert torch.equal(got[1].cpu() == 0, want[1] == 0)
    np.testing.assert_array_max_ulp(got[1].cpu().numpy(), want[1].numpy(),
                                    maxulp=2)

    def run(dev):
        p = {k: v.to(dev).requires_grad_() for k, v in params.items()}
        xx = x.to(dev).requires_grad_()
        out, m = moe.moe_ffn(p, xx, cfg)
        grads = torch.autograd.grad((out * ct.to(dev)).sum() + m["moe_aux"],
                                    [xx, *p.values()])
        return out, m, grads

    out, m, grads = run("cpu")
    cout, cm, cgrads = run(cuda)
    assert float(m["moe_drop_frac"]) > 0
    assert float(cm["moe_drop_frac"]) == float(m["moe_drop_frac"])
    for a, b in ((cout, out), (cm["moe_aux"], m["moe_aux"]),
                 *zip(cgrads, grads)):
        assert (a.detach().cpu() - b).abs().max().item() <= \
            1e-4 * b.abs().max().item()


def test_mixtral_lm_loss_kernel_vs_plain_on_card(cuda):
    """Two Mixtral layers (head_dim 128, GQA 8/2, a 64-token window) in
    float32: the kernel path's loss and gradients against the plain
    version's; 2 launches a layer under remat ``full`` (forward and its
    recomputation)."""
    import dataclasses
    from repro_torch.launch import train
    from repro_torch.models import api
    cfg = dataclasses.replace(
        get_config("mixtral-8x7b"), n_layers=2, d_model=512, n_heads=8,
        n_kv_heads=2, d_ff=1024, vocab=1000, swa_window=64, dtype="float32")
    model = api.build_model(cfg, device=cuda)
    params, _ = train.init_state(model, seed=1)
    batch = {"tokens": np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 150)).astype(np.int32)}
    before = fa_kernel.launches
    lk, mk, gk = train.lm_loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    assert fa_kernel.launches == before + 2 * cfg.n_layers
    lr, mr, gr = train.lm_loss_and_grads(model, params, batch, impl="ref")
    assert fa_kernel.launches == before + 2 * cfg.n_layers
    assert abs(lk.item() - lr.item()) <= 1e-4 * abs(lr.item())
    for key, g in gr.items():
        assert (gk[key] - g).norm().item() <= 1e-3 * g.norm().item(), key
    assert gr["layers.0.moe.router"].abs().max().item() > 0


def _gconv3_inputs(dev, case):
    """A cloud whose Gconv3 output rows lie above its input rows (sparse:
    the build overflows its row budget and replans at the true output
    count, which is not a multiple of 128) or below them (dense: an
    explicit budget a little above the true count), with features whose
    first quarter of rows is zero."""
    from repro_torch.core.spconv import SparseTensor
    rng = np.random.default_rng(11)
    if case == "n_out_above_n_in":
        c, b, v = _cloud(rng, 3001, 200, 2900, batch=2)
    else:
        c, b, v = _cloud(rng, 4003, 16, 3900, batch=2)
    f = rng.standard_normal((c.shape[0], 32)).astype(np.float32)
    f[~v] = 0.0
    f[: c.shape[0] // 4] = 0.0
    w = (rng.standard_normal((27, 32, 64)) / 30).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    st = SparseTensor(*_dev(dev, c, b, v, f))
    return st, torch.as_tensor(w, device=dev), torch.as_tensor(bias,
                                                               device=dev)


@pytest.mark.parametrize("case", ["n_out_above_n_in", "n_out_below_n_in"])
def test_gconv3_output_stationary_kernel_vs_plain(cuda, case):
    """The output-stationary Gconv3 through kernel 2 with an output row
    count other than its input's: the plan equal to the CPU's bit for bit,
    one launch, the output within 1e-4 of the plain version's scale, and
    the gradients (``dfeats`` with the input's rows) of the plain math."""
    from repro_torch.core import plan as planlib, spconv
    st, w, bias = _gconv3_inputs(cuda, case)
    n_in = st.n_max
    if case == "n_out_above_n_in":
        _, maps = spconv.gconv3(st, w, bias, impl="kernel")
        budget = int(maps.n_true)
        assert budget > n_in and budget % 128 != 0
    else:
        n_true = int(mapsearch.build_maps_gconv3(
            st.coords, st.batch, st.valid, out_budget=n_in).n_true)
        budget = n_true + 5
        assert budget < n_in
    plan = planlib.gconv3_plan(st.coords, st.batch, st.valid,
                               out_budget=budget)
    cpu = planlib.gconv3_plan(*(t.cpu() for t in (st.coords, st.batch,
                                                  st.valid)),
                              out_budget=budget)
    assert torch.equal(plan.kmap.cpu(), cpu.kmap)
    for f in plan.tiles._fields[:-1]:
        assert torch.equal(getattr(plan.tiles, f).cpu(),
                           getattr(cpu.tiles, f)), f
    outs = {}
    for impl in ("kernel", "ref"):
        ft = st.feats.clone().requires_grad_()
        wt = w.clone().requires_grad_()
        before = sg_kernel.launches
        out = planlib.execute(plan, ft, wt, bias, spac=False, impl=impl)
        torch.cuda.synchronize()
        assert sg_kernel.launches - before == int(impl == "kernel")
        assert out.shape == (budget, 64)
        out.backward(torch.ones_like(out))
        assert ft.grad.shape == (n_in, 32)
        outs[impl] = (out.detach(), ft.grad, wt.grad)
    for got, want in zip(outs["kernel"], outs["ref"]):
        _close(got, want)


def _second_batch(dev, cfg, rows):
    from repro_torch.data import pointcloud
    vb = pointcloud.make_batch(np.random.default_rng(0), "lidar",
                               cfg.n_batch, rows)
    batch = {k: torch.as_tensor(np.array(v), device=dev)
             for k, v in vb._asdict().items()}
    g = torch.Generator(dev).manual_seed(0)
    hw = cfg.bev_hw
    batch["objectness"] = (torch.rand((cfg.n_batch, hw, hw), generator=g,
                                      device=dev) < 0.05).float()
    batch["boxes"] = torch.randn((cfg.n_batch, hw, hw, cfg.box_dim),
                                 generator=g, device=dev)
    return batch


_SECOND_SMALL = dict(channels=(32, 32, 64), blocks=1, bev_hw=64, head_ch=32)


def test_second_forward_kernel_vs_plain_on_card(cuda):
    """A small SECOND forward: kernel 1 once a stage, kernel 2 at every
    Subm3 and output-stationary Gconv3, and ``cls`` / ``box`` within 1e-3
    of the plain versions' max."""
    from repro_torch.core.spconv import SparseTensor
    from repro_torch.models import second
    cfg = second.SECONDConfig(**_SECOND_SMALL)
    model = second.SECOND(cfg, device=cuda)
    b = _second_batch(cuda, cfg, 8192)
    st = SparseTensor(b["coords"], b["batch"], b["valid"], b["feats"])
    k1, k2 = oct_kernel.launches, sg_kernel.launches
    got = model(st, impl="kernel")
    torch.cuda.synchronize()
    assert oct_kernel.launches - k1 == len(cfg.channels)
    assert sg_kernel.launches - k2 == len(cfg.channels) * cfg.blocks \
        + len(cfg.channels) - 1
    want = model(st, impl="ref")
    assert sg_kernel.launches - k2 == len(cfg.channels) * cfg.blocks \
        + len(cfg.channels) - 1
    for g, w in zip(got, want):
        scale = w.abs().max().item()
        assert scale > 0 and (g - w).abs().max().item() <= 1e-3 * scale


def test_detection_loss_grads_kernel_vs_plain_on_card(cuda, monkeypatch):
    """One ``detection_loss`` step of a small SECOND through the kernels
    against the plain versions: the loss within 1e-4 relative and each
    gradient within 1e-3 of its own max |g|, with the plain run's ReLU
    masks (sparse and RPN) pinned to the kernel run's: a pre-activation
    within rounding of zero can take the other side of a ReLU between the
    two runs and move a weight gradient by more than rounding. The flips
    of a free plain run stay below 1e-4 of the ReLU outputs. The conv
    biases (zero in exact arithmetic ahead of a training BatchNorm) stay
    below 1e-5 of the model's largest |g| on both sides."""
    from repro_torch.core import spconv
    from repro_torch.models import second
    cfg = second.SECONDConfig(**_SECOND_SMALL)
    model = second.SECOND(cfg, device=cuda)
    batch = _second_batch(cuda, cfg, 8192)
    sparse_relu, dense_relu = spconv.relu, second.rpn_relu
    masks = []

    def recording():
        def sparse(st):
            out = sparse_relu(st)
            masks.append(out.feats != 0)
            return out

        def dense(x):
            out = dense_relu(x)
            masks.append(out != 0)
            return out

        monkeypatch.setattr(spconv, "relu", sparse)
        monkeypatch.setattr(second, "rpn_relu", dense)

    recording()
    before = sg_kernel.launches
    lk, _, gk = second.loss_and_grads(model, batch, impl="kernel")
    n_layers = len(cfg.channels) * cfg.blocks + len(cfg.channels) - 1
    assert sg_kernel.launches - before == n_layers
    k_masks = list(masks)
    masks.clear()
    lu, _, _ = second.loss_and_grads(model, batch, impl="ref")
    flips = sum(int((a != b).sum()) for a, b in zip(k_masks, masks))
    assert len(masks) == len(k_masks) == len(cfg.channels) * (
        1 + cfg.blocks) + 2
    assert flips <= 1e-4 * sum(m.numel() for m in k_masks)
    pins = iter(k_masks)
    monkeypatch.setattr(spconv, "relu", lambda st: st.replace_feats(
        torch.where(next(pins), st.feats, 0.0)))
    monkeypatch.setattr(second, "rpn_relu",
                        lambda x: torch.where(next(pins), x, 0.0))
    _, _, gr = second.loss_and_grads(model, batch, impl="ref")
    assert sg_kernel.launches - before == n_layers
    assert torch.isfinite(lk) and abs(float(lk - lu)) <= 1e-4 * abs(
        float(lu))
    gmax = max(float(g.abs().max()) for g in gr.values())
    for k in gr:
        if k.endswith((".conv.b", ".mean", ".var")):
            assert max(float(gk[k].abs().max()),
                       float(gr[k].abs().max())) <= 1e-5 * gmax, k
        else:
            scale = float(gr[k].abs().max())
            assert scale > 0 and float((gk[k] - gr[k]).abs().max()) \
                <= 1e-3 * scale, k


def _sum_case(rng, counts, c=24, dropped=50):
    dst = np.concatenate([np.repeat(np.arange(len(counts)), counts),
                          rng.choice([-1, len(counts)], dropped)])
    rng.shuffle(dst)
    vals = (rng.standard_normal((dst.size, c))
            * 10.0 ** rng.integers(-4, 5, (dst.size, 1))).astype(np.float32)
    return vals, dst


def test_fixed_order_sums_on_card_equal_cpu(cuda):
    """``segment.ordered_sum`` and its backward, ``scatter_valid`` and
    ``to_bev`` on the card give their CPU results bit for bit: the same
    float32 adds in the same order. Over an index built beforehand the sum
    and its backward read nothing back to the host."""
    from repro_torch.core import segment
    from repro_torch.core.spconv import SparseTensor
    from repro_torch.models import second
    rng = np.random.default_rng(21)
    counts = rng.integers(0, 28, 3000)
    counts[[5, 900]] = (0, 300)
    vals, dst = _sum_case(rng, counts)
    outs = []
    for dev in ("cpu", cuda):
        v, d = _dev(dev, vals, dst)
        v.requires_grad_()
        seg = segment.segments((d, len(counts)))[0]
        g = torch.ones((len(counts), vals.shape[1]), device=dev)
        if dev != "cpu":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = segment.ordered_sum(v, seg)
            (gv,) = torch.autograd.grad(out, v, g)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        outs.append((out.detach().cpu(), gv.cpu()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)

    kmap = _subm_kmap(3000, 16, 2800)
    f = rng.standard_normal((3000, 8)).astype(np.float32)
    f[rng.random(3000) < 0.3] = 0.0
    tiles = sg_ops.build_tap_tiles(torch.as_tensor(kmap),
                                   sparsity.row_nonzero(torch.as_tensor(f)),
                                   bm=128)
    ps = rng.standard_normal((tiles.gather_idx.shape[0], 64)).astype(
        np.float32)
    want = sg_ops.scatter_valid(torch.as_tensor(ps), tiles, 3000)
    tc = sg_ops.TapTiles(*(t.to(cuda) if isinstance(t, torch.Tensor) else t
                           for t in tiles))
    got = sg_ops.scatter_valid(torch.as_tensor(ps, device=cuda), tc, 3000)
    assert torch.equal(got.cpu(), want)

    cfg = second.SECONDConfig(**_SECOND_SMALL)
    b = _second_batch("cpu", cfg, 8192)
    st = SparseTensor(b["coords"] // 8, b["batch"], b["valid"],
                      torch.randn((8192, 32)))
    want = second.to_bev(st, cfg)
    got = second.to_bev(SparseTensor(*_dev(cuda, *st)), cfg)
    assert torch.equal(got.cpu(), want)


def test_fixed_order_sums_bit_equal_across_runs_on_card(cuda):
    """Two runs on the card give the same bits: ``apply_kmap`` (kernel 3,
    then the fixed-order scatter), ``apply_maps_scatter`` with its
    gradients (whose backward reads nothing back to the host), and a
    small SECOND's forward (through the kernels and the plain versions)
    and ``detection_loss`` with every gradient."""
    from repro_torch.core import plan as planlib, rulebook, spconv
    from repro_torch.core.spconv import SparseTensor
    from repro_torch.models import second
    rng = np.random.default_rng(22)
    kmap = _subm_kmap(4000, 18, 3800, seed=3)
    f = rng.standard_normal((4000, 64)).astype(np.float32)
    w = rng.standard_normal((27, 64, 96)).astype(np.float32)
    f, w, km = _dev(cuda, f, w, kmap)
    before = sg_kernel.materialized_launches
    a, b = (sg_ops.apply_kmap(f, w, km) for _ in range(2))
    assert sg_kernel.materialized_launches == before + 2
    assert torch.equal(a, b)

    cfg = second.SECONDConfig(**_SECOND_SMALL)
    batch = _second_batch(cuda, cfg, 8192)
    st = SparseTensor(batch["coords"], batch["batch"], batch["valid"],
                      batch["feats"])
    plan = planlib.gconv3_plan(st.coords, st.batch, st.valid,
                               out_budget=65536, with_tiles=False)
    wg = torch.randn((27, 4, 32), device=cuda)
    runs = []
    for _ in range(2):
        ft = st.feats.float().clone().requires_grad_()
        wt = wg.clone().requires_grad_()
        out = rulebook.apply_maps_scatter(ft, wt, plan.maps, n_out=plan.n_out,
                                          n_taps=27)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            grads = torch.autograd.grad(out, (ft, wt), torch.ones_like(out))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        runs.append((out.detach(), *grads))
    for x, y in zip(*runs):
        assert torch.equal(x, y)

    model = second.SECOND(cfg, device=cuda)
    for impl in ("kernel", "ref"):
        (c0, b0), (c1, b1) = (model(st, impl=impl) for _ in range(2))
        assert torch.equal(c0, c1) and torch.equal(b0, b1), impl
        (l0, _, g0), (l1, _, g1) = (second.loss_and_grads(model, batch,
                                                          impl=impl)
                                    for _ in range(2))
        assert torch.equal(l0, l1), impl
        assert [k for k in g0 if not torch.equal(g0[k], g1[k])] == [], impl


def _spliced_level(dev, n=4096):
    """Two frames of a small moving sensor through the delta path on the
    card: the second frame's canonical rows, its spliced table, the first
    frame's kmap and the delta. The second frame also loses every 7th
    row, so that more slots are evicted than the inserts refill."""
    from repro_torch.core import stream
    from repro_torch.data.pointcloud import moving_sensor_sequence
    frames = moving_sensor_sequence(np.random.default_rng(3), 2, n,
                                    window=96, step=8, depth=48,
                                    density=0.35)
    frames[1].valid[::7] = False
    st = stream.empty_state(n, max_blocks=n, device=dev)
    for f in frames:
        prev = st
        c, b, v = _dev(dev, f.coords, f.batch, f.valid)
        delta, nc, nb, nv = stream.diff_frame(st, c, b, v, max_blocks=n)
        table = stream.apply_table_delta(st.table, delta, st.coords,
                                         st.batch, nc, nb, max_blocks=n)
        kmap, _ = oct_ops.build_kmap(nc, nb, nv, max_blocks=n, impl="ref",
                                     table=table)
        st = stream.FrameState(nc, nb, nv, table, kmap)
    assert int(delta.n_evicted) > 0 and int(delta.n_inserted) > 0
    return st, prev.kmap, delta


def test_octent_row_list_kernel_vs_plain(cuda):
    """Kernel 1's row-list mode on a spliced table, against its plain
    version bit for bit and against a full search: Q = 0 (no launch, a
    copy of prev), Q = 1, Q = 200 (not a multiple of 128), the dirty rows
    with -1 pads (evicted slots among them, which come back all -1); and
    a full-mode launch in the same test."""
    from repro_torch.core import stream
    st, prev, delta = _spliced_level(cuda)
    offs = torch.as_tensor(morton.subm3_offsets(), device=cuda)
    qt = st.table
    args = (st.coords, st.batch, st.valid, offs, qt.ublocks, qt.tkey,
            qt.tval, qt.n_blocks)
    before, rows_before = oct_kernel.launches, oct_kernel.row_launches
    full = oct_kernel.octent_query(*args)
    torch.cuda.synchronize()
    assert oct_kernel.launches == before + 1
    assert oct_kernel.row_launches == rows_before
    assert torch.equal(full, octent_query_ref(*args))
    n = st.coords.shape[0]
    dirty = torch.nonzero(delta.dirty_rows).flatten().to(torch.int32)
    evicted = torch.nonzero(delta.evicted & ~st.valid).flatten().to(
        torch.int32)
    assert evicted.numel() > 0
    rng = np.random.default_rng(7)
    some = torch.as_tensor(np.sort(rng.choice(n, 200, replace=False)),
                           dtype=torch.int32, device=cuda)
    pad = stream.pack_dirty_rows(delta.dirty_rows,
                                 stream.row_budget(dirty.numel(), n))
    assert pad.shape[0] % 128 == 0 and bool((pad == -1).any())
    cases = {"q0": dirty[:0], "q1": dirty[:1], "q200": some,
             "dirty_padded": pad,
             "evicted_and_pads": torch.cat([
                 evicted, pad[-3:], dirty[st.valid[dirty.long()]][:5]])}
    for name, rows in cases.items():
        launches = oct_kernel.launches
        got = oct_kernel.octent_query(*args, rows=rows, prev=prev)
        torch.cuda.synchronize()
        want = octent_query_ref(*args, rows=rows, prev=prev)
        assert torch.equal(got, want), name
        assert oct_kernel.launches == launches + (rows.numel() > 0), name
        listed = rows[rows >= 0].long()
        keep = torch.ones(n, dtype=torch.bool, device=cuda)
        keep[listed] = False
        assert torch.equal(got[listed], full[listed]), name
        assert torch.equal(got[keep], prev[keep]), name
    assert oct_kernel.row_launches == rows_before + 4
    # the padded dirty rows turn the previous kmap into the full search
    assert torch.equal(oct_kernel.octent_query(*args, rows=pad, prev=prev),
                       full)


def test_stream_delta_vs_scratch_on_card(cuda):
    """A 4-frame TINY moving-sensor stream on the card: the delta session
    (kernel 1 in row-list mode on the dirty rows) and the scratch session
    agree bit for bit at every level and at the logits."""
    from repro_torch.core import plan as planlib, stream
    from repro_torch.data.pointcloud import moving_sensor_sequence
    from repro_torch.models import minkunet
    from repro_torch.runtime import feature_cache
    cfg = minkunet.MinkUNetConfig(name="tiny", in_ch=3, classes=4, stem=8,
                                  enc=(8, 8), dec=(8, 8), blocks=1,
                                  grid_bits=5, batch_bits=2)
    n = 2048
    model = minkunet.MinkUNet(cfg, device=cuda)
    frames = moving_sensor_sequence(np.random.default_rng(5), 4, n,
                                    window=128, step=8, depth=32,
                                    density=0.3)
    d = stream.StreamSession(
        cfg, n, enabled=True, device=cuda,
        cache=planlib.PlanCache(pinned=feature_cache.PinnedStore()))
    s = stream.StreamSession(
        cfg, n, enabled=False, device=cuda,
        cache=planlib.PlanCache(content=False,
                                pinned=feature_cache.PinnedStore()))
    row_launches = oct_kernel.row_launches
    for t, f in enumerate(frames):
        d.advance(f.coords, f.batch, f.valid)
        s.advance(f.coords, f.batch, f.valid)
        for r in range(d.levels):
            a, b = d.states[r], s.states[r]
            for x, y in [(a.coords, b.coords), (a.valid, b.valid),
                         (a.kmap, b.kmap), *zip(a.table, b.table)]:
                assert torch.equal(x, y), (t, r)
        feats = f.feats[:, :cfg.in_ch]
        assert torch.equal(d.forward(model, feats), s.forward(model, feats))
    assert oct_kernel.row_launches > row_launches
    assert d.stats()["rows_searched"] < s.stats()["rows_searched"]
    d.close()
    s.close()


def test_one_shot_gemm_fault_retried_bit_equal_on_card(cuda, monkeypatch):
    """A one-shot injected ``gemm`` fault on the card: the serving engine
    retries the forward with the kernel, bit-equal to the clean request;
    no fallback is served (the chain is off by default)."""
    from repro_torch.launch import spconv_serve
    from repro_torch.models import minkunet
    from repro_torch.runtime import admission, fault, guard
    monkeypatch.delenv("REPRO_GUARD_FALLBACK", raising=False)
    cfg = minkunet.MinkUNetConfig(name="tiny", stem=8, enc=(8, 16),
                                  dec=(16, 8), classes=4, blocks=1)
    eng = spconv_serve.ServeEngine(
        minkunet.MinkUNet(cfg, device=cuda), device=cuda, max_batch=1,
        queue=admission.AdmissionQueue(buckets=(2048,)))
    c, b, v = _cloud(np.random.default_rng(9), 2048, 40, 1500)
    f = np.random.default_rng(10).standard_normal((2048, 4)).astype(
        np.float32)
    eng.submit("clean", c, b, v, f)
    (clean,) = eng.step()
    launches = sg_kernel.launches
    with guard.scoped_health() as h, fault.inject(
            fault.FaultPlan(schedule={"gemm": [2]})):
        eng.submit("faulted", c, b, v, f)
        (res,) = eng.step()
        assert h.get("serve.exec_retry") == 1 and h.get("fault.gemm") == 1
        assert not any(k.startswith("fallback.") for k in h.snapshot())
    assert res.status == "completed" and res.digest == clean.digest
    # the two layers before the fault ran twice
    assert sg_kernel.launches - launches == 9 + 2


@pytest.mark.parametrize("site", ["gemm", "search"])
def test_persistent_fault_on_card_never_serves_the_plain_version(
        cuda, monkeypatch, site):
    """With the fallback chain on, a persistent injected fault on the
    card's tensors is retried with the kernel and then raises: the chain
    is empty there, so the plain version serves nothing."""
    from repro_torch.runtime import fault, guard
    monkeypatch.setenv("REPRO_GUARD_FALLBACK", "1")
    c, b, v = _dev(cuda, *_cloud(np.random.default_rng(12), 512, 16, 400))
    kmap, _ = oct_ops.build_kmap(c, b, v, max_blocks=512)
    tiles = sg_ops.build_tap_tiles(kmap, bm=128)
    f = torch.randn(512, 8, device=cuda)
    w = torch.randn(27, 8, 16, device=cuda)

    def run():
        if site == "gemm":
            return sg_ops.apply_tiles(f, w, tiles, n_out=512)
        return oct_ops.build_kmap(c, b, v, max_blocks=512)[0]

    with guard.scoped_health() as h, fault.inject(
            fault.FaultPlan(schedule={site: [0, 1]})):
        with pytest.raises(fault.InjectedFault):
            run()
        assert h.snapshot() == {f"fault.{site}": 2,
                                f"fallback.error.{site}": 2,
                                f"quarantine.enter.{site}": 1}


def test_plan_cache_snapshot_decodes_onto_the_card(cuda, tmp_path):
    """Plans built on the card, persisted, and read by a fresh cache land
    on the card bit-equal, with no search."""
    from repro_torch.core import plan as planlib
    from repro_torch.models import minkunet
    from repro_torch.runtime import feature_cache, persist
    cfg = minkunet.MinkUNetConfig(name="tiny", stem=8, enc=(8, 16),
                                  dec=(16, 8), classes=4, blocks=1)
    c, b, v = _dev(cuda, *_cloud(np.random.default_rng(11), 2048, 40, 1400))

    def cache():
        st = persist.SnapshotStore(str(tmp_path), device=cuda)
        return planlib.PlanCache(
            persist=st, pinned=feature_cache.PinnedStore(persist=st))

    p1 = minkunet.build_plans(c, b, v, cfg, cache=cache(), device=cuda)
    searches, launches = planlib.MAPSEARCH_CALLS[0], oct_kernel.launches
    p2 = minkunet.build_plans(c.clone(), b.clone(), v.clone(), cfg,
                              cache=cache(), device=cuda)
    assert planlib.MAPSEARCH_CALLS[0] == searches
    assert oct_kernel.launches == launches
    for x, y in zip(p1.subm, p2.subm):
        assert y.kmap.is_cuda and torch.equal(x.kmap, y.kmap)
        # the snapshot holds no tiles: the read rebuilds them, bit-equal
        for t, u in zip(x.tiles, y.tiles):
            assert t == u if isinstance(t, int) else torch.equal(t, u)


def _dup_cloud(case):
    """Clouds with duplicate rows: ``few``, the duplicate cloud of
    ``tests/test_torch_octent.py`` (rows 120.. repeat rows 0..39), and
    ``many``, 5,000 voxels each written by four rows, shuffled."""
    rng = np.random.default_rng(5)
    if case == "few":
        c, b, v = _cloud(rng, 160, 12, 120, batch=2)
        c[120:], b[120:], v[120:] = c[:40], b[:40], True
        return c, b, v
    c, b, v = _cloud(rng, 5000, 40, 5000, batch=2)
    perm = rng.permutation(20000)
    return np.tile(c, (4, 1))[perm], np.tile(b, 4)[perm], np.tile(v, 4)[perm]


@pytest.mark.parametrize("case", ["unique", "few", "many"])
def test_search_baselines_on_card(cuda, case):
    """The dense-table search (``build_kmap(impl="dense")``) and the sorted
    search on the card equal their CPU runs bit for bit. The dense table
    keeps the last of duplicate rows (a max-scatter), as the host hash
    does; the sorted search keeps the first, as kernel 1 does; on a cloud
    without duplicates all four agree."""
    if case == "unique":
        c, b, v = _cloud(np.random.default_rng(6), 3000, 40, 2500, batch=2)
    else:
        c, b, v = _dup_cloud(case)
    n, offs = c.shape[0], morton.subm3_offsets()
    host = mapsearch.build_kmap_hash(c, b, v, offs)
    got, want = {}, {}
    for dev, out in ((cuda, got), (torch.device("cpu"), want)):
        t = _dev(dev, c, b, v)
        out["dense"], out["n_blocks"] = oct_ops.build_kmap(
            *t, max_blocks=n, grid_bits=5, impl="dense")
        out["sorted"] = mapsearch.build_kmap_sorted(
            *t, torch.as_tensor(offs, device=dev))
        out["kernel"] = oct_ops.build_kmap(*t, max_blocks=n, grid_bits=5)[0]
    for key in got:
        assert torch.equal(got[key].cpu(), want[key]), key
    assert np.array_equal(got["dense"].cpu().numpy(), host)
    assert torch.equal(got["sorted"], got["kernel"])
    if case == "unique":
        assert np.array_equal(got["sorted"].cpu().numpy(), host)
    else:
        assert not np.array_equal(got["sorted"].cpu().numpy(), host)


def test_dense_search_is_never_a_fallback_on_card(cuda, monkeypatch):
    """With the fallback chain on, the card's chains are empty: a
    persistent ``search`` fault on kernel 1 raises and reaches neither the
    dense table nor the plain version; a clean default search launches
    kernel 1 and builds no dense table."""
    from repro_torch.runtime import fault, guard
    monkeypatch.setenv("REPRO_GUARD_FALLBACK", "1")
    for impl in ("kernel", "dense", "ref"):
        assert guard.fallback_chain("search", impl, cuda) == ()
    assert all("dense" not in chain
               for chain in guard.FALLBACK_CHAINS["search"].values())
    built = []
    table = mapsearch.build_block_table
    monkeypatch.setattr(mapsearch, "build_block_table",
                        lambda *a, **k: built.append(1) or table(*a, **k))
    c, b, v = _dev(cuda, *_cloud(np.random.default_rng(13), 512, 16, 400))
    with guard.scoped_health() as h, fault.inject(
            fault.FaultPlan(schedule={"search": [0, 1]})):
        with pytest.raises(fault.InjectedFault):
            oct_ops.build_kmap(c, b, v, max_blocks=512)
        assert not any(k.startswith("fallback.served") for k in h.snapshot())
    launches = oct_kernel.launches
    oct_ops.build_kmap(c, b, v, max_blocks=512)
    assert oct_kernel.launches == launches + 1 and not built
    oct_ops.build_kmap(c, b, v, max_blocks=512, impl="dense")
    assert oct_kernel.launches == launches + 1 and built == [1]


def _nccl_sharded_rank(rank, cloud):
    import torch.distributed as dist
    from repro_torch.launch.spconv_sharded import make_mesh
    from repro_torch.runtime import sharding
    c, b, v = _dev(torch.device("cuda", 0), *cloud)
    n = c.shape[0]
    km1, nb1 = oct_ops.build_kmap(c, b, v, max_blocks=n, impl="kernel")
    launches = oct_kernel.launches
    mesh = make_mesh((1,), ("data",), "cuda")
    with sharding.set_mesh(mesh):
        auto = oct_ops.search_impl()
        km, nb = oct_ops.build_kmap(c, b, v, max_blocks=n, impl="sharded")
        mode = dist.get_backend(mesh.get_group(0))
    return {"equal": torch.equal(km, km1), "nb": (int(nb), int(nb1)),
            "auto": auto, "mode": mode,
            "launches": (launches, oct_kernel.launches),
            "hits": int((km >= 0).sum())}


def test_sharded_search_one_nccl_rank_equals_kernel(cuda, tmp_path):
    """One NCCL rank under a 1-way mesh: ``auto`` keeps kernel 1, and the
    sharded search forced on a 4,096-row LiDAR cloud gives kernel 1's kmap
    bit for bit without launching it."""
    from repro_torch.data import pointcloud
    from repro_torch.launch.spconv_sharded import spawn_ranks
    vb = pointcloud.make_batch(np.random.default_rng(0), "lidar", 1, 4096,
                               voxel_size=0.0125)
    [r] = spawn_ranks(_nccl_sharded_rank, 1, backend="nccl",
                      init_file=str(tmp_path / "rendezvous"),
                      args=((vb.coords, vb.batch, vb.valid),), timeout_s=300)
    assert r["equal"] and r["nb"][0] == r["nb"][1] and r["hits"] > 4096
    assert r["auto"] == "kernel" and r["mode"] == "nccl"
    assert r["launches"] == (1, 1)


def _gloo_cuda_rank(rank, cloud):
    import torch.distributed as dist
    from repro_torch.launch.spconv_sharded import make_mesh
    from repro_torch.runtime import sharding
    dev = torch.device("cuda", 0)
    t = torch.tensor([rank, -rank, 7 * rank], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    parts = [torch.empty_like(t) for _ in range(2)]
    dist.all_gather(parts, t + rank)
    c, b, v = _dev(dev, *cloud)
    n = c.shape[0]
    km1, _ = oct_ops.build_kmap(c, b, v, max_blocks=n, impl="kernel")
    with sharding.set_mesh(make_mesh((2,), ("data",), "cuda")):
        km, _ = oct_ops.build_kmap(c, b, v, max_blocks=n)
    return {"max": t.tolist(), "device": str(t.device),
            "gathered": [p.tolist() for p in parts],
            "equal": torch.equal(km, km1)}


def test_gloo_takes_int32_cuda_collectives(cuda, tmp_path):
    """Two ranks sharing the card over gloo: ``all_reduce(MAX)`` and
    ``all_gather`` take int32 CUDA tensors as they are (the sharded
    search's merges pass them so, with no host staging of their own), and
    the sharded search on a 2-way mesh gives kernel 1's kmap."""
    from repro_torch.data import pointcloud
    from repro_torch.launch.spconv_sharded import spawn_ranks
    vb = pointcloud.make_batch(np.random.default_rng(1), "lidar", 1, 4096,
                               voxel_size=0.0125)
    ranks = spawn_ranks(_gloo_cuda_rank, 2, backend="gloo",
                        init_file=str(tmp_path / "rendezvous"),
                        args=((vb.coords, vb.batch, vb.valid),),
                        timeout_s=300)
    for r in ranks:
        assert r["max"] == [1, 0, 7] and r["device"] == "cuda:0"
        assert r["gathered"] == [[1, 0, 7], [2, 1, 8]]
        assert r["equal"]


def test_engine_graph_serves_a_batched_tick_bit_equal_to_eager(cuda):
    """Two scenes of one bucket in one tick (both replays before either
    copy-out): one executable, each digest that of an eager forward of the
    same tensors and plans; each replay counts the graph's launches."""
    import hashlib
    from repro_torch.core.spconv import SparseTensor
    from repro_torch.launch import spconv_serve
    from repro_torch.models import minkunet
    from repro_torch.runtime import admission
    cfg = minkunet.MinkUNetConfig(name="tiny", stem=8, enc=(8, 16),
                                  dec=(16, 8), classes=4, blocks=1)
    model = minkunet.MinkUNet(cfg, device=cuda)
    eng = spconv_serve.ServeEngine(
        model, device=cuda, max_batch=2,
        queue=admission.AdmissionQueue(buckets=(2048,)))
    clouds = []
    for seed in (9, 21):
        c, b, v = _cloud(np.random.default_rng(seed), 2048, 40, 1500)
        f = np.random.default_rng(seed + 1).standard_normal(
            (2048, 4)).astype(np.float32)
        clouds.append((c, b, v, f))
        eng.submit(f"s{seed}", c, b, v, f)
    launches = sg_kernel.launches
    res = eng.step()
    assert [r.status for r in res] == ["completed"] * 2
    assert eng.compiled == 1
    (entry,) = eng._exec.values()
    n_layers = 1 + len(cfg.enc) + len(cfg.dec) \
        + cfg.blocks * (len(cfg.enc) + len(cfg.dec))
    assert entry.graph.launches[(sg_kernel, "launches")] == n_layers
    # the warm-up, then two replays: the capture launched nothing
    assert sg_kernel.launches - launches == 3 * n_layers
    assert res[0].digest != res[1].digest
    for r, (c, b, v, f) in zip(res, clouds):
        arrays = admission.quantize_to_bucket(c, b, v, f, 2048)[:4]
        st = SparseTensor(*(torch.as_tensor(a, device=cuda)
                            for a in arrays))
        plans = minkunet.build_plans(st.coords, st.batch, st.valid, cfg,
                                     cache=eng.cache, n_max=2048,
                                     device=cuda)
        want = minkunet.forward(model, st, plans=plans).cpu().numpy()
        assert hashlib.sha256(want.tobytes()).hexdigest() == r.digest


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x7b",
                                  "mamba2-2.7b", "recurrentgemma-2b",
                                  "llava-next-mistral-7b"])
def test_generate_replays_decode_step_equal_to_eager(cuda, arch):
    """Each family with a decode step, narrow (reduced config, float32,
    head dim 64, one of kernel 5's; Mixtral past its 16-slot window),
    through ``generate``: the step after
    the first is a graph replay, and the tokens and every step's logits
    equal an eager ``decode_step`` loop's from the same prefill."""
    import dataclasses
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.runtime import graph
    cfg = dataclasses.replace(get_config(arch).reduced(), head_dim=64)
    model = api.build_model(cfg, device=cuda)
    params = model.init(torch.Generator(cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 12))}
    if cfg.n_patches:
        batch["patches"] = rng.standard_normal(
            (2, cfg.n_patches, cfg.vision_dim)).astype(np.float32)
    n_gen, ctx = 10, 12 + 10 + cfg.n_patches
    got, stats = serve.generate(model, params, batch, max_context=ctx,
                                n_steps=n_gen, device=cuda)
    assert stats["graphed"]
    dev_batch = {k: torch.as_tensor(v, device=cuda)
                 for k, v in batch.items()}

    def loop(graphed):
        logits, cache = model.prefill(params, dev_batch, ctx)
        step0 = int(cache["step"])
        tok = logits.argmax(-1)[:, None].int()
        out, steps, g = [tok], [], None
        for _ in range(n_gen - 1):
            if not graphed:
                logits, cache = model.decode_step(params, cache, tok)
            elif g is None:
                g = graph.Graph(
                    lambda t: model.decode_step(params, cache, t)[0], cuda)
                logits = g.warm_up(tok)
                g.capture(tok)
            else:
                logits = g(tok)
            steps.append(logits[:, -1])
            tok = logits[:, -1].argmax(-1)[:, None].int()
            out.append(tok)
        assert cache["step"].dtype == torch.int32
        assert int(cache["step"]) == step0 + n_gen - 1
        return torch.cat(out, 1), steps

    eager, eager_logits = loop(False)
    replayed, replayed_logits = loop(True)
    assert torch.equal(got, eager) and torch.equal(replayed, eager)
    for a, b in zip(replayed_logits, eager_logits):
        assert torch.equal(a, b)


def test_capture_that_meets_a_host_read_raises(cuda):
    from repro_torch.runtime import graph
    x = torch.ones(4, device=cuda)
    g = graph.Graph(lambda t: t * int(t.sum()), cuda)
    g.warm_up(x)
    with pytest.raises(RuntimeError):
        g.capture(x)
    assert g.graph is None
    torch.cuda.synchronize()
    assert float((x * 2).sum()) == 8.0


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree.clone()


def _leaves(tree):
    from repro_torch.checkpoint import checkpoint
    return checkpoint.tree_leaves(tree)


def test_donated_graph_chains_its_state_in_place(cuda):
    """A donated graph replays into the caller's state tensors, as the
    eager step would write them; a function that returns new state
    tensors is refused at capture."""
    from repro_torch.runtime import graph

    def step(s, b):
        s["w"].mul_(0.5).add_(b["x"])
        s["n"].add_(1)
        return s, {"sum": s["w"].sum()}

    state = {"w": torch.zeros(4, device=cuda),
             "n": torch.zeros((), dtype=torch.int32, device=cuda)}
    twin = _clone_tree(state)
    w = state["w"]
    g = graph.Graph(step, cuda, donate=True)
    x0 = {"x": torch.ones(4, device=cuda)}
    g.warm_up(state, x0)
    step(twin, x0)
    g.capture(state, x0)
    for i in range(3):
        x = {"x": torch.full((4,), float(i), device=cuda)}
        out, m = g(state, x)
        _, tm = step(twin, x)
        assert out["w"] is w and torch.equal(w, twin["w"])
        assert torch.equal(out["n"], twin["n"]) and torch.equal(m["sum"],
                                                                tm["sum"])
    assert g.pool_bytes >= 0
    bad = graph.Graph(lambda s, b: ({"w": s["w"] + b["x"], "n": s["n"]},
                                    {}), cuda, donate=True)
    bad.warm_up(state, x0)
    with pytest.raises(ValueError, match="donated"):
        bad.capture(state, x0)


def test_capture_pauses_the_cyclic_collector(cuda):
    """A capture runs with Python's cyclic garbage collector paused: a
    collection inside it could free a graph left in a reference cycle,
    and a graph's reset ends the capture (a card test failed so once).
    The collector runs again after the capture, and after a failed one."""
    import gc
    from repro_torch.runtime import graph
    seen = []

    def fn(t):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        return t + 1

    x = torch.ones(4, device=cuda)
    g = graph.Graph(fn, cuda)
    g.warm_up(x)
    g.capture(x)
    assert seen == [False] and gc.isenabled()
    assert torch.equal(g(x), x + 1)
    bad = graph.Graph(lambda t: t * int(t.sum()), cuda)    # a host read
    bad.warm_up(x)
    with pytest.raises(RuntimeError):
        bad.capture(x)
    assert gc.isenabled()


def _demo_batch(cuda, cfg, seed=0, voxels=4096):
    """An indoor scene of the demo's on the card, and its plans."""
    from repro_torch.data import pointcloud
    from repro_torch.models import minkunet
    vb = pointcloud.make_batch(np.random.default_rng(seed), "indoor", 1,
                               voxels)
    batch = {k: torch.as_tensor(np.array(v), device=cuda)
             for k, v in vb._asdict().items()}
    batch["labels"] = batch["labels"].clamp(0, cfg.classes - 1)
    plans = minkunet.build_plans(batch["coords"], batch["batch"],
                                 batch["valid"], cfg, device=cuda)
    return batch, plans


def _demo_step(cuda, voxels=4096, impl=None):
    from repro_torch.launch import train
    from repro_torch.models import minkunet
    from repro_torch.optim import adamw
    cfg = train.DEMO_CFG
    model = minkunet.MinkUNet(cfg, device=cuda,
                              generator=torch.Generator().manual_seed(0))
    batch, plans = _demo_batch(cuda, cfg, voxels=voxels)
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step = train.make_spconv_step(
        model, adamw.AdamWConfig(lr=1e-3, total_steps=4, warmup_steps=1),
        plans, impl=impl, donate=True)
    n_layers = 1 + (1 + cfg.blocks) * (len(cfg.enc) + len(cfg.dec))
    return step, (params, adamw.init(params)), batch, n_layers


def test_minkunet_step_replays_bit_equal_to_eager(cuda):
    """The demo MinkUNet step: eager at its first call, captured and
    replayed at its second, replayed after; each replay launches kernel 2
    once a layer (counted) and leaves the state an eager step leaves from
    the same state and batch, bit for bit."""
    from repro_torch.launch import train
    step, state, batch, n_layers = _demo_step(cuda)
    compiled = train.CompiledStep(step, cuda)
    params = state[0]
    state, _ = compiled(state, batch)
    assert compiled.last == "warm-up" and state[0] is params
    for mode in ("capture", "replay"):
        twin = _clone_tree(state)
        before = sg_kernel.launches
        state, m = compiled(state, batch)
        assert compiled.last == mode and state[0] is params
        assert compiled.graph.launches[(sg_kernel, "launches")] == n_layers
        assert sg_kernel.launches - before == n_layers
        twin, tm = step(twin, batch)
        assert torch.equal(m["loss"], tm["loss"])
        for a, b in zip(_leaves(state), _leaves(twin)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="donated"):
        compiled(_clone_tree(state), batch)


def test_minkunet_plain_step_is_captured(cuda):
    """``impl="ref"``: the step over the kernels' plain versions captures
    too (its forward reads the slot index, not ``torch.nonzero``) and
    replays bit-equal to an eager step from the same state and batch:
    the plain forward adds each output row's slots in the index's order,
    as its backward adds each source row's."""
    from repro_torch.launch import train
    step, state, batch, _ = _demo_step(cuda, impl="ref")
    compiled = train.CompiledStep(step, cuda)
    before = sg_kernel.launches
    state, _ = compiled(state, batch)
    for mode in ("capture", "replay"):
        twin = _clone_tree(state)
        state, m = compiled(state, batch)
        assert compiled.last == mode
        twin, tm = step(twin, batch)
        assert torch.equal(m["loss"], tm["loss"])
        for a, b in zip(_leaves(state), _leaves(twin)):
            assert torch.equal(a, b)
    assert sg_kernel.launches == before


def test_minkunet_plain_runs_reach_one_digest(cuda):
    """Two ``impl="ref"`` training runs of MinkUNet-small on one scene
    (eager, captured and replayed, replayed) reach one state digest, with
    no determinism switch: every sum of the plain step runs in a fixed
    order. The kernel is never launched."""
    from repro_torch.launch import train
    from repro_torch.models import minkunet
    before = sg_kernel.launches
    runs = [train.run_spconv_demo(3, cfg=minkunet.SMALL, voxels=4096,
                                  impl="ref", device=cuda)
            for _ in range(2)]
    assert [t["graph"] for t in runs[0]["timings"]] == \
        ["warm-up", "capture", "replay"]
    assert runs[0]["state_digest"] == runs[1]["state_digest"]
    assert runs[0]["losses"] == runs[1]["losses"]
    assert sg_kernel.launches == before


def test_dryrun_donated_train_cell_on_the_card(cuda):
    """The dry run's donated train cell of a reduced TinyLlama (a (1, 1)
    mesh, 2 x 64 tokens) against the card, as phase ``dryrun`` checks the
    full one: argument bytes equal to the placed state's, the allocator's
    growth to them rounded to its blocks, ``temp_bytes`` to the peak's
    growth within the prefill check's slack; the step writes the state's
    own tensors."""
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rec = smoke._dryrun_train_check(
        cuda, "tinyllama-1.1b", get_config("tinyllama-1.1b").reduced(), 2,
        64)
    assert rec["argument_bytes"] > 0 and rec["temp_bytes"] > 0
    assert rec["allocator_rounding"] > 0       # AdamW's count, 4 bytes


def test_memo_steps_share_one_pool(cuda):
    """Two scenes' steps, as the demo's memo holds them: one donated
    state, one shared graph pool. Captured one after the other, they
    replay in any order, each bit-equal to an eager step from the same
    state and batch, and the second capture adds little to the pool."""
    from repro_torch.launch import train
    from repro_torch.models import minkunet
    from repro_torch.optim import adamw
    cfg = train.DEMO_CFG
    model = minkunet.MinkUNet(cfg, device=cuda,
                              generator=torch.Generator().manual_seed(0))
    opt_cfg = adamw.AdamWConfig(lr=1e-3, total_steps=8, warmup_steps=1)
    pool = torch.cuda.graph_pool_handle()
    scenes = [_demo_batch(cuda, cfg, seed=s) for s in (0, 1)]
    steps = [train.make_spconv_step(model, opt_cfg, plans, donate=True)
             for _, plans in scenes]
    compiled = [train.CompiledStep(st, cuda, pool) for st in steps]
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = (params, adamw.init(params))
    for i in (0, 0, 1, 1, 1, 0, 1, 0):
        twin = _clone_tree(state)
        state, m = compiled[i](state, scenes[i][0])
        twin, tm = steps[i](twin, scenes[i][0])
        assert torch.equal(m["loss"], tm["loss"])
        for a, b in zip(_leaves(state), _leaves(twin)):
            assert torch.equal(a, b)
    assert [c.last for c in compiled] == ["replay", "replay"]
    assert compiled[1].graph.pool_bytes <= compiled[0].graph.pool_bytes


def test_minkunet_step_under_deterministic_algorithms(cuda, monkeypatch):
    """A whole MinkUNet step, its slot indexes built in it, under
    ``torch.use_deterministic_algorithms(True)`` (no ``warn_only``): no op
    raises; it equals the same step with the switch off, and two runs
    without the switch agree bit for bit."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    step, state, batch, _ = _demo_step(cuda)
    torch.use_deterministic_algorithms(True)
    try:
        strict, sm = step(_clone_tree(state), batch)
    finally:
        torch.use_deterministic_algorithms(False)
    runs = [step(_clone_tree(state), batch) for _ in range(2)]
    for got, m in runs:
        assert torch.equal(m["loss"], sm["loss"])
        for a, b in zip(_leaves(got), _leaves(strict)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x7b",
                                  "mamba2-2.7b", "recurrentgemma-2b",
                                  "hubert-xlarge", "llava-next-mistral-7b"])
def test_lm_step_replays_equal_to_eager(cuda, arch):
    """Each family's training step, narrow (reduced config, float32, head
    dim 64), eager once, then captured and replayed: each replay counts the
    kernel-5 launches it made and leaves the loss and every parameter and
    moment within 1e-6 of an eager step's from the same state and
    batch."""
    import dataclasses
    from repro_torch.launch import train
    from repro_torch.models import api
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_config(arch).reduced(), head_dim=64)
    model = api.build_model(cfg, device=cuda)
    stream = train.make_stream(cfg, 2, 32, seed=0)

    def batch_at(i):
        return {k: torch.as_tensor(v, device=cuda)
                for k, v in stream.batch_at(i).items()}

    step = train.make_train_step(
        model, adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4),
        donate=True)
    compiled = train.CompiledStep(step, cuda)
    state = train.init_state(model, seed=0)
    state, _ = compiled(state, batch_at(0))
    assert compiled.last == "warm-up"
    for i, mode in ((1, "capture"), (2, "replay")):
        twin = _clone_tree(state)
        before = fa_kernel.launches
        state, m = compiled(state, batch_at(i))
        assert compiled.last == mode
        per_replay = compiled.graph.launches.get((fa_kernel, "launches"), 0)
        assert fa_kernel.launches - before == per_replay
        twin, tm = step(twin, batch_at(i))
        assert abs(float(m["loss"] - tm["loss"])) <= 1e-6 * abs(
            float(tm["loss"]))
        for a, b in zip(_leaves(state), _leaves(twin)):
            scale = max(1.0, float(b.float().abs().max()))
            assert float((a.float() - b.float()).abs().max()) <= 1e-6 * scale
