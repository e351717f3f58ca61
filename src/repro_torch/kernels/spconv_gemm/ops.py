"""kmap -> output-blocked tap tiles -> the gather-GEMM kernels.

:func:`build_tap_tiles` turns the (N_out, K) kernel map into bm-padded
gather/scatter slot streams plus per-tile metadata, laid out output-block
major and tap minor (taps hottest first within each block). Every tile is
single-tap and single-output-block, and each block's tiles form one
consecutive run, so the kernel can walk a block's run in one CTA. The
streams are bit-identical to the reference's ``binning="counting"`` layout,
the GRP-group gather-run metadata (``tile_run``, ``grp_skip``,
``grp_contig``) included, although the CUDA kernel does not read the
latter. With ``row_nz`` the build elides maps that source all-zero rows.

Execution comes in two forms:

* :func:`apply_tiles` (and the one-shot :func:`apply_kmap_fused`) — the
  output-stationary fused kernel: it refreshes the SPAC liveness from the
  current features (or from the previous layer's epilogue), pads Cout to
  the kernel's 128-column groups and launches the kernel (or its plain
  version). The default backend. Its backward is the plain math's over
  the geometry liveness, so SPAC skips stay forward-only.
* :func:`apply_kmap` — the materialized baseline: an (M_pad, Cin) gathered
  copy of the features, the tiled GEMM kernel into (M_pad, Cout_pad)
  partial products, then a fixed-order sum of the valid slots' rows.

:func:`apply_epilogue` applies the BN/ReLU epilogue outside a kernel, for
the tap-scan path.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.core import rulebook as _rulebook
from repro_torch.core import segment as _segment
from repro_torch.core import sparsity as _sparsity
from repro_torch.kernels.spconv_gemm.kernel import (BN, KC, spconv_gemm,
                                                    spconv_gemm_fused)
from repro_torch.kernels.spconv_gemm.ref import (SlotIndex, epilogue_math,
                                                 slot_index,
                                                 spconv_gemm_fused_ref,
                                                 spconv_gemm_fused_ref_vjp)
from repro_torch.runtime import fault as _fault
from repro_torch.runtime import guard as _guard

#: gather-run metadata granularity (slots per group), as in the reference
GRP = 8

_I32 = torch.int32


def spac_block_enabled() -> bool:
    """``REPRO_SPAC_BLOCK`` (``runtime/flags.py``): ``"0"`` turns the
    Cin-block grain of SPAC off, leaving tile-grain skipping only. Re-read
    on every call; the output is bit-identical either way, only the
    skipped work changes."""
    return os.environ.get("REPRO_SPAC_BLOCK", "1") != "0"


class TapTiles(NamedTuple):
    """Output-blocked, tap-scheduled tile streams plus run metadata.

    Per-slot arrays are (M_pad,), per-tile arrays (T,) with T = M_pad / bm.
    ``bo`` is the output-block height the layout was built for.
    """
    gather_idx: torch.Tensor    # source row per map slot (0 for pad)
    scatter_idx: torch.Tensor   # output row per slot (n_blocks*bo for pad,
                                # outside every output block)
    slot_valid: torch.Tensor    # bool
    tile_tap: torch.Tensor      # weight tap per tile
    tile_nz: torch.Tensor       # 0 => tile skippable
    tile_ob: torch.Tensor       # output block per tile (monotone)
    tile_first: torch.Tensor    # 1 => opens its output block's run
    tile_run: torch.Tensor      # 1 => whole tile is one contiguous gather run
    grp_skip: torch.Tensor      # bitmask: GRP-group has no valid slot
    grp_contig: torch.Tensor    # bitmask: GRP-group is one contiguous run
    bo: int                     # output block rows

    @property
    def bm(self) -> int:
        return self.gather_idx.shape[0] // self.tile_tap.shape[0]

    @property
    def n_tiles(self) -> int:
        return self.tile_tap.shape[0]


def _padded_budget(n_out: int, k: int, bm: int, bo: int) -> int:
    # every (output block, tap) group may waste up to bm-1 slots to padding,
    # and empty output blocks force one all-pad tile each
    n_blocks = -(-n_out // bo)
    return ((n_out * k + n_blocks * k * (bm - 1)) // bm + 1 + n_blocks) * bm


def build_tap_tiles(kmap: torch.Tensor, row_nz: torch.Tensor | None = None,
                    *, bm: int = 128, bo: int | None = None) -> TapTiles:
    """Lay the maps out by (output block, scheduled tap), each group padded
    to a bm multiple. ``bo`` None picks ``max(bm, 512)``. The within-group
    order is the stable counting order: one map per (output row, tap), so a
    map's rank in its group is the count of valid same-tap maps on earlier
    rows of the block.

    ``row_nz`` (N_in,) bool elides, at build time, the maps whose source
    row is all zero (SPAC row grain): the tiles then hold live maps only,
    which re-packs the tap segments and changes the tap schedule, as the
    reference's build does. Leave it None for geometry-only tiles that a
    plan caches, and refresh liveness per layer with :func:`tile_liveness`.
    """
    if bo is None:
        bo = max(bm, 512)
    dev = kmap.device
    n_out, k = kmap.shape
    n_blocks = -(-n_out // bo)
    g_total = n_blocks * k
    m_pad = _padded_budget(n_out, k, bm, bo)
    grp = GRP if bm % GRP == 0 else bm
    n_grp = bm // grp
    if n_grp > 32:
        raise ValueError(f"bm={bm}: at most 32 GRP groups per tile")

    flat_in = kmap.reshape(-1)
    taps = torch.arange(k, dtype=_I32, device=dev).repeat(n_out)
    outs = torch.arange(n_out, dtype=_I32, device=dev).repeat_interleave(k)
    valid = flat_in >= 0
    if row_nz is not None:
        valid &= row_nz[flat_in.clamp(min=0).long()]

    counts = torch.bincount(torch.where(valid, taps, k).long(),
                            minlength=k + 1)[:k].to(_I32)
    sched = _rulebook.tap_schedule(counts)              # tap ids, hot first
    srank = torch.zeros(k, dtype=_I32, device=dev)
    srank[sched.long()] = torch.arange(k, dtype=_I32, device=dev)

    # group key: output block major, schedule rank minor; invalid at the end
    gkey = torch.where(valid, (outs // bo) * k + srank[taps.long()], g_total)
    counts_g = torch.bincount(gkey.long(),
                              minlength=g_total + 1)[:g_total].to(_I32)
    v2 = valid.reshape(n_out, k).to(_I32)
    # inclusive count down the rows per tap; scanned along the contiguous
    # axis of the transpose (a scan over the outer axis is ~100x slower on
    # the card)
    csum = torch.cumsum(v2.t().contiguous(), dim=1, dtype=_I32).t()
    first_row = (torch.arange(n_out, dtype=_I32, device=dev) // bo) * bo
    carried = csum[(first_row - 1).clamp(min=0).long()]
    carried = torch.where(first_row[:, None] > 0, carried, 0)
    rank = (csum - v2 - carried).reshape(-1)

    # padded group starts; empty output blocks force one all-pad tile on
    # their leading group so the kernel still opens (zeroes) the block
    pcounts = ((counts_g + bm - 1) // bm) * bm
    pc2 = pcounts.reshape(n_blocks, k).clone()
    pc2[:, 0] += torch.where(pc2.sum(dim=1) == 0, bm, 0).to(_I32)
    pcounts = pc2.reshape(-1)
    pstarts = torch.cat([torch.zeros(1, dtype=_I32, device=dev),
                         torch.cumsum(pcounts, dim=0, dtype=_I32)])
    slot = torch.where(
        valid, pstarts[:g_total][gkey.clamp(max=g_total - 1).long()] + rank,
        m_pad).long()

    # index m_pad is a drop row past the end, sliced off
    gather = torch.zeros(m_pad + 1, dtype=_I32, device=dev)
    gather[slot] = flat_in.clamp(min=0)
    scatter = torch.full((m_pad + 1,), n_blocks * bo, dtype=_I32, device=dev)
    scatter[slot] = outs
    svalid = torch.zeros(m_pad + 1, dtype=torch.bool, device=dev)
    svalid[slot] = valid
    gather, scatter, svalid = gather[:m_pad], scatter[:m_pad], svalid[:m_pad]

    t = m_pad // bm
    tile_starts = torch.arange(t, dtype=_I32, device=dev) * bm
    grank = torch.searchsorted(pstarts[1:].contiguous(), tile_starts,
                               right=True, out_int32=True)
    capped = grank.clamp(max=g_total - 1)
    tile_tap = sched[(capped % k).long()].to(_I32)
    tile_ob = (capped // k).to(_I32)
    sv2 = svalid.reshape(t, bm)
    tile_nz = sv2.any(dim=1).to(_I32)
    tile_first = torch.ones(t, dtype=_I32, device=dev)
    tile_first[1:] = (tile_ob[1:] != tile_ob[:-1]).to(_I32)

    # gather-run metadata: successive-slot contiguity, per tile and per
    # GRP-slot group
    g2 = gather.reshape(t, bm)
    nxt = (g2[:, 1:] == g2[:, :-1] + 1) & sv2[:, 1:] & sv2[:, :-1]
    tile_run = (sv2.all(dim=1) & nxt.all(dim=1)).to(_I32)
    pair3 = torch.cat([nxt, torch.ones((t, 1), dtype=torch.bool, device=dev)],
                      dim=1).reshape(t, n_grp, grp)[..., :grp - 1]
    v3 = sv2.reshape(t, n_grp, grp)
    bits = torch.ones(n_grp, dtype=_I32, device=dev) << torch.arange(
        n_grp, dtype=_I32, device=dev)
    grp_contig = ((v3.all(-1) & pair3.all(-1)).to(_I32) * bits).sum(
        -1, dtype=_I32)
    grp_skip = ((~v3.any(-1)).to(_I32) * bits).sum(-1, dtype=_I32)
    return TapTiles(gather, scatter, svalid, tile_tap, tile_nz, tile_ob,
                    tile_first, tile_run, grp_skip, grp_contig, bo=bo)


def tile_liveness(tiles: TapTiles, row_nz: torch.Tensor) -> torch.Tensor:
    """Per-tile skip flags against the current features: a tile is live iff
    one of its valid slots sources a row with any nonzero."""
    live = tiles.slot_valid & row_nz[tiles.gather_idx.long()]
    return live.reshape(-1, tiles.bm).any(dim=1).to(_I32)


def tile_block_liveness(tiles: TapTiles,
                        blk_nz: torch.Tensor) -> torch.Tensor:
    """(T, n_k) per-(tile, Cin-block) skip flags from (N, Cin/bk) per-row
    block liveness. Keep ``blk_nz`` consistent with the row mask used for
    tile liveness (AND it with ``row_nz[:, None]``)."""
    live = tiles.slot_valid[:, None] & blk_nz[tiles.gather_idx.long()]
    n_k = blk_nz.shape[1]
    return live.reshape(tiles.n_tiles, tiles.bm, n_k).any(dim=1).to(_I32)


def pick_bk(c_in: int) -> int:
    """The Cin block at which dead (tile, block) pairs are skipped.

    The kernel walks Cin in ``KC``-wide steps and keeps no Cin-sized
    buffer, so shared memory does not bound ``bk``; it only has to be a
    multiple of the step, so that each step lies in one block. Returns the
    largest such divisor of ``c_in`` up to ``BN`` (the epilogue's liveness
    group, so the threaded masks line up), else ``c_in`` as a single block.
    ``bk`` changes which dead blocks are skipped, never the output.
    """
    for bk in range(min(c_in, BN), 0, -1):
        if c_in % bk == 0 and bk % KC == 0:
            return bk
    return c_in


def _pad_cout(weights: torch.Tensor, bn: int) -> torch.Tensor:
    """Zero-pad the Cout axis to a bn multiple (the kernel's column groups);
    callers slice the output back to the true Cout."""
    c_out = weights.shape[-1]
    c_pad = -(-c_out // bn) * bn
    return F.pad(weights, (0, c_pad - c_out)).contiguous()


class FusedEpilogue(NamedTuple):
    """BN-inference + ReLU folded into the kernel: ``y = relu(out * scale +
    shift)`` on each finished output block, zero on invalid rows. Build
    scale/shift with spconv.fold_bn_inference (the conv bias folds into
    ``shift``, so pass ``bias=None`` alongside)."""
    scale: torch.Tensor   # (Cout,) float32
    shift: torch.Tensor   # (Cout,) float32
    valid: torch.Tensor   # (n_out,) bool


def kernel_inputs(feats: torch.Tensor, weights: torch.Tensor,
                  tiles: TapTiles, *, n_out: int,
                  row_nz: torch.Tensor | None = None,
                  act: _sparsity.ActSparsity | None = None,
                  epilogue: FusedEpilogue | None = None,
                  bk: int | None = None):
    """The arguments ``(args, kwargs)`` of one layer's gather-GEMM, shared
    by the kernel wrapper and its plain version.

    ``row_nz`` refreshes tile liveness for SPAC; ``act`` threads the
    previous layer's epilogue-emitted masks instead (block grain without a
    sweep when its groups align with this layer's Cin blocks); with both
    None the geometry ``tile_nz`` is used as is. With
    :func:`spac_block_enabled` false, ``tile_bk_nz`` is the tile liveness
    widened over the Cin blocks. Weights are zero-padded to
    128 output columns; the epilogue's scale/shift/valid are padded alike.
    """
    feats = feats.float().contiguous()
    c_in = feats.shape[1]
    c_out = weights.shape[-1]
    w = _pad_cout(weights.float(), BN)
    c_out_pad = w.shape[-1]
    bk = bk if bk is not None else pick_bk(c_in)
    if c_in % bk != 0:
        raise ValueError(f"bk={bk} must divide Cin={c_in}")
    n_k = c_in // bk

    if row_nz is None and act is not None:
        row_nz = act.row_nz
    blk_nz = None
    if row_nz is None:
        tile_nz = tiles.tile_nz
    else:
        tile_nz = tile_liveness(tiles, row_nz)
        if n_k > 1 and spac_block_enabled():
            if act is not None:
                blk_nz = act.block_liveness(c_in, bk)
            if blk_nz is None:
                blk_nz = _sparsity.row_block_nonzero(feats, bk)
            # a live block must never outlive its tile
            blk_nz = blk_nz & row_nz[:, None]
    if blk_nz is None:
        tile_bk_nz = tile_nz[:, None].expand(tiles.n_tiles, n_k).contiguous()
    else:
        tile_bk_nz = tile_block_liveness(tiles, blk_nz)
    n_out_pad = -(-n_out // tiles.bo) * tiles.bo
    kw = dict(bm=tiles.bm, bo=tiles.bo, bk=bk, n_out_pad=n_out_pad)
    if epilogue is not None:
        pad = c_out_pad - c_out
        kw.update(
            epi_scale=F.pad(epilogue.scale.float(), (0, pad)).contiguous(),
            epi_shift=F.pad(epilogue.shift.float(), (0, pad)).contiguous(),
            epi_valid=F.pad(epilogue.valid.to(_I32),
                            (0, n_out_pad - n_out)).contiguous(),
            epilogue=True)
    args = (feats, w, tiles.gather_idx, tiles.scatter_idx, tiles.tile_tap,
            tile_nz, tiles.tile_ob, tile_bk_nz)
    return args, kw


#: the slot index of each tile set, built at its first use and kept
#: while the set's gather stream lives
_SLOT_INDEX = WeakTensorKeyDictionary()


def backward_index(tiles: TapTiles, n_in: int) -> SlotIndex:
    """The :class:`~repro_torch.kernels.spconv_gemm.ref.SlotIndex` of
    ``tiles`` over ``n_in`` source rows, built once per tile set: at a
    training step's first backward (or first plain forward), which runs
    eagerly before the step is captured, so the replays read it and never
    build it. The geometry ``tile_nz`` decides liveness, as the backward
    requires."""
    key = (n_in, tiles.bm, tiles.bo)
    src = (tiles.scatter_idx, tiles.tile_tap, tiles.tile_nz, tiles.tile_ob)
    memo = _SLOT_INDEX.setdefault(tiles.gather_idx, {})
    hit = memo.get(key)
    if hit is None or any(a is not b for a, b in zip(hit[0], src)):
        hit = memo[key] = (src, slot_index(
            tiles.gather_idx, *src, bm=tiles.bm, bo=tiles.bo, n_in=n_in))
    return hit[1]


class _FusedExec(torch.autograd.Function):
    """One layer's fused execution (the kernel, or its plain version) with
    the SPAC-correct backward: the reference's ``_exec_fused``.

    The forward skips what the elided liveness of :func:`kernel_inputs`
    marks dead, which is lossless: a zero row adds exactly 0. Its gradient
    is not 0 but ``W^T g``, so the backward runs the plain math's VJP over
    the geometry liveness ``tiles.tile_nz`` with every Cin block live. It
    returns the whole padded output (and, with the epilogue, the liveness,
    which is not differentiable); the caller slices it. Inference-only with
    the epilogue: its backward raises.
    """

    @staticmethod
    def forward(ctx, feats, weights, tiles, n_out, opts, impl):
        args, kw = kernel_inputs(feats, weights, tiles, n_out=n_out, **opts)
        if impl == "kernel":
            res = spconv_gemm_fused(*args, **kw)
        else:       # over the geometry's live slots: a zero row adds 0
            res = spconv_gemm_fused_ref(
                *args, **kw, index=backward_index(tiles, feats.shape[0]))
        ctx.tiles = tiles
        ctx.epilogue = opts["epilogue"] is not None
        if ctx.epilogue:
            ctx.mark_non_differentiable(res[1])
        else:
            ctx.save_for_backward(feats, weights)
        return res

    @staticmethod
    def backward(ctx, g, *_):
        if ctx.epilogue:
            raise NotImplementedError(
                "the fused BN/ReLU epilogue is inference-only: its backward "
                "would differentiate through elided activation state. For "
                "training, compose subm_conv3 + batch_norm + relu unfused.")
        feats, weights = ctx.saved_tensors
        dfeats, dweights = spconv_gemm_fused_ref_vjp(
            feats, weights, g, backward_index(ctx.tiles, feats.shape[0]))
        return (dfeats.to(feats.dtype), dweights.to(weights.dtype), None,
                None, None, None)


def apply_tiles(feats: torch.Tensor, weights: torch.Tensor, tiles: TapTiles,
                bias: torch.Tensor | None = None, *, n_out: int,
                row_nz: torch.Tensor | None = None,
                act: _sparsity.ActSparsity | None = None,
                epilogue: FusedEpilogue | None = None,
                bk: int | None = None, impl: str | None = None):
    """Execute one layer's rulebook from prebuilt tiles.

    Liveness as in :func:`kernel_inputs`. impl: None or ``"kernel"`` goes
    through the kernel wrapper (CUDA kernel on a card, plain version on the
    CPU); ``"ref"`` runs the plain version on any device. Differentiable
    in ``feats`` and ``weights`` under both, with the same gradient: the
    plain math over the geometry liveness (:class:`_FusedExec`), so SPAC
    stays forward-only.

    The call goes through ``runtime.guard.dispatch`` at the ``gemm`` fault
    site; it falls back to the plain version only under
    ``REPRO_GUARD_FALLBACK=1`` and only on the CPU.

    Returns the (n_out, Cout) output (+ bias); with ``epilogue`` it returns
    ``(out, ActSparsity)`` for the next layer, and ``bias`` must be None.
    """
    impl = impl or "kernel"
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown kernel impl {impl!r}")
    if epilogue is not None and bias is not None:
        raise ValueError("bias and epilogue together would apply the bias "
                         "twice: fold it into the epilogue shift "
                         "(spconv.fold_bn_inference)")
    opts = dict(row_nz=row_nz, act=act, epilogue=epilogue, bk=bk)

    def _run(one: str):
        _fault.check("gemm")
        return _FusedExec.apply(feats, weights, tiles, n_out, opts, one)

    res = _guard.dispatch("gemm", impl,
                          _guard.fallback_chain("gemm", impl, feats.device),
                          _run, key=(tuple(feats.shape), weights.shape[-1],
                                     tiles.bm, tiles.bo))
    c_out = weights.shape[-1]
    if epilogue is not None:
        out, nz = res
        nzb = nz[:n_out].bool()
        return out[:n_out, :c_out], _sparsity.ActSparsity(
            row_nz=nzb.any(dim=-1), blk_nz=nzb, blk=BN)
    out = res[:n_out, :c_out]
    if bias is not None:
        out = out + bias
    return out


def apply_kmap_fused(feats: torch.Tensor, weights: torch.Tensor,
                     kmap: torch.Tensor, bias: torch.Tensor | None = None, *,
                     spac: bool = True, bm: int = 128, bo: int | None = None,
                     bk: int | None = None):
    """One-shot fused path: build geometry tiles, then :func:`apply_tiles`.
    SPAC liveness is a per-layer refresh (``row_nz``), never folded into
    the build, so the result does not depend on ``spac`` beyond float
    summation order."""
    row_nz = _sparsity.row_nonzero(feats) if spac else None
    tiles = build_tap_tiles(kmap, bm=bm, bo=bo)
    return apply_tiles(feats, weights, tiles, bias, n_out=kmap.shape[0],
                       row_nz=row_nz, bk=bk)


def scatter_valid(ps: torch.Tensor, tiles: TapTiles,
                  n_out: int) -> torch.Tensor:
    """Add the rows of the valid slots of ``ps`` (M_pad, C) into an
    (n_out, C) output, each output row its slots in ascending slot order
    (:func:`segment.ordered_sum`, the reference's scatter order), so two
    runs give the same bits. The rows of pad slots and dead tiles are not
    read, as the reference's ``mode="drop"`` scatter throws the pad slots
    away. One host read, of the index's column sizes."""
    dst = torch.where(tiles.slot_valid, tiles.scatter_idx.long(), n_out)
    return _segment.ordered_sum(ps, _segment.segments((dst, n_out))[0])


def apply_kmap(feats: torch.Tensor, weights: torch.Tensor, kmap: torch.Tensor,
               bias: torch.Tensor | None = None, *, bm: int = 128,
               bo: int | None = None) -> torch.Tensor:
    """Materialized-gather baseline, the same function as
    ``rulebook.apply_kmap_gather``.

    1. tiles built with SPAC row elision;
    2. ``lhs = feats[gather_idx]``, an (M_pad, Cin) copy, invalid slots
       zeroed;
    3. the tiled GEMM kernel (:func:`spconv_gemm`: the CUDA kernel on a
       card, its plain version on the CPU) into (M_pad, Cout_pad) partial
       products;
    4. a fixed-order sum of the valid slots' rows (:func:`scatter_valid`)
       into the (n_out, Cout) output.

    Cin is not padded: the kernel masks its ragged edge.
    """
    feats = feats.float()
    tiles = build_tap_tiles(kmap, _sparsity.row_nonzero(feats), bm=bm, bo=bo)
    lhs = feats[tiles.gather_idx.long()]
    # in place: a torch.where copy would add a third (M_pad, Cin) buffer at
    # full width (4.6 GB at Cin 512) beside lhs and the partial products
    lhs.masked_fill_(~tiles.slot_valid[:, None], 0.0)
    ps = spconv_gemm(lhs, _pad_cout(weights.float(), BN), tiles.tile_tap,
                     tiles.tile_nz, bm=bm)
    del lhs
    out = scatter_valid(ps, tiles, kmap.shape[0])[:, :weights.shape[-1]]
    if bias is not None:
        out = out + bias
    return out


class _Epilogue(torch.autograd.Function):
    """The BN/ReLU epilogue outside a kernel; inference only."""

    @staticmethod
    def forward(ctx, out, scale, shift, valid):
        c = out.shape[1]
        pad = -c % BN
        y, nz = epilogue_math(F.pad(out.float(), (0, pad)),
                              F.pad(scale.float(), (0, pad)),
                              F.pad(shift.float(), (0, pad)), valid)
        ctx.mark_non_differentiable(nz)
        return y[:, :c].to(out.dtype), nz

    @staticmethod
    def backward(ctx, g, g_nz):
        raise NotImplementedError(
            "the fused BN/ReLU epilogue is inference-only: its backward "
            "would differentiate through elided activation state. For "
            "training, compose subm_conv3 + batch_norm + relu unfused.")


def apply_epilogue(out: torch.Tensor, epilogue: FusedEpilogue):
    """Apply a :class:`FusedEpilogue` to a finished (n_out, Cout) output
    (the tap-scan path). Returns ``(y, ActSparsity)`` exactly as the
    in-kernel epilogue emits them. Inference-only: its backward raises."""
    y, nz = _Epilogue.apply(out, epilogue.scale, epilogue.shift,
                            epilogue.valid)
    nzb = nz.bool()
    return y, _sparsity.ActSparsity(row_nz=nzb.any(dim=-1), blk_nz=nzb,
                                    blk=BN)
