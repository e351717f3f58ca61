"""Plain PyTorch versions of the two gather-GEMM kernels: their oracles.

:func:`spconv_gemm_fused_ref` is the same math as the output-stationary
CUDA kernel (csrc/spconv_gemm_fused.cu): for every slot of a live tile
whose target lies in the tile's output block, add ``feats[gather] @
W[tap]`` into ``out[scatter]``. :func:`spconv_gemm_ref` is the materialized
kernel's (csrc/spconv_gemm.cu): each bm-row tile of a pre-gathered lhs
times its tap's weights, zeros for dead tiles. Both loop over taps —
select the tap's live slots or tiles, one matmul — rather than
materializing a per-tile weight copy, so they fit on the card at serving
sizes.

:func:`spconv_gemm_fused_ref_vjp` is the training backward of every
layer, on the card too: over a :class:`SlotIndex` built once per tile set
(the live slots grouped by tap, their counts on the host), with sums in an
order fixed by the tiles and no host read, so a training step replays
from a CUDA graph and two runs agree bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

#: width of the liveness column groups the epilogue emits
BN = 128


def epilogue_math(out: torch.Tensor, scale: torch.Tensor,
                  shift: torch.Tensor, valid: torch.Tensor):
    """``relu(out * scale + shift)`` masked by ``valid``, and the
    per-(row, BN-column group) liveness of the stored values (int32)."""
    y = out * scale[None, :] + shift[None, :]
    y = torch.where(valid[:, None] != 0, y.clamp(min=0.0),
                    torch.zeros((), dtype=y.dtype, device=y.device))
    n, c = y.shape
    nz = (y.reshape(n, c // BN, BN) != 0).any(dim=-1).to(torch.int32)
    return y, nz


def spconv_gemm_ref(lhs: torch.Tensor, weights: torch.Tensor,
                    tile_tap: torch.Tensor, tile_nz: torch.Tensor, *,
                    bm: int = 128) -> torch.Tensor:
    """``out[t*bm:(t+1)*bm] = nz_t * (lhs_tile_t @ weights[tile_tap[t]])``.

    lhs (M, Cin) pre-gathered rows with M a multiple of bm; weights (K,
    Cin, Cout); tile_tap / tile_nz (M/bm,). Returns the (M, Cout) float32
    partial products, one row per map slot, for an external scatter-add.
    """
    m, c_in = lhs.shape
    out = torch.zeros((m // bm, bm, weights.shape[-1]), dtype=torch.float32,
                      device=lhs.device)
    tiles = lhs.reshape(m // bm, bm, c_in)
    live = tile_nz != 0
    for t in range(weights.shape[0]):
        sel = torch.nonzero(live & (tile_tap == t)).squeeze(1)
        if sel.numel() == 0:
            continue
        out[sel] = tiles[sel].float() @ weights[t].float()
    return out.reshape(m, weights.shape[-1])


def spconv_gemm_fused_ref(feats: torch.Tensor, weights: torch.Tensor,
                          gather_idx: torch.Tensor, scatter_idx: torch.Tensor,
                          tile_tap: torch.Tensor, tile_nz: torch.Tensor,
                          tile_ob: torch.Tensor,
                          tile_bk_nz: torch.Tensor | None = None, *, bm: int,
                          bo: int, bk: int | None = None, n_out_pad: int,
                          epi_scale: torch.Tensor | None = None,
                          epi_shift: torch.Tensor | None = None,
                          epi_valid: torch.Tensor | None = None,
                          epilogue: bool = False,
                          index: SlotIndex | None = None):
    """(n_out_pad, Cout_pad) float32 output [, (n_out_pad, Cout_pad/128) nz].

    Takes the kernel wrapper's arguments. Slots outside their tile's
    ``bo``-row output block are padding and dropped; tiles with
    ``tile_nz == 0`` contribute nothing. ``tile_bk_nz`` / ``bk`` only mark
    Cin blocks that are exactly zero, which contribute nothing either, so
    the plain version reads neither. One product a tap over its live
    slots, from ``index`` (the tiles' :func:`slot_index`, built here when
    None, with host reads): given one built beforehand, the call reads
    nothing back to the host and can be captured into a CUDA graph.
    """
    del tile_bk_nz, bk
    if index is None:
        index = slot_index(gather_idx, scatter_idx, tile_tap, tile_nz,
                           tile_ob, bm=bm, bo=bo, n_in=feats.shape[0])
    out = torch.zeros((n_out_pad, weights.shape[-1]), dtype=torch.float32,
                      device=feats.device)
    for t, lo, hi in index.taps:
        rows = feats[index.gather[lo:hi]].float()
        out.index_add_(0, index.scatter[lo:hi], rows @ weights[t].float())
    if not epilogue:
        return out
    return epilogue_math(out, epi_scale, epi_shift, epi_valid)


def live_slots(scatter_idx, tile_nz, tile_ob, *, bm, bo):
    """(M_pad,) bool: the slots that add into the output, those of a live
    tile whose target lies in the tile's output block."""
    local = scatter_idx - tile_ob.repeat_interleave(bm) * bo
    return ((local >= 0) & (local < bo)
            & (tile_nz != 0).repeat_interleave(bm))


class SlotIndex(NamedTuple):
    """What :func:`spconv_gemm_fused_ref_vjp` reads of one tile set: its
    live slots grouped by tap, with their counts held on the host. Built
    once per tile set, where it may read back to the host; the backward
    over it reads nothing back, so it can be captured into a CUDA graph.
    """
    gather: torch.Tensor    # (S,) int64 source row of each live slot,
                            # tap after tap, slot order within a tap
    scatter: torch.Tensor   # (S,) int64 output row of each
    taps: tuple             # (tap, lo, hi): the tap's slots are [lo, hi)
    by_row: torch.Tensor    # (N_in, L) int64: each source row's slots
                            # in ascending order, then S (a zero row)


def slot_index(gather_idx, scatter_idx, tile_tap, tile_nz, tile_ob, *, bm,
               bo, n_in) -> SlotIndex:
    """The :class:`SlotIndex` of a tile set over ``n_in`` source rows.

    ``by_row`` fixes the order in which the backward sums each source
    row's contributions: a stable sort of the live slots by source row.
    Its width L is the most live slots any row feeds (at most K on a
    cloud without duplicate voxels). The slots, the per-tap counts and L
    are read back to the host here."""
    dev = gather_idx.device
    live = live_slots(scatter_idx, tile_nz, tile_ob, bm=bm, bo=bo)
    slot_tap = tile_tap.long().repeat_interleave(bm)
    key = torch.where(live, slot_tap, torch.iinfo(torch.int64).max)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(slot_tap[live], minlength=1).tolist()
    n = sum(counts)
    slots = order[:n]
    gather = gather_idx[slots].long()
    scatter = scatter_idx[slots].long()
    taps, lo = [], 0
    for t, c in enumerate(counts):
        if c:
            taps.append((t, lo, lo + c))
        lo += c
    rows = torch.sort(gather, stable=True)
    per_row = torch.bincount(gather, minlength=n_in)
    starts = torch.cumsum(per_row, 0) - per_row
    rank = torch.arange(n, device=dev) - starts[rows.values]
    width = max(int(per_row.max()), 1) if n else 1
    by_row = torch.full((n_in * width,), n, dtype=torch.long, device=dev)
    by_row[rows.values * width + rank] = rows.indices
    return SlotIndex(gather, scatter, tuple(taps), by_row.view(n_in, width))


#: elements of one (rows, L, Cin) block of the backward's row sums
CHUNK_ELEMS = 1 << 24


def spconv_gemm_fused_ref_vjp(feats: torch.Tensor, weights: torch.Tensor,
                              g: torch.Tensor, index: SlotIndex):
    """``(dfeats, dweights)`` of :func:`spconv_gemm_fused_ref` (no
    epilogue) for the output cotangent ``g``, float32, over the tiles'
    :func:`slot_index`.

    ``weights`` is (K, Cin, Cout) and ``g`` has at least Cout columns;
    columns past Cout (the zero padding) are not read. Each slot that adds
    ``feats[gather] @ W[tap]`` into ``out[scatter]`` sends ``g[scatter] @
    W[tap]^T`` back to its source row, whether or not that row is zero,
    and ``feats[gather]^T g[scatter]`` to its tap.

    Every sum runs in an order fixed by the tiles, with no atomics and no
    host read: one product a tap over its slots for ``dweights``; each
    source row's contributions added in ``index.by_row``'s order.
    """
    k, c_in, c_out = weights.shape
    n = index.gather.shape[0]
    w = weights.float()
    x = feats[index.gather].float()
    gs = g[index.scatter, :c_out].float()
    contrib = torch.zeros((n + 1, c_in), dtype=torch.float32,
                          device=feats.device)
    dweights = torch.zeros((k, c_in, c_out), dtype=torch.float32,
                           device=weights.device)
    for t, lo, hi in index.taps:
        torch.mm(x[lo:hi].t(), gs[lo:hi], out=dweights[t])
        torch.mm(gs[lo:hi], w[t].t(), out=contrib[lo:hi])
    n_in, width = index.by_row.shape
    dfeats = torch.empty((n_in, c_in), dtype=torch.float32,
                         device=feats.device)
    step = max(1, CHUNK_ELEMS // (width * c_in))
    for lo in range(0, n_in, step):
        hi = min(lo + step, n_in)
        torch.sum(contrib[index.by_row[lo:hi]], dim=1, out=dfeats[lo:hi])
    return dfeats, dweights
