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
"""
from __future__ import annotations

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
                          epilogue: bool = False):
    """(n_out_pad, Cout_pad) float32 output [, (n_out_pad, Cout_pad/128) nz].

    Takes the kernel wrapper's arguments. Slots outside their tile's
    ``bo``-row output block are padding and dropped; tiles with
    ``tile_nz == 0`` contribute nothing. ``tile_bk_nz`` / ``bk`` only mark
    Cin blocks that are exactly zero, which contribute nothing either, so
    the plain version reads neither.
    """
    del tile_bk_nz, bk
    out = torch.zeros((n_out_pad, weights.shape[-1]), dtype=torch.float32,
                      device=feats.device)
    for t, sel in _tap_slots(scatter_idx, tile_tap, tile_nz, tile_ob,
                             bm=bm, bo=bo, k=weights.shape[0]):
        rows = feats[gather_idx[sel].long()].float()
        out.index_add_(0, scatter_idx[sel].long(), rows @ weights[t].float())
    if not epilogue:
        return out
    return epilogue_math(out, epi_scale, epi_shift, epi_valid)


def _tap_slots(scatter_idx, tile_tap, tile_nz, tile_ob, *, bm, bo, k):
    """``(tap, slots)`` for each tap with a slot that adds into the output:
    a slot of a live tile whose target lies in the tile's output block."""
    local = scatter_idx - tile_ob.repeat_interleave(bm) * bo
    live = ((local >= 0) & (local < bo)
            & (tile_nz != 0).repeat_interleave(bm))
    slot_tap = tile_tap.repeat_interleave(bm)
    for t in range(k):
        sel = torch.nonzero(live & (slot_tap == t)).squeeze(1)
        if sel.numel():
            yield t, sel


def spconv_gemm_fused_ref_vjp(feats: torch.Tensor, weights: torch.Tensor,
                              g: torch.Tensor, gather_idx: torch.Tensor,
                              scatter_idx: torch.Tensor,
                              tile_tap: torch.Tensor, tile_nz: torch.Tensor,
                              tile_ob: torch.Tensor, *, bm: int, bo: int):
    """``(dfeats, dweights)`` of :func:`spconv_gemm_fused_ref` (no
    epilogue) for the output cotangent ``g``, float32.

    ``weights`` is (K, Cin, Cout) and ``g`` has at least Cout columns;
    columns past Cout (the zero padding) are not read. Each slot that adds
    ``feats[gather] @ W[tap]`` into ``out[scatter]`` sends ``g[scatter] @
    W[tap]^T`` back to its source row, whether or not that row is zero,
    and ``feats[gather]^T g[scatter]`` to its tap.
    """
    c_out = weights.shape[-1]
    dfeats = torch.zeros(feats.shape, dtype=torch.float32,
                         device=feats.device)
    dweights = torch.zeros(weights.shape, dtype=torch.float32,
                           device=weights.device)
    for t, sel in _tap_slots(scatter_idx, tile_tap, tile_nz, tile_ob,
                             bm=bm, bo=bo, k=weights.shape[0]):
        src = gather_idx[sel].long()
        gs = g[scatter_idx[sel].long(), :c_out].float()
        dweights[t] = feats[src].float().t() @ gs
        dfeats.index_add_(0, src, gs @ weights[t].float().t())
    return dfeats, dweights
