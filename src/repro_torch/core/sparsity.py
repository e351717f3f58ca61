"""SPAC: inherent-sparsity exploitation (paper §V-B) at row and block grain.

A map whose source row is all zero contributes exactly 0 (row grain:
:func:`compact_kmap`, or build-time elision in ``build_tap_tiles``); a
dead Cin block of a live row contributes exactly 0 too (block grain). The
gather-GEMM kernel skips both. An all-zero (bm x bk) tile of a dense
operand is skipped by the block-masked matmul (tile grain:
:func:`block_mask`). Elision is lossless in the forward only: the gradient
of a zero row is ``Wᵀ·g``, so backward passes differentiate the un-elided
maps. :class:`ActSparsity` threads the post-ReLU zero pattern that one
layer's fused epilogue emits into the next layer's masks without sweeping
the features again.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def row_nonzero(feats: torch.Tensor) -> torch.Tensor:
    """(N,) bool — row has any nonzero element."""
    return (feats != 0).any(dim=-1)


def row_block_nonzero(feats: torch.Tensor, bk: int) -> torch.Tensor:
    """(N, Cin/bk) bool — Cin block of the row has any nonzero element."""
    n, c = feats.shape
    if c % bk != 0:
        raise ValueError(f"bk={bk} must divide the channel count {c}")
    return (feats.reshape(n, c // bk, bk) != 0).any(dim=-1)


class ActSparsity(NamedTuple):
    """Activation-sparsity masks threaded from layer to layer.

    ``blk_nz`` covers column groups of width ``blk``; groups may overhang
    the true channel count (overhang columns are zero padding, never live).
    ``blk_nz is None`` means row grain only.
    """

    row_nz: torch.Tensor                 # (N,) bool
    blk_nz: torch.Tensor | None = None   # (N, G) bool, G*blk >= C
    blk: int = 0                         # column-group width (0: row only)

    def block_liveness(self, c_in: int, bk: int) -> torch.Tensor | None:
        """(N, c_in/bk) bool when the threaded groups align with the
        consumer's Cin blocking (bk a multiple of ``blk``), else None."""
        if self.blk_nz is None or self.blk <= 0:
            return None
        if bk % self.blk != 0 or c_in % bk != 0:
            return None
        gpb = bk // self.blk
        n_k = c_in // bk
        if n_k * gpb > self.blk_nz.shape[1]:
            return None
        n = self.blk_nz.shape[0]
        return self.blk_nz[:, :n_k * gpb].reshape(n, n_k, gpb).any(-1)


def compact_kmap(kmap: torch.Tensor, row_nz: torch.Tensor) -> torch.Tensor:
    """Drop maps whose source row is all zero: they contribute nothing.

    Forward-only: differentiate through
    :func:`repro_torch.core.rulebook.apply_kmap_gather_spac`, never through
    the compacted map directly (a zero row still gets ``Wᵀ·g``).
    """
    src_nz = row_nz[kmap.clamp(min=0).long()]
    return torch.where((kmap >= 0) & src_nz, kmap,
                       torch.full_like(kmap, -1))


def block_mask(x: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """(M/bm, K/bk) bool — tile has any nonzero element: the mask the
    block-masked matmul skips by. Raises ``ValueError`` on non-multiple
    shapes; ``masked_matmul.ops.sparse_dense_matmul`` pads and slices."""
    m, k = x.shape
    if m % bm != 0 or k % bk != 0:
        raise ValueError(
            f"block_mask needs tile-multiple shapes, got ({m}, {k}) for "
            f"bm={bm}, bk={bk}; pad before masking")
    return (x.reshape(m // bm, bm, k // bk, bk) != 0).any(dim=3).any(dim=1)


def act_from_feats(feats: torch.Tensor, blk: int = 128) -> ActSparsity:
    """Sweep the features once into an :class:`ActSparsity` (what a layer
    uses when no epilogue-emitted act is threaded to it)."""
    n, c = feats.shape
    g = -(-c // blk)
    f = torch.nn.functional.pad(feats, (0, g * blk - c))
    blk_nz = (f.reshape(n, g, blk) != 0).any(dim=-1)
    return ActSparsity(row_nz=blk_nz.any(dim=-1), blk_nz=blk_nz, blk=blk)


class SparsityStats(NamedTuple):
    element_sparsity: torch.Tensor   # fraction of zero elements
    row_sparsity: torch.Tensor       # fraction of all-zero rows
    map_elision: torch.Tensor        # fraction of valid maps dropped
    macs_dense: torch.Tensor         # MACs without sparsity
    macs_row_elided: torch.Tensor    # MACs after row-grain elision


def sparsity_stats(feats: torch.Tensor, kmap: torch.Tensor,
                   c_out: int) -> SparsityStats:
    """Row-grain elision of one layer against the element grain."""
    valid = kmap >= 0
    nz_rows = row_nonzero(feats)
    kept = valid & nz_rows[kmap.clamp(min=0).long()]
    c_in = feats.shape[-1]
    n_valid, n_kept = valid.sum(), kept.sum()
    # an empty kmap elides nothing: 0.0, not 1 - 0/1
    elision = torch.where(n_valid > 0,
                          1.0 - n_kept / n_valid.clamp(min=1), 0.0)
    return SparsityStats(
        element_sparsity=(feats == 0).float().mean(),
        row_sparsity=1.0 - nz_rows.float().mean(),
        map_elision=elision,
        macs_dense=n_valid * c_in * c_out,
        macs_row_elided=n_kept * c_in * c_out)
