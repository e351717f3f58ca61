"""SPAC: inherent-sparsity exploitation (paper §V-B) at row and block grain.

A map whose source row is all zero contributes exactly 0 (row grain); a
dead Cin block of a live row contributes exactly 0 too (block grain). The
gather-GEMM kernel skips both. :class:`ActSparsity` threads the post-ReLU
zero pattern that one layer's fused epilogue emits into the next layer's
masks without sweeping the features again.
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
