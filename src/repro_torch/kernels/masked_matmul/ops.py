"""Block-masked matmul with the mask built from the operand itself.

:func:`sparse_dense_matmul` pads A and B to the tile grid, builds A's
block mask with ``sparsity.block_mask`` and runs the kernel wrapper;
:func:`tile_skip_fraction` is the share of tiles it skips.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.sparsity import block_mask
from repro_torch.kernels.masked_matmul.kernel import masked_matmul


def sparse_dense_matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                        bn: int = 128, bk: int = 128) -> torch.Tensor:
    """``A @ B`` skipping the all-zero (bm x bk) tiles of A (SPAC, §V-B).

    Shapes that are not tile multiples are zero-padded to the tile grid and
    the output is sliced back: the padding only adds skippable tiles. The
    wrapper runs the CUDA kernel on a card, its plain version on the CPU.
    """
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    mp, kp, npad = -(-m // bm) * bm, -(-k // bk) * bk, -(-n // bn) * bn
    ap = F.pad(a.float(), (0, kp - k, 0, mp - m)).contiguous()
    bp = F.pad(b.float(), (0, npad - n, 0, kp - k)).contiguous()
    mask = block_mask(ap, bm, bk).to(torch.int32)
    return masked_matmul(ap, bp, mask, bm=bm, bn=bn, bk=bk)[:m, :n]


def tile_skip_fraction(a: torch.Tensor, bm: int = 128,
                       bk: int = 128) -> torch.Tensor:
    """Share of A's (bm x bk) tiles the block-masked matmul skips."""
    return 1.0 - block_mask(a, bm, bk).float().mean()
