"""Plain PyTorch version of the block-masked matmul: its oracle."""
from __future__ import annotations

import torch


def masked_matmul_ref(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                      *, bm: int = 128, bk: int = 128) -> torch.Tensor:
    """``A @ B`` with A's (bm x bk) tiles zeroed where ``mask`` is 0, in
    float32. A mask that kills a nonzero tile changes the result: the
    kernel must do the same."""
    live = (mask != 0).repeat_interleave(bm, dim=0).repeat_interleave(
        bk, dim=1)
    a_kept = torch.where(live, a, torch.zeros((), dtype=a.dtype,
                                              device=a.device))
    return (a_kept.float() @ b.float()).to(a.dtype)
