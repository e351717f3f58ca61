"""Dispatch of attention: the CUDA kernel on the card, the plain version
on the CPU or when asked for.

The reference takes its Pallas kernel only for block-divisible shapes
(Sq and Skv multiples of 128): that is a constraint of the TPU's
BlockSpecs, not of the function. The CUDA kernel masks its own ragged
edges, so every shape on the card goes through it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              impl: str = "kernel") -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) -> (B, Hq, Sq, D).

    ``impl="kernel"``: the kernel wrapper on a CUDA tensor (it launches or
    raises), the plain version on a CPU tensor. ``impl="ref"``: the plain
    version on any device.
    """
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown attention impl {impl!r}")
    # a CPU tensor skips the wrapper: the plain version takes every head
    # dim (the reduced configs' 16), the kernel only those of HEAD_DIMS
    if impl == "ref" or q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention(q, k, v, causal=causal, window=window)
