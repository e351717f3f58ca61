"""Dispatch of attention: the CUDA kernel on the card, the plain version
on the CPU or when asked for.

The reference takes its Pallas kernel only for block-divisible shapes
(Sq and Skv multiples of 128): that is a constraint of the TPU's
BlockSpecs, not of the function. The CUDA kernel masks its own ragged
edges, so every shape on the card goes through it.

The reference has no backward kernel and no ``custom_vjp``: its training
gradient is the XLA math of ``attention_ref``. So with grad enabled the
kernel path runs as :class:`_KernelAttention`, whose forward launches the
kernel and whose backward recomputes the plain version under autograd and
returns its vector-Jacobian product. It is not a backward kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


def _forward(q, k, v, causal: bool, window: int) -> torch.Tensor:
    # a CPU tensor skips the wrapper: the plain version takes every head
    # dim (the reduced configs' 16), the kernel only those of HEAD_DIMS
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention(q, k, v, causal=causal, window=window)


class _KernelAttention(torch.autograd.Function):
    """Forward: the kernel (the plain version on CPU tensors). Backward:
    the plain version's VJP, recomputed from the saved q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_ref(*leaves, causal=ctx.causal,
                                window=ctx.window)
        dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              impl: str = "kernel") -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) -> (B, Hq, Sq, D).

    ``impl="kernel"``: the kernel wrapper on a CUDA tensor (it launches or
    raises), the plain version on a CPU tensor; with grad enabled and an
    input that requires it, through :class:`_KernelAttention`.
    ``impl="ref"``: the plain version on any device, differentiated by
    autograd.
    """
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "ref":
        return attention_ref(q, k, v, causal=causal, window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _KernelAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window)
