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

Under a mesh q, k and v arrive as DTensors, sharded on heads over
``model`` (and on the batch over the data axes), and the kernel takes
plain tensors: :func:`_local_heads` runs it (or the plain version) on
each rank's own heads and wraps the output again with q's placements, the
counterpart of GSPMD partitioning the reference's Pallas call. K and V
may be replicated beside a sharded q (fewer KV heads than ``model``
ranks, the reference's "GQA trap"): each rank then takes the KV heads its
q heads use, and their gradient is a partial sum over the ranks.
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


def _local_heads(fn, q, k, v):
    """``fn(q_local, k_local, v_local)`` on this rank's heads of DTensors
    q (B, Hq, S, D), k, v (B, Hkv, S, D), the output a DTensor placed as
    q. Sharded dims: the batch (q, k and v alike) and the heads; a KV
    head dim replicated where q's is sharded is sliced to the KV heads of
    this rank's q heads (expanded to one a q head where those do not form
    whole GQA groups)."""
    from torch.distributed.tensor import DTensor, Partial
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset as local_of
    mesh = q.device_mesh
    if k.placements != v.placements or k.device_mesh != mesh \
            or v.device_mesh != mesh:
        raise ValueError("k and v must share their placements and q's mesh")
    kgrad = []
    for qp, kp in zip(q.placements, k.placements):
        if qp.is_partial() or kp.is_partial() or any(
                p.is_shard() and p.dim not in (0, 1) for p in (qp, kp)):
            raise ValueError(f"attention under a mesh takes q, k, v "
                             f"sharded on batch and heads only, not "
                             f"{q.placements} / {k.placements}")
        if qp.is_shard(0) != kp.is_shard(0):
            raise ValueError("q and k must shard the batch alike")
        if kp.is_shard(1) and not qp.is_shard(1):
            raise ValueError("k's heads are sharded where q's are not")
        # a replicated KV head dim beside sharded q heads: each rank uses
        # some of them, so its gradient is a partial sum
        kgrad.append(Partial() if qp.is_shard(1) and not kp.is_shard(1)
                     else kp)
    hq, hkv = q.shape[1], k.shape[1]
    group = hq // hkv
    (_, lhq, _, _), (_, h0, _, _) = local_of(q.shape, mesh, q.placements)
    (_, lhk, _, _), (_, k0, _, _) = local_of(k.shape, mesh, k.placements)
    ql = q.to_local()
    kl = k.to_local(grad_placements=kgrad)
    vl = v.to_local(grad_placements=kgrad)
    kv0, kv1 = h0 // group, (h0 + lhq - 1) // group + 1
    if not (k0 <= kv0 and kv1 <= k0 + lhk):
        raise ValueError(f"rank's q heads [{h0}, {h0 + lhq}) need KV heads "
                         f"[{kv0}, {kv1}) beyond its [{k0}, {k0 + lhk})")
    if (kv0, kv1) != (k0, k0 + lhk):
        kl, vl = kl[:, kv0 - k0:kv1 - k0], vl[:, kv0 - k0:kv1 - k0]
        whole = (h0 % group == 0 and lhq % group == 0) or kv1 - kv0 == 1
        if not whole:
            # q heads straddle GQA groups: one KV head a q head
            idx = torch.arange(h0, h0 + lhq, device=ql.device) // group - kv0
            kl, vl = kl[:, idx], vl[:, idx]
    out = fn(ql, kl.contiguous(), vl.contiguous())
    return DTensor.from_local(out, mesh, q.placements, run_check=False,
                              shape=q.shape, stride=q.stride())


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              impl: str = "kernel") -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) -> (B, Hq, Sq, D).

    ``impl="kernel"``: the kernel wrapper on a CUDA tensor (it launches or
    raises), the plain version on a CPU tensor; with grad enabled and an
    input that requires it, through :class:`_KernelAttention`.
    ``impl="ref"``: the plain version on any device, differentiated by
    autograd. DTensors (under a mesh) go through :func:`_local_heads`.
    """
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown attention impl {impl!r}")
    from repro_torch.runtime.sharding import is_dtensor
    if is_dtensor(q):
        return _local_heads(lambda a, b, c: attention(
            a, b, c, causal=causal, window=window, impl=impl), q, k, v)
    if impl == "ref":
        return attention_ref(q, k, v, causal=causal, window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _KernelAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window)
