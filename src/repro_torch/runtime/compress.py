"""Gradient compression for the data-parallel all-reduce over ``pod``, the
counterpart of the reference's ``src/repro/runtime/compress.py``.

Each participant quantizes its tensor to int8 against a per-tensor scale,
max |x| / 127, and the scale is maxed over the axis first, so that one
codebook holds on every rank. The quantized values are summed exactly in
int32 and the mean is taken in float32: the only error is each rank's
local rounding, at most scale / 2 an element (round half to even, clipped
to +-127), and so at most scale / 2 in the mean.

The sum runs on int32, 4 bytes an element, as the reference's ``psum`` of
``q.astype(jnp.int32)`` does: the all-reduce moves as many bytes as a
float32 one, plus one float32 scalar for the scale's MAX.
:func:`payload_bytes` counts them. int8 on the wire would need a sum that
cannot overflow int8, which neither implementation has.

:func:`compressed_psum_mean` works over the process group of one named
dimension of a ``torch.distributed`` ``DeviceMesh`` (``runtime/sharding``,
``launch/mesh.py``), through ``_functional_collectives``; with gloo, CUDA
tensors go as they are where gloo takes them (``chip_smoke.py`` phase
``gloo_probe`` records which).
"""
from __future__ import annotations

import torch

from repro_torch.runtime import sharding as rs

#: the scale's floor, so an all-zero tensor quantizes to zeros
SCALE_FLOOR = 1e-12


def scale_of(x: torch.Tensor) -> torch.Tensor:
    """A tensor's own scale: max(max |x|, 1e-12) / 127, float32."""
    return torch.clamp(x.float().abs().max(), min=SCALE_FLOOR) / 127.0


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as jnp.round does
    return torch.clamp(torch.round(x.float() / scale), -127, 127)


def quantize_int8(x: torch.Tensor):
    """(int8 values, float32 scalar scale) of ``x``: scale = max(max|x|,
    1e-12) / 127, values round(x / scale) clipped to +-127."""
    scale = scale_of(x)
    return _quantize(x, scale).to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _group(axis: str, mesh):
    mesh = rs.get_mesh() if mesh is None else mesh
    if mesh is None:
        raise ValueError("compressed_psum_mean needs a mesh: pass mesh= or "
                         "call it inside runtime.sharding.set_mesh")
    return mesh.get_group(axis)


def compressed_psum_mean(x: torch.Tensor, axis: str,
                         mesh=None) -> torch.Tensor:
    """The mean over the ranks of mesh dimension ``axis`` (of ``mesh``,
    default the active one) of the int8-compressed ``x``, in ``x``'s
    dtype. Every rank of the group calls it with a tensor of one shape;
    every rank gets the same result."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    group = _group(axis, mesh)
    scale = funcol.all_reduce(scale_of(x).reshape(1), "max", group)
    scale = funcol.wait_tensor(scale)[0]
    q = _quantize(x, scale).to(torch.int32)
    total = funcol.wait_tensor(funcol.all_reduce(q, "sum", group))
    n = dist.get_world_size(group)
    return (total.float() * scale / n).to(x.dtype)


def grad_allreduce_compressed(grads, mesh, axis: str = "pod"):
    """:func:`compressed_psum_mean` over ``axis`` of every tensor of the
    gradient tree ``grads`` (a dict, list or tuple of tensors, nested),
    which arrives replicated over the mesh's other dimensions; the tree's
    form is kept."""
    from torch.utils._pytree import tree_map
    return tree_map(lambda g: compressed_psum_mean(g, axis, mesh)
                    if isinstance(g, torch.Tensor) else g, grads)


def payload_bytes(x: torch.Tensor) -> int:
    """Bytes a rank contributes to one :func:`compressed_psum_mean` of
    ``x``: the int32 sum's buffer and the float32 scale."""
    return x.numel() * 4 + 4
