"""Wrapper of the CUDA block-masked matmul (csrc/masked_matmul.cu).

:func:`masked_matmul` checks its inputs, then launches the hand-written
kernel on CUDA tensors, or runs the plain version (ref.py) on CPU tensors.
There is no fallback: a CUDA input launches the kernel or raises.
``launches`` counts kernel launches.
A CUDA graph launches the kernels it captured at each replay, and
``runtime/graph.py`` adds them to these counters then: they count what
the card ran, replays included, and a capture, which runs nothing,
leaves them as they were. :data:`COUNTERS` names them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import check_tensor as _check
from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref

#: number of times the CUDA kernel was launched
launches = 0
#: the launch counters above
COUNTERS = ("launches",)

_P = ctypes.c_void_p
_I = ctypes.c_int


def masked_matmul(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor, *,
                  bm: int = 128, bn: int = 128,
                  bk: int = 128) -> torch.Tensor:
    """``C = A @ B`` skipping the (bm x bk) tiles of A where ``mask`` is 0.

    a (M, K), b (K, N) float32 with M, N, K multiples of bm, bn, bk;
    mask (M/bm, K/bk) int32, 0 = skip the tile (load and MACs). A skipped
    tile counts as zero even where A is not. Returns (M, N) float32.
    """
    global launches
    _check("a", a, torch.float32, (None, None))
    m, k = a.shape
    _check("b", b, torch.float32, (k, None))
    n = b.shape[1]
    for name, size, blk in (("M", m, bm), ("N", n, bn), ("K", k, bk)):
        if blk <= 0 or size % blk != 0:
            raise ValueError(f"{name}={size} is not a multiple of its tile "
                             f"{blk}")
    _check("mask", mask, torch.int32, (m // bm, k // bk))
    dev = a.device
    if b.device != dev or mask.device != dev:
        raise ValueError("all inputs of masked_matmul must share a device")
    if dev.type == "cpu":
        return masked_matmul_ref(a, b, mask, bm=bm, bk=bk)
    if dev.type != "cuda":
        raise ValueError(f"masked_matmul runs on cuda or cpu, not {dev}")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    fn = build.launch_fn("masked_matmul",
                         [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
    rc = fn(a.data_ptr(), b.data_ptr(), mask.data_ptr(), out.data_ptr(), m,
            n, k, bm, bk, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"masked_matmul launch failed: CUDA error {rc}")
    if m > 0 and n > 0:
        launches += 1
    return out
