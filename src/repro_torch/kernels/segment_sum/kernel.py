"""Wrapper of the CUDA fixed-order segment sum (csrc/segment_sum.cu).

:func:`segment_sum` launches the hand-written kernel on CUDA tensors, or
runs the plain version (ref.py) on CPU tensors. There is no fallback: a
CUDA input launches the kernel or raises. ``launches`` counts kernel
launches.
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
from repro_torch.kernels.segment_sum.ref import segment_sum_ref

#: number of times the CUDA kernel was launched
launches = 0
#: the launch counters above
COUNTERS = ("launches",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def segment_sum(vals: torch.Tensor, seg) -> torch.Tensor:
    """``(n_rows, ...)``: row r adds ``vals[i]`` for every source i whose
    destination is r, in ascending i, from zero. ``seg`` is the
    :func:`repro_torch.core.segment.segments` index of the n destinations
    of ``vals`` (n, ...). On the card ``vals`` is float32 and the sum is
    one launch, bit-equal to the plain version."""
    global launches
    dev = vals.device
    for name in ("key", "src", "starts"):
        if getattr(seg, name).device != dev:
            raise ValueError(f"segment_sum: the index's {name} is on "
                             f"{getattr(seg, name).device}, vals on {dev}")
    if dev.type == "cpu":
        return segment_sum_ref(vals, seg)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum runs on cuda or cpu, not {dev}")
    n, n_rows = vals.shape[0], seg.n_rows
    if vals.dtype != torch.float32:
        raise TypeError(f"segment_sum on the card takes float32 values, "
                        f"not {vals.dtype}")
    _check("src", seg.src, torch.int64, (n,))
    _check("starts", seg.starts, torch.int64, (n_rows + 1,))
    flat = vals.reshape(n, -1).contiguous()
    c = flat.shape[1]
    if n * c >= 2 ** 31:
        raise ValueError(f"segment_sum takes fewer than 2^31 values, not "
                         f"({n}, {c})")
    out = torch.empty((n_rows, c), dtype=torch.float32, device=dev)
    fn = build.launch_fn("segment_sum", [_P, _P, _P, _P, _L, _I, _P])
    rc = fn(flat.data_ptr(), seg.src.data_ptr(), seg.starts.data_ptr(),
            out.data_ptr(), n_rows, c,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {rc}")
    if n_rows > 0 and c > 0:
        launches += 1
    return out.reshape(n_rows, *vals.shape[1:])
