"""Wrapper of the CUDA flash-attention kernel (csrc/flash_attention.cu).

:func:`flash_attention` checks its inputs, then launches the hand-written
kernel on CUDA tensors (two routes of one source, both on the tensor
cores: bf16 through ``wgmma``, float32 as split-precision 3xTF32
``mma.sync``), or runs the plain version (ref.py) on CPU tensors. There is
no fallback: a CUDA input launches the kernel or raises.
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
from repro_torch.kernels.flash_attention.ref import attention_ref

#: number of times the CUDA kernel was launched
launches = 0
#: the launch counters above
COUNTERS = ("launches",)

#: head dims the kernel is instantiated for: those of the repo's configs
HEAD_DIMS = (64, 80, 128, 256)

_P = ctypes.c_void_p
_I = ctypes.c_int


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Online-softmax attention; see ref.py for the semantics.

    q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D), contiguous, all bf16 or all
    float32, each starting on a 16-byte boundary (the bf16 route loads them
    by TMA; both devices take the same inputs), with Hq % Hkv == 0,
    Sq <= Skv and D in :data:`HEAD_DIMS`. Returns (B, Hq, Sq, D) in q's
    dtype.
    """
    global launches
    if not isinstance(q, torch.Tensor) or q.dtype not in (torch.bfloat16,
                                                          torch.float32):
        raise TypeError("q must be a torch.bfloat16 or torch.float32 tensor")
    _check("q", q, q.dtype, (None, None, None, None))
    b, hq, sq, d = q.shape
    _check("k", k, q.dtype, (b, None, None, d))
    hkv, skv = k.shape[1], k.shape[2]
    _check("v", v, q.dtype, (b, hkv, skv, d))
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if hkv == 0 or hq % hkv != 0:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if sq > skv:
        raise ValueError(f"Sq={sq} > Skv={skv}: queries align to the end of "
                         f"the keys")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} does not start on a 16-byte boundary "
                             f"(storage offset {t.storage_offset()})")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v of flash_attention must share a device")
    if dev.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    out = torch.empty_like(q)
    fn = build.launch_fn("flash_attention",
                         [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          ctypes.c_float, _I, _P])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            hkv, sq, skv, d, int(causal), window, d ** -0.5,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    if b > 0 and hq > 0 and sq > 0:
        launches += 1
    return out
