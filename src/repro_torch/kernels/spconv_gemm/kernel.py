"""Wrappers of the two CUDA gather-GEMM kernels.

* :func:`spconv_gemm_fused` — the output-stationary gather-GEMM
  (csrc/spconv_gemm_fused.cu), the execution backend of every layer.
* :func:`spconv_gemm` — the materialized tiled GEMM over a pre-gathered
  lhs (csrc/spconv_gemm.cu), the baseline behind ``ops.apply_kmap``.

Each checks its inputs, then launches its hand-written kernel on CUDA
tensors, or runs its plain version (ref.py) on CPU tensors. There is no
fallback: a CUDA input launches the kernel or raises. ``launches`` counts
launches of the fused kernel in both modes, ``epilogue_launches`` those
with the fused BN/ReLU epilogue, ``materialized_launches`` those of the
materialized kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import check_tensor as _check
from repro_torch.kernels.spconv_gemm.ref import (BN, spconv_gemm_fused_ref,
                                                 spconv_gemm_ref)

#: Cin step of the kernel; a plan's Cin block ``bk`` must be a multiple of
#: it unless Cin is a single block
KC = 32

#: number of times the CUDA kernel was launched (both modes)
launches = 0
#: of those, launches with the fused epilogue
epilogue_launches = 0
#: number of times the materialized kernel was launched
materialized_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    return build.launch_fn("spconv_gemm_fused",
                           [_P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _I, _I,
                            _P, _I, _I, _P, _P, _P, _P, _P, _I, _P])


def spconv_gemm(lhs: torch.Tensor, weights: torch.Tensor,
                tile_tap: torch.Tensor, tile_nz: torch.Tensor, *,
                bm: int = 128) -> torch.Tensor:
    """Materialized tiled GEMM of one layer.

    lhs (M_pad, Cin) float32 pre-gathered rows, tile-sorted and bm-padded;
    weights (K, Cin, Cout_pad) float32 with Cout_pad a multiple of 128;
    tile_tap / tile_nz (M_pad / bm,) int32. Returns the (M_pad, Cout_pad)
    partial products ``out[t] = nz_t * lhs_t @ W[tap_t]``, zeros for dead
    tiles, ready for the scatter-add.
    """
    global materialized_launches
    _check("lhs", lhs, torch.float32, (None, None))
    m_pad, c_in = lhs.shape
    _check("weights", weights, torch.float32, (None, c_in, None))
    c_out_pad = weights.shape[2]
    if c_out_pad % BN != 0:
        raise ValueError(f"Cout_pad={c_out_pad} must be a multiple of {BN}")
    if bm <= 0 or m_pad % bm != 0:
        raise ValueError(f"M_pad={m_pad} is not a multiple of bm={bm}")
    n_tiles = m_pad // bm
    _check("tile_tap", tile_tap, torch.int32, (n_tiles,))
    _check("tile_nz", tile_nz, torch.int32, (n_tiles,))
    dev = lhs.device
    if any(t.device != dev for t in (weights, tile_tap, tile_nz)):
        raise ValueError("all inputs of spconv_gemm must share a device")
    if dev.type == "cpu":
        return spconv_gemm_ref(lhs, weights, tile_tap, tile_nz, bm=bm)
    if dev.type != "cuda":
        raise ValueError(f"spconv_gemm runs on cuda or cpu, not {dev}")
    out = torch.empty((m_pad, c_out_pad), dtype=torch.float32, device=dev)
    fn = build.launch_fn("spconv_gemm",
                         [_P, _I, _P, _I, _I, _I, _P, _P, _P, _P])
    rc = fn(lhs.data_ptr(), c_in, weights.data_ptr(), c_out_pad, bm,
            n_tiles, tile_tap.data_ptr(), tile_nz.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spconv_gemm launch failed: CUDA error {rc}")
    if n_tiles > 0:
        materialized_launches += 1
    return out


def spconv_gemm_fused(feats: torch.Tensor, weights: torch.Tensor,
                      gather_idx: torch.Tensor, scatter_idx: torch.Tensor,
                      tile_tap: torch.Tensor, tile_nz: torch.Tensor,
                      tile_ob: torch.Tensor,
                      tile_bk_nz: torch.Tensor | None = None, *, bm: int,
                      bo: int, bk: int | None = None, n_out_pad: int,
                      epi_scale: torch.Tensor | None = None,
                      epi_shift: torch.Tensor | None = None,
                      epi_valid: torch.Tensor | None = None,
                      epilogue: bool = False):
    """Output-stationary gather-fused rulebook GEMM of one layer.

    feats (N, Cin) float32; weights (K, Cin, Cout_pad) float32 with
    Cout_pad a multiple of 128; gather_idx / scatter_idx (M_pad,) int32
    slot streams; tile_tap / tile_nz / tile_ob (T,) int32 with
    T = M_pad / bm and tile_ob monotone; tile_bk_nz (T, Cin/bk) int32
    Cin-block liveness (None: tile grain). Returns the (n_out_pad,
    Cout_pad) output; with ``epilogue=True`` also applies
    ``relu(out * epi_scale + epi_shift)`` under ``epi_valid`` (n_out_pad,)
    int32 and returns ``(out, nz)`` with nz (n_out_pad, Cout_pad/128) int32.
    """
    global launches, epilogue_launches
    _check("feats", feats, torch.float32, (None, None))
    c_in = feats.shape[1]
    _check("weights", weights, torch.float32, (None, c_in, None))
    c_out_pad = weights.shape[2]
    if c_out_pad % BN != 0:
        raise ValueError(f"Cout_pad={c_out_pad} must be a multiple of {BN}")
    _check("gather_idx", gather_idx, torch.int32, (None,))
    m_pad = gather_idx.shape[0]
    if bm <= 0 or m_pad % bm != 0:
        raise ValueError(f"M_pad={m_pad} is not a multiple of bm={bm}")
    n_tiles = m_pad // bm
    _check("scatter_idx", scatter_idx, torch.int32, (m_pad,))
    for name, t in (("tile_tap", tile_tap), ("tile_nz", tile_nz),
                    ("tile_ob", tile_ob)):
        _check(name, t, torch.int32, (n_tiles,))
    bk = c_in if bk is None else bk
    if bk <= 0 or c_in % bk != 0:
        raise ValueError(f"bk={bk} must divide Cin={c_in}")
    n_kb = c_in // bk
    if n_kb > 1 and bk % KC != 0:
        raise ValueError(f"bk={bk} must be a multiple of {KC} when Cin is "
                         f"split into blocks")
    if tile_bk_nz is None:
        tile_bk_nz = tile_nz[:, None].expand(n_tiles, n_kb).contiguous()
    _check("tile_bk_nz", tile_bk_nz, torch.int32, (n_tiles, n_kb))
    if bo <= 0 or n_out_pad % bo != 0:
        raise ValueError(f"n_out_pad={n_out_pad} is not a multiple of bo={bo}")
    tensors = [weights, gather_idx, scatter_idx, tile_tap, tile_nz, tile_ob,
               tile_bk_nz]
    if epilogue:
        _check("epi_scale", epi_scale, torch.float32, (c_out_pad,))
        _check("epi_shift", epi_shift, torch.float32, (c_out_pad,))
        _check("epi_valid", epi_valid, torch.int32, (n_out_pad,))
        tensors += [epi_scale, epi_shift, epi_valid]
    dev = feats.device
    if any(t.device != dev for t in tensors):
        raise ValueError("all inputs of spconv_gemm_fused must share a device")
    if dev.type == "cpu":
        return spconv_gemm_fused_ref(
            feats, weights, gather_idx, scatter_idx, tile_tap, tile_nz,
            tile_ob, tile_bk_nz, bm=bm, bo=bo, bk=bk, n_out_pad=n_out_pad,
            epi_scale=epi_scale, epi_shift=epi_shift, epi_valid=epi_valid,
            epilogue=epilogue)
    if dev.type != "cuda":
        raise ValueError(f"spconv_gemm_fused runs on cuda or cpu, not {dev}")

    n_blocks = n_out_pad // bo
    # first tile of each output block's run, computed on the device
    run_start = torch.searchsorted(
        tile_ob, torch.arange(n_blocks + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    out = torch.empty((n_out_pad, c_out_pad), dtype=torch.float32, device=dev)
    nz = (torch.empty((n_out_pad, c_out_pad // BN), dtype=torch.int32,
                      device=dev) if epilogue else None)
    fn = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(feats.data_ptr(), c_in, weights.data_ptr(), c_out_pad,
            gather_idx.data_ptr(), scatter_idx.data_ptr(), bm,
            tile_tap.data_ptr(), tile_nz.data_ptr(), tile_bk_nz.data_ptr(),
            n_kb, bk, run_start.data_ptr(), n_blocks, bo,
            epi_scale.data_ptr() if epilogue else None,
            epi_shift.data_ptr() if epilogue else None,
            epi_valid.data_ptr() if epilogue else None,
            out.data_ptr(), nz.data_ptr() if epilogue else None,
            int(epilogue), stream)
    if rc != 0:
        raise RuntimeError(f"spconv_gemm_fused launch failed: CUDA error {rc}")
    if n_blocks > 0:
        launches += 1
        epilogue_launches += int(epilogue)
    return (out, nz) if epilogue else out
