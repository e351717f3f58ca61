"""Wrappers of the two CUDA gather-GEMM kernels.

* :func:`spconv_gemm_fused` — the output-stationary gather-GEMM
  (csrc/spconv_gemm_fused.cu), the execution backend of every layer.
* :func:`spconv_gemm` — the materialized tiled GEMM over a pre-gathered
  lhs (csrc/spconv_gemm.cu), the baseline behind ``ops.apply_kmap``.

Each checks its inputs, then launches its hand-written kernel on CUDA
tensors, or runs its plain version (ref.py) on CPU tensors. There is no
fallback: a CUDA input launches the kernel or raises. ``launches`` counts
launches of the fused kernel in both modes, ``epilogue_launches`` those
with the fused BN/ReLU epilogue, ``plan_launches`` those of the planning
kernel that precedes each of them, ``reduce_launches`` those of the
split-sum kernel that follows a fused launch whose grid has spare CTAs,
``materialized_launches`` those of the materialized kernel.
A CUDA graph launches the kernels it captured at each replay, and
``runtime/graph.py`` adds them to these counters then: they count what
the card ran, replays included, and a capture, which runs nothing,
leaves them as they were. :data:`COUNTERS` names them.

The fused kernel's work plan (:func:`plan_shape` for the static grid,
:func:`split_plan` / :func:`split_plan_ref` for which blocks and tiles each
CTA takes) is computed on the device, with no host synchronisation.
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
#: number of times the split-sum kernel ran after a fused launch
reduce_launches = 0
#: number of times the planning kernel ran (once per fused launch)
plan_launches = 0
#: the launch counters above
COUNTERS = ("launches", "epilogue_launches", "materialized_launches",
            "reduce_launches", "plan_launches")

#: most CTAs that share one output block's run on the card (1: blocks are
#: never split); splitting changes the output only by float32 rounding
MAX_SPLITS = 8
#: largest tap count and Cin step count the fused kernel's work list encodes
MAX_TAPS = MAX_CIN_STEPS = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    return build.launch_fn("spconv_gemm_fused",
                           [_P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _I, _I,
                            _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I,
                            _P])


_SM_COUNT: dict = {}


def sm_count(dev: torch.device) -> int:
    """Streaming multiprocessors of CUDA device ``dev`` (cached)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def plan_shape(n_blocks: int, n_slabs: int, n_sms: int,
               max_splits: int) -> tuple[int, int]:
    """The static side of the fused kernel's work plan: ``(n_ctas,
    busy_min)``, the CTAs launched per 128-column slab and the number of
    live output blocks below which the plan splits blocks.

    Every block keeps one CTA; with ``max_splits`` > 1 the grid adds two
    CTAs per SM (spread over the slabs) for the plan to give to the live
    blocks. Splitting pays only when the live blocks alone leave SMs idle:
    below 7/8 of a wave of (block, slab) CTAs. Shapes only: no device
    value is read.
    """
    if max_splits <= 1 or n_blocks <= 0:
        return max(n_blocks, 0), 0
    n_slabs = max(n_slabs, 1)
    return (n_blocks + -(-2 * n_sms // n_slabs),
            -(-7 * n_sms // (8 * n_slabs)))


def split_plan_ref(tile_ob: torch.Tensor, tile_nz: torch.Tensor, *,
                   n_blocks: int, n_ctas: int, max_splits: int,
                   busy_min: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused kernel's planning kernel: which output
    block each of ``n_ctas`` CTAs serves and which tiles it walks.

    tile_ob (T,) int32 monotone, tile_nz (T,) int32. Returns ``work``
    (n_ctas, 4) int32 rows ``(block, first tile, end tile, CTAs of the
    block)``, block -1 for a CTA left over, and ``blk`` (n_blocks, 2) int32
    rows ``(first CTA, CTAs)``. Every block gets at least one CTA; when
    fewer than ``busy_min`` blocks hold a live tile and ``n_ctas`` leaves
    spare CTAs, block b gets ``min(max_splits, max(1, ceil(nlive_b / q)))``
    with ``q = ceil(L / spare)`` (L: all live tiles), which never exceeds
    the grid. CTA j of the n of block b walks the block's live tiles of rank
    ``[nlive * j // n, nlive * (j + 1) // n)``, as the tile range from the
    first of them to just past the last (empty when it has none), so the
    ranges of a block cover each of its live tiles exactly once, in order.
    """
    dev = tile_nz.device
    n_tiles = tile_nz.shape[0]
    i64 = torch.int64
    csum = torch.zeros(n_tiles + 1, dtype=i64, device=dev)
    csum[1:] = torch.cumsum(tile_nz != 0, 0)
    run = torch.searchsorted(tile_ob.to(i64),
                             torch.arange(n_blocks + 1, dtype=i64,
                                          device=dev))
    lb = csum[run]
    nlive = lb[1:] - lb[:-1]
    spare = n_ctas - n_blocks
    if spare > 0 and int((nlive > 0).sum()) < busy_min:
        q = max(1, -(-int(csum[-1]) // spare))
        n = ((nlive + q - 1) // q).clamp(1, max_splits)
    else:
        n = torch.ones(n_blocks, dtype=i64, device=dev)
    end = torch.cumsum(n, 0)
    c = torch.arange(n_ctas, dtype=i64, device=dev)
    b = torch.searchsorted(end, c, right=True)
    bc = b.clamp(max=max(n_blocks - 1, 0))
    nb, j = n[bc], c - (end[bc] - n[bc])
    r0 = lb[bc] + nlive[bc] * j // nb
    r1 = lb[bc] + nlive[bc] * (j + 1) // nb
    t0 = torch.searchsorted(csum[1:], r0, right=True)
    t1 = torch.where(r1 > r0,
                     torch.searchsorted(csum[1:], r1 - 1, right=True) + 1,
                     t0)
    spare_cta = b >= n_blocks
    work = torch.stack([torch.where(spare_cta, -1, b),
                        torch.where(spare_cta, 0, t0),
                        torch.where(spare_cta, 0, t1),
                        torch.where(spare_cta, 0, nb)], 1)
    blk = torch.stack([end - n, n], 1)
    return work.to(torch.int32), blk.to(torch.int32)


def split_plan(tile_ob: torch.Tensor, tile_nz: torch.Tensor, *,
               n_blocks: int, n_ctas: int, max_splits: int,
               busy_min: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel's work plan (see :func:`split_plan_ref`): the
    one-CTA planning kernel on CUDA tensors, the plain version on CPU
    tensors. Enqueues work only: no host synchronisation."""
    global plan_launches
    n_tiles = tile_nz.shape[0]
    _check("tile_ob", tile_ob, torch.int32, (n_tiles,))
    _check("tile_nz", tile_nz, torch.int32, (n_tiles,))
    kw = dict(n_blocks=n_blocks, n_ctas=n_ctas, max_splits=max_splits,
              busy_min=busy_min)
    dev = tile_nz.device
    if tile_ob.device != dev:
        raise ValueError("tile_ob and tile_nz must share a device")
    if dev.type == "cpu":
        return split_plan_ref(tile_ob, tile_nz, **kw)
    if dev.type != "cuda":
        raise ValueError(f"split_plan runs on cuda or cpu, not {dev}")
    if n_ctas < n_blocks:
        raise ValueError(f"n_ctas={n_ctas} < n_blocks={n_blocks}")
    buf = torch.empty(4 * n_ctas + 2 * n_blocks + 2 * n_blocks + n_tiles + 2,
                      dtype=torch.int32, device=dev)
    work = buf[:4 * n_ctas].view(n_ctas, 4)
    blk = buf[4 * n_ctas:4 * n_ctas + 2 * n_blocks].view(n_blocks, 2)
    scratch = buf[4 * n_ctas + 2 * n_blocks:]
    fn = build.launch_fn("spconv_gemm_fused",
                         [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
                         entry="spconv_split_plan_launch")
    rc = fn(tile_ob.data_ptr(), tile_nz.data_ptr(), n_tiles, n_blocks,
            n_ctas, max_splits, busy_min, scratch.data_ptr(),
            work.data_ptr(), blk.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"split_plan launch failed: CUDA error {rc}")
    if n_blocks > 0 and n_ctas > 0:
        plan_launches += 1
    return work, blk


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
    global launches, epilogue_launches, reduce_launches
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

    if weights.shape[0] > MAX_TAPS or -(-c_in // KC) > MAX_CIN_STEPS:
        raise ValueError(f"the kernel takes at most {MAX_TAPS} taps and "
                         f"Cin <= {KC * MAX_CIN_STEPS}, got "
                         f"{tuple(weights.shape[:2])}")
    if weights.data_ptr() % 16 != 0:
        raise ValueError("weights must be 16-byte aligned")

    n_blocks, n_slabs = n_out_pad // bo, c_out_pad // BN
    n_ctas, busy_min = plan_shape(n_blocks, n_slabs, sm_count(dev),
                                  MAX_SPLITS)
    work, blk = split_plan(tile_ob, tile_nz, n_blocks=n_blocks,
                           n_ctas=n_ctas, max_splits=MAX_SPLITS,
                           busy_min=busy_min)
    out = torch.empty((n_out_pad, c_out_pad), dtype=torch.float32, device=dev)
    ws = (torch.empty((n_ctas, bo, c_out_pad), dtype=torch.float32,
                      device=dev) if n_ctas > n_blocks else None)
    nz = (torch.empty((n_out_pad, c_out_pad // BN), dtype=torch.int32,
                      device=dev) if epilogue else None)
    fn = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(feats.data_ptr(), c_in, weights.data_ptr(), c_out_pad,
            gather_idx.data_ptr(), scatter_idx.data_ptr(), bm,
            tile_tap.data_ptr(), tile_nz.data_ptr(), tile_bk_nz.data_ptr(),
            n_kb, bk, work.data_ptr(), blk.data_ptr(), n_ctas, n_blocks, bo,
            epi_scale.data_ptr() if epilogue else None,
            epi_shift.data_ptr() if epilogue else None,
            epi_valid.data_ptr() if epilogue else None,
            out.data_ptr(), ws.data_ptr() if ws is not None else None,
            nz.data_ptr() if epilogue else None, int(epilogue), stream)
    if rc != 0:
        raise RuntimeError(f"spconv_gemm_fused launch failed: CUDA error {rc}")
    if n_blocks > 0:
        launches += 1
        epilogue_launches += int(epilogue)
        reduce_launches += int(ws is not None)
    return (out, nz) if epilogue else out
