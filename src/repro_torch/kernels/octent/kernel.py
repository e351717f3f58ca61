"""Wrapper of the CUDA OCTENT query kernel (csrc/octent_query.cu).

:func:`octent_query` checks its inputs, then launches the hand-written
kernel on a CUDA tensor, or runs the plain version (ref.py) on a CPU tensor.
There is no fallback: a CUDA input launches the kernel or raises.
``launches`` counts calls that launched it: each launches an index pass
over the table and the blocks, then the query kernel. ``row_launches``
counts those of them in row-list mode (``rows=``).
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
from repro_torch.kernels.octent.ref import octent_query_ref

#: lane width of the table arrays (tkey/tval are padded to this)
LANE = 128

#: number of times the CUDA kernel was launched
launches = 0
#: of those, launches in row-list mode
row_launches = 0
#: the launch counters above
COUNTERS = ("launches", "row_launches")

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    return build.launch_fn("octent_query", [_P, _P, _P, _I, _P, _I, _P, _I,
                                            _P, _P, _P, _I, _I, _P, _P, _I,
                                            _P, _P])


def _scratch():
    return build.launch_fn("octent_query", [_I, _I], "octent_query_scratch")


def octent_query(coords: torch.Tensor, batch: torch.Tensor,
                 valid: torch.Tensor, offsets: torch.Tensor,
                 ublocks: torch.Tensor, tkey: torch.Tensor,
                 tval: torch.Tensor, n_blocks: torch.Tensor, *,
                 grid_bits: int = 7, batch_bits: int = 4,
                 rows: torch.Tensor | None = None,
                 prev: torch.Tensor | None = None) -> torch.Tensor:
    """Resolve all K offset queries of N voxels. Returns kmap (N, K) int32.

    coords (N, 3) int32, batch (N,) int32, valid (N,) bool, offsets (K, 3)
    int32; ublocks (max_blocks,), tkey/tval (n_t,) int32 with n_t a LANE
    multiple, and n_blocks a one-element int32 tensor, as built by
    ops.build_query_table over these N rows. All on one device.

    Row-list mode: ``rows`` (Q,) int32, -1 padded, names rows to search,
    each at most once, and ``prev`` (N, K) int32 is the previous kmap. The
    result is a copy of ``prev`` in which each listed row holds its fresh
    search; a -1 entry is dropped. Q = 0 launches nothing.
    """
    global launches, row_launches
    n = coords.shape[0] if coords.dim() == 2 else -1
    _check("coords", coords, torch.int32, (None, 3))
    _check("batch", batch, torch.int32, (n,))
    _check("valid", valid, torch.bool, (n,))
    _check("offsets", offsets, torch.int32, (None, 3))
    _check("ublocks", ublocks, torch.int32, (None,))
    _check("tkey", tkey, torch.int32, (None,))
    _check("tval", tval, torch.int32, (tkey.shape[0],))
    k = offsets.shape[0]
    if (rows is None) != (prev is None):
        raise ValueError("rows= and prev= go together (row-list mode)")
    if rows is not None:
        _check("rows", rows, torch.int32, (None,))
        _check("prev", prev, torch.int32, (n, k))
    if n_blocks.dtype != torch.int32 or n_blocks.numel() != 1:
        raise TypeError("n_blocks must be a one-element int32 tensor")
    if tkey.shape[0] % LANE != 0 or ublocks.shape[0] < 1:
        raise ValueError("tkey must be LANE-padded and ublocks non-empty")
    if 3 * grid_bits + batch_bits > 31:
        raise ValueError("block key overflows int32")
    q = n if rows is None else rows.shape[0]
    if max(n, q) * k >= 2 ** 31:
        raise ValueError("the (N, K) kmap must have fewer than 2^31 entries")
    dev = coords.device
    for name, t in (("batch", batch), ("valid", valid), ("offsets", offsets),
                    ("ublocks", ublocks), ("tkey", tkey), ("tval", tval),
                    ("n_blocks", n_blocks), ("rows", rows), ("prev", prev)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, coords on {dev}")
    if dev.type == "cpu":
        return octent_query_ref(coords, batch, valid, offsets, ublocks, tkey,
                                tval, n_blocks, grid_bits=grid_bits,
                                batch_bits=batch_bits, rows=rows, prev=prev)
    if dev.type != "cuda":
        raise ValueError(f"octent_query runs on cuda or cpu, not {dev}")
    if rows is None:
        out = torch.empty((n, k), dtype=torch.int32, device=dev)
    else:
        out = prev.clone()
        if q == 0:
            return out
    fn = _lib()
    # the index the kernel's first pass writes: each block's segment of the
    # table, each table row's block and each block's 26 neighbours
    scratch = torch.empty(_scratch()(n, ublocks.shape[0]), dtype=torch.int32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(coords.data_ptr(), batch.data_ptr(), valid.data_ptr(), n,
            offsets.data_ptr(), k, ublocks.data_ptr(), ublocks.shape[0],
            n_blocks.data_ptr(), tkey.data_ptr(), tval.data_ptr(),
            tkey.shape[0], grid_bits, scratch.data_ptr(),
            None if rows is None else rows.data_ptr(), q, out.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"octent_query launch failed: CUDA error {rc}")
    if q * k > 0:
        launches += 1
        row_launches += rows is not None
    return out
