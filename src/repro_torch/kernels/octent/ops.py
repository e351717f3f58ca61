"""OCTENT engine: the stage-1 table build and the stage-2 query dispatch.

:func:`build_query_table` builds the sorted block directory and the
compacted banked table; :func:`build_kmap` runs the full search through the
CUDA query kernel (kernel.py) or, with ``impl="ref"``, its plain version.
Both give the same kmap bit for bit, and both match the host hash oracle
``core.mapsearch.build_kmap_hash``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import mapsearch, morton
from repro_torch.kernels.octent.kernel import LANE, octent_query
from repro_torch.kernels.octent.ref import octent_query_ref

#: stage-2 query rows submitted since the last reset: a full
#: :func:`build_kmap` adds its N voxel rows
QUERY_ROWS = [0]


class QueryTable(NamedTuple):
    """Sort-free OCTENT search structure.

    ``ublocks`` is the sorted block directory (INVALID padded); ``tkey`` /
    ``tval`` the compacted banked table: sorted flat addresses
    ``rank * 4096 + bank * 512 + row`` (LANE-padded with the out-of-range
    sentinel ``max_blocks * 4096``) and the voxel index per slot (-1 pad).
    ``n_blocks`` is the *true* occupied-block count, a one-element int32
    tensor; it may exceed ``max_blocks``, which is the caller's overflow
    signal.
    """

    ublocks: torch.Tensor   # (max_blocks,) int32
    n_blocks: torch.Tensor  # () int32
    tkey: torch.Tensor      # (n_pad,) int32, sorted
    tval: torch.Tensor      # (n_pad,) int32


def build_query_table(coords: torch.Tensor, batch: torch.Tensor,
                      valid: torch.Tensor, *, max_blocks: int,
                      grid_bits: int = 7, batch_bits: int = 4) -> QueryTable:
    """Stage 1: the octree directory and the compacted banked table.

    coords (N, 3), batch (N,) int32 and valid (N,) bool may hold padded
    rows; invalid rows never enter the directory or the table. The flat
    address space ``max_blocks * 4096`` must fit int32.
    """
    n = coords.shape[0]
    sentinel = max_blocks * morton.TABLE_SIZE
    if sentinel >= 2 ** 31:
        raise ValueError(f"max_blocks={max_blocks}: compacted table "
                         f"addresses overflow int32")
    bkey = torch.where(valid,
                       morton.block_key(coords, batch, grid_bits, batch_bits),
                       mapsearch.INVALID)
    ublocks, n_blocks, rank = mapsearch.sorted_unique(bkey, max_blocks)
    bank, row = morton.bank_and_row(morton.local_code(coords))
    tk = rank * morton.TABLE_SIZE + bank * morton.BANK_ROWS + row
    tk = torch.where(valid & (rank < max_blocks), tk, sentinel)
    tkey, order = torch.sort(tk, stable=True)
    tval = torch.where(tkey < sentinel, order.to(torch.int32), -1)
    pad = -(-n // LANE) * LANE - n
    if pad:
        tkey = torch.cat([tkey, tkey.new_full((pad,), sentinel)])
        tval = torch.cat([tval, tval.new_full((pad,), -1)])
    return QueryTable(ublocks, n_blocks.reshape(()), tkey.to(torch.int32),
                      tval.to(torch.int32))


def build_kmap(coords: torch.Tensor, batch: torch.Tensor,
               valid: torch.Tensor, *, max_blocks: int, grid_bits: int = 7,
               batch_bits: int = 4, impl: str | None = None,
               table: QueryTable | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Submanifold OCTENT map search: stage 1 + stage 2.

    impl: None or ``"kernel"`` runs the query through the kernel wrapper
    (the CUDA kernel on a card, its plain version on the CPU); ``"ref"``
    runs the plain version on any device. ``table`` is a prebuilt
    :class:`QueryTable` for this exact coordinate set, so only the query
    runs. The queries are the 27 Subm3 taps.

    Returns ``(kmap (N, K) int32 with -1 misses, n_blocks)``; n_blocks is
    the true occupied-block count for the caller's overflow check.
    """
    impl = impl or "kernel"
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown search impl {impl!r}")
    offsets = torch.as_tensor(morton.subm3_offsets(), device=coords.device)
    QUERY_ROWS[0] += coords.shape[0]
    qt = table if table is not None else build_query_table(
        coords, batch, valid, max_blocks=max_blocks, grid_bits=grid_bits,
        batch_bits=batch_bits)
    fn = octent_query if impl == "kernel" else octent_query_ref
    kmap = fn(coords.contiguous(), batch.contiguous(), valid.contiguous(),
              offsets, qt.ublocks, qt.tkey,
              qt.tval, qt.n_blocks, grid_bits=grid_bits,
              batch_bits=batch_bits)
    return kmap, qt.n_blocks
