"""OCTENT engine: the stage-1 table build and the stage-2 query dispatch.

:func:`build_query_table` builds the sorted block directory and the
compacted banked table; :func:`build_kmap` runs the full search through the
CUDA query kernel (kernel.py) or, with ``impl="ref"``, its plain version.
Both give the same kmap bit for bit, and both match the host hash oracle
``core.mapsearch.build_kmap_hash``. ``impl="dense"`` is the search
baseline of a dense ``max_blocks * 4096`` table
(``core.mapsearch.build_kmap_octree``, the reference's ``impl="xla"``); it
runs only where a caller names it. ``build_kmap(update=)`` searches only
a streaming frame's dirty rows, against the frame's spliced table. The
query runs through ``runtime.guard.dispatch`` at the ``search`` fault
site; it falls back to the plain version only under
``REPRO_GUARD_FALLBACK=1`` and only on the CPU. ``impl="sharded"``
partitions the table over the active device mesh
(``kernels/octent/sharded.py``); :func:`search_impl` picks it by itself
when the mesh splits the block-key axes more than one way. Its merges are
collectives, so it runs once, outside the guard's retry, quarantine and
fallback, which decide one rank at a time.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import mapsearch, morton
from repro_torch.kernels.octent.kernel import LANE, octent_query
from repro_torch.kernels.octent.ref import octent_query_ref
from repro_torch.runtime import fault as _fault
from repro_torch.runtime import guard as _guard
from repro_torch.runtime import sharding

def search_impl() -> str:
    """The search engine of a call that names none: ``sharded`` when the
    active mesh splits the block-key axes (data/model) more than one way,
    so a model picks up the sharded engine by running under the mesh,
    else ``kernel``. It depends on the active mesh, so resolve it outside
    cache keys (``core/plan.py`` does)."""
    return "sharded" if sharding.blockkey_shards() > 1 else "kernel"


#: stage-2 query rows submitted since the last reset: a full
#: :func:`build_kmap` adds its N voxel rows, an ``update=`` call its Q
#: listed rows (padding included), as the reference counts them
QUERY_ROWS = [0]


class KmapUpdate(NamedTuple):
    """Re-search request of :func:`build_kmap`: ``kmap`` is the previous
    (N, K) kmap over the same canonical rows, ``rows`` the -1-padded (Q,)
    int32 rows to search again (``core.stream`` lists the rows whose
    neighbourhood touches a changed block). Every other row is kept bit
    for bit."""

    kmap: torch.Tensor   # (N, K) int32
    rows: torch.Tensor   # (Q,) int32, -1 padded


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
               table: QueryTable | None = None,
               update: KmapUpdate | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Submanifold OCTENT map search: stage 1 + stage 2.

    impl: None resolves through :func:`search_impl`. ``"kernel"`` runs
    the query through the kernel wrapper (the CUDA kernel on a card, its
    plain version on the CPU); ``"ref"`` runs the plain version on any
    device; ``"dense"`` builds and queries a dense table
    (:func:`~repro_torch.core.mapsearch.build_block_table`) on any
    device, and takes no ``table``; ``"sharded"`` partitions the table
    over the active mesh (every rank of it calls with the same
    coordinates), takes no ``table``, raises ValueError when no mesh with
    a data/model axis is active, and is never retried or served by a
    fallback: a ``search`` fault on any rank raises on every rank. ``table`` is
    a prebuilt :class:`QueryTable` for this exact coordinate set, so only
    the query runs. The queries are the 27 Subm3 taps.

    ``update`` (a :class:`KmapUpdate`, which needs ``table``: the table of
    the new frame, never built here) searches only ``update.rows``, in the
    kernel's row-list mode, into a copy of ``update.kmap``. A listed row
    that is not valid (an evicted slot) comes back all -1, as from a
    build from scratch.

    Returns ``(kmap (N, K) int32 with -1 misses, n_blocks)``; n_blocks is
    the true occupied-block count for the caller's overflow check.
    """
    impl = impl or search_impl()
    if impl not in ("kernel", "ref", "dense", "sharded"):
        raise ValueError(f"unknown search impl {impl!r}")
    if impl in ("dense", "sharded") and table is not None:
        raise ValueError(f"impl={impl!r} builds its own search structure; "
                         f"a prebuilt QueryTable serves 'kernel' and 'ref' "
                         f"only")
    if update is not None and table is None:
        raise ValueError(
            "update= re-searches dirty rows against a delta-updated "
            "QueryTable and never builds one itself: pass the table= the "
            "stream spliced for this frame (core/stream.py does)")
    offsets = torch.as_tensor(morton.subm3_offsets(), device=coords.device)
    QUERY_ROWS[0] += (update.rows.shape[0] if update is not None
                      else coords.shape[0])
    if impl == "sharded":
        # collectives: one call on every rank of the group, which fail
        # together (guard.dispatch retries and falls back per rank)
        from repro_torch.kernels.octent import sharded
        sharded.require_blockkey_mesh()
        sharded.check_fault_agreed("search", coords.device)
        return sharded.build_kmap_sharded(
            coords, batch, valid, max_blocks=max_blocks, grid_bits=grid_bits,
            batch_bits=batch_bits, offsets=offsets)

    def _run(one: str):
        _fault.check("search")
        if one == "dense":
            bt = mapsearch.build_block_table(
                coords, batch, valid, max_blocks=max_blocks,
                grid_bits=grid_bits, batch_bits=batch_bits)
            kmap = mapsearch.query_block_table(
                bt, *mapsearch.offset_queries(coords, batch, valid, offsets),
                grid_bits=grid_bits, batch_bits=batch_bits)
            return kmap, bt.n_blocks
        # a prebuilt table serves any impl: it depends on geometry only
        qt = table if table is not None else build_query_table(
            coords, batch, valid, max_blocks=max_blocks, grid_bits=grid_bits,
            batch_bits=batch_bits)
        fn = octent_query if one == "kernel" else octent_query_ref
        kmap = fn(coords.contiguous(), batch.contiguous(), valid.contiguous(),
                  offsets, qt.ublocks, qt.tkey,
                  qt.tval, qt.n_blocks, grid_bits=grid_bits,
                  batch_bits=batch_bits,
                  rows=None if update is None else update.rows,
                  prev=None if update is None else update.kmap)
        return kmap, qt.n_blocks

    return _guard.dispatch(
        "search", impl, _guard.fallback_chain("search", impl, coords.device),
        _run,
        key=(coords.shape[0], offsets.shape[0], max_blocks, grid_bits,
             batch_bits, update.rows.shape[0] if update is not None
             else None))
