"""Sharded OCTENT map search: the QueryTable over a device mesh.

The single-device engine (``ops.build_kmap``, kernel 1) keeps the whole
sorted block directory (``ublocks``) and the compacted banked table
(``tkey``/``tval``) on one card. Here both are partitioned by **contiguous
block-key range** over the mesh's data/model axes
(``runtime.sharding.blockkey_axes``), one range a rank of a
``torch.distributed`` process group:

* directory: ``ublocks`` is sorted by block Morton key, so S equal
  position-slices of it are S contiguous key ranges. Shard s owns the
  global block ranks [s*B, (s+1)*B); ``bounds[s]``, the first key of slice
  s, is the boundary list, and ownership of a key is one lower-bound
  against it (:func:`owner_shard`).
* table: ``tkey`` is sorted by the flat address ``rank * 4096 + bank * 512
  + row`` (block-rank-major), so its S equal position-slices are
  contiguous address ranges (``tbounds``). A rank keeps only its
  ``n_pad/S`` slots and ``mb/S`` directory entries; the full table it
  built is freed before the query runs.

Every rank answers every query (the 27 taps of each voxel, encoded as the
single-device search encodes them) from its own slices and gives -1
elsewhere; keys are unique across slices, so at most one rank hits. Two
``all_reduce(MAX)`` merges run per search: one publishes the owning rank's
global block rank (stage 1 -> stage 2: the rank owning a block key is in
general not the one owning the derived table address), one merges the
kmap. An integer maximum is associative, so the kmap is bit-equal to the
single-device search on every mesh shape. (That rests on the COO contract
of every engine here: no two valid voxels share (batch, coords).)

The body is plain ``torch`` (``searchsorted``, ``where``) on each rank's
device, as the reference's is plain ``jnp`` under ``shard_map``: no kernel
of its own. The merges take the rank's tensors as they are, over NCCL or
over gloo (which takes CUDA tensors too).

A search is collective, so it fails on every rank or on none: the
``search`` fault site is decided by the whole group
(:func:`check_fault_agreed`) before the first merge, and ``ops.build_kmap``
calls this engine once, outside the guard's per-rank retry and fallback.

The stage-1 build (``ops.build_query_table``) is replicated: each rank
builds the whole table from the whole coordinate stream, pads it and keeps
its slice, so ``n_blocks`` is the same on every rank and the overflow
check needs no collective.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import mapsearch, morton
from repro_torch.kernels.octent.kernel import LANE
from repro_torch.kernels.octent.ops import build_query_table
from repro_torch.kernels.octent.ref import encode_queries
from repro_torch.runtime import fault as _fault
from repro_torch.runtime import sharding


class ShardedQueryTable(NamedTuple):
    """This rank's slice of a QueryTable laid out as S key ranges.

    ``ublocks`` (B,) and ``tkey``/``tval`` (L,) are slice ``shard`` of the
    single-device table padded to S*B directory entries and S*L slots
    (INVALID / the address sentinel / -1, which never match a query).
    ``bounds`` (S+1,) are the directory's boundary keys (shard s owns
    block keys in [bounds[s], bounds[s+1])) and ``tbounds`` the same for
    the table's addresses (a block's voxels can straddle two slices;
    lookups are exact, so only the boundary owner answers).
    """

    ublocks: torch.Tensor   # (B,) int32, this rank's directory slice
    n_blocks: torch.Tensor  # () int32, true occupied-block count
    tkey: torch.Tensor      # (L,) int32, this rank's table addresses
    tval: torch.Tensor      # (L,) int32, voxel index per slot (-1 pad)
    bounds: torch.Tensor    # (S+1,) int32 directory boundary keys
    tbounds: torch.Tensor   # (S+1,) int32 table boundary addresses
    n_shards: int           # S
    shard: int              # this rank's key range s
    axes: tuple             # mesh axes the key range partitions over


class ShardGroup(NamedTuple):
    """The process group of the ranks that share one octree table: those
    with this rank's coordinates on every mesh axis outside the key range.
    ``ranks`` lists their global ranks in shard order."""

    group: object           # torch.distributed ProcessGroup
    ranks: tuple            # global rank of shard 0, 1, ..., S-1
    shard: int              # this rank's index in ``ranks``


_GROUPS: dict = {}


def _resolve_mesh(mesh, axes):
    mesh = mesh if mesh is not None else sharding.get_mesh()
    if mesh is None:
        raise ValueError(
            "sharded OCTENT search needs an active device mesh — enter one "
            "with runtime.sharding.set_mesh (or pass mesh=), or use a "
            "single-device impl ('kernel'/'ref'/'dense')")
    axes = tuple(axes) if axes is not None else sharding.blockkey_axes(mesh)
    if not axes:
        raise ValueError(
            f"mesh axes {tuple(mesh.mesh_dim_names)} contain none of the "
            f"block-key shard axes {sharding.SHARD_AXES}; the octree table "
            f"has nothing to partition over")
    return mesh, axes


def shard_group(mesh, axes) -> ShardGroup:
    """The :class:`ShardGroup` of this process under ``mesh``.

    One mesh dimension uses the mesh's own group of that dimension. Over
    several (``(data, model)``, ``(pod, data, model)``) the ranks that
    share the coordinates outside ``axes`` form a group of their own,
    created once a process by its members only."""
    names = tuple(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axes]
    rest = [d for d in range(len(names)) if d not in dims]
    grid = mesh.mesh.permute(rest + dims).reshape(
        -1, math.prod(mesh.size(d) for d in dims))
    me = dist.get_rank()
    row = next((tuple(r) for r in grid.tolist() if me in r), None)
    if row is None:
        raise ValueError(f"rank {me} is not a rank of the mesh "
                         f"{grid.flatten().tolist()}")
    if len(dims) == 1:
        group = mesh.get_group(axes[0])
    else:
        key = (row, id(dist.group.WORLD))
        group = _GROUPS.get(key)
        if group is None:
            group = _GROUPS[key] = dist.new_group(
                list(row), use_local_synchronization=True)
    return ShardGroup(group, row, row.index(me))


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise maximum of ``t`` over ``group``, in place; returns
    ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def check_fault_agreed(site: str, device, mesh=None,
                       axes: tuple | None = None) -> None:
    """The fault site ``site`` of one sharded search, decided by every
    rank of the table's group together: when the active fault plan fires
    on any rank, every rank raises (the firing one its
    ``InjectedFault``), so none waits in a merge the others never join
    and none serves a kmap the others did not. One int32 ``all_reduce``
    of a single element."""
    mesh, axes = _resolve_mesh(mesh, axes)
    grp = shard_group(mesh, axes)
    err = None
    try:
        _fault.check(site)
    except _fault.InjectedFault as e:
        err = e
    flag = torch.tensor([int(err is not None)], dtype=torch.int32,
                        device=device)
    all_reduce_max(flag, grp.group)
    if err is not None:
        raise err
    if int(flag.item()):
        raise RuntimeError(
            f"{site}: a fault on another rank of shard group {grp.ranks} "
            f"fails this sharded search on every rank")


def _gather_shards(t: torch.Tensor, grp: ShardGroup) -> torch.Tensor:
    """(S, *t.shape): every rank's ``t``, in shard order."""
    parts = [torch.empty_like(t) for _ in grp.ranks]
    dist.all_gather(parts, t, group=grp.group)
    order = dist.get_process_group_ranks(grp.group)
    return torch.stack([parts[order.index(r)] for r in grp.ranks])


def _pad(x: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    return torch.cat([x, x.new_full((size - x.shape[0],), fill)])


def build_query_table_sharded(coords: torch.Tensor, batch: torch.Tensor,
                              valid: torch.Tensor, *, max_blocks: int,
                              grid_bits: int = 7, batch_bits: int = 4,
                              mesh=None, axes: tuple | None = None
                              ) -> ShardedQueryTable:
    """Stage 1 for the mesh: the replicated build, then this rank's slice.

    The directory pads to ``mb = ceil(max_blocks/S)*S`` entries and the
    table to ``n_pad = ceil(len(tkey)/(S*LANE))*S*LANE`` slots, exactly
    as the reference pads them; the rank keeps slice ``s`` of each (a
    copy: the padded full arrays are released on return).

    Args:
      coords, batch, valid: the padded coordinate stream, as
        ``ops.build_query_table`` takes it, on this rank's device.
      max_blocks, grid_bits, batch_bits: forwarded to that build.
      mesh: the device mesh (default: the active one; required).
      axes: mesh axes the key range partitions over (default: every
        data/model axis of the mesh).
    """
    mesh, axes = _resolve_mesh(mesh, axes)
    grp = shard_group(mesh, axes)
    s_n, s = len(grp.ranks), grp.shard
    qt = build_query_table(coords, batch, valid, max_blocks=max_blocks,
                           grid_bits=grid_bits, batch_bits=batch_bits)
    sentinel = max_blocks * morton.TABLE_SIZE
    mb = -(-max_blocks // s_n) * s_n
    n_pad = -(-qt.tkey.shape[0] // (s_n * LANE)) * (s_n * LANE)
    ublocks = _pad(qt.ublocks, mb, mapsearch.INVALID)
    tkey = _pad(qt.tkey, n_pad, sentinel)
    tval = _pad(qt.tval, n_pad, -1)
    b, n_t = mb // s_n, n_pad // s_n
    bounds = _pad(ublocks[::b], s_n + 1, mapsearch.INVALID)
    tbounds = _pad(tkey[::n_t], s_n + 1, sentinel)
    return ShardedQueryTable(
        ublocks=ublocks[s * b:(s + 1) * b].clone(), n_blocks=qt.n_blocks,
        tkey=tkey[s * n_t:(s + 1) * n_t].clone(),
        tval=tval[s * n_t:(s + 1) * n_t].clone(), bounds=bounds,
        tbounds=tbounds, n_shards=s_n, shard=s, axes=axes)


def owner_shard(bounds: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Which key range owns each key: one lower-bound against the shard
    boundaries (the Query Transmitter's routing function)."""
    return torch.searchsorted(bounds[1:].contiguous(), key.contiguous(),
                              right=True, out_int32=True)


def _partial_query(sqt: ShardedQueryTable, grp: ShardGroup, coords, batch,
                   valid, offsets, *, grid_bits: int):
    """Answer every query from this rank's slices, merging each stage.

    Returns (kmap (N, K), this rank's stage-1 ranks, its stage-2 partial),
    the last two -1 where it does not answer. Stage for stage the
    single-device plain search (``ref.octent_query_ref``), except that both
    lower-bounds walk the local slices: an exact match against a slice
    entry is the ownership test (bounds[s] <= key < bounds[s+1] iff the
    key sorts into slice s), and table entries are global addresses.
    """
    inb, bkey, bank, row = encode_queries(coords, batch, valid, offsets,
                                          grid_bits=grid_bits)
    ub = sqt.ublocks
    b = ub.shape[0]
    r = torch.searchsorted(ub, bkey.contiguous(), out_int32=True)
    rc = r.clamp(max=b - 1)
    hit_dir = (r < b) & (ub[rc.long()] == bkey)
    pranks = torch.where(hit_dir, sqt.shard * b + rc, -1)
    rank = all_reduce_max(pranks.clone(), grp.group)
    hit_b = rank >= 0
    key2 = torch.where(
        hit_b, rank * morton.TABLE_SIZE + bank * morton.BANK_ROWS + row, -1)
    n_t = sqt.tkey.shape[0]
    pos = torch.searchsorted(sqt.tkey, key2.contiguous(),
                             out_int32=True).clamp(max=n_t - 1).long()
    hit = hit_b & inb & (sqt.tkey[pos] == key2)
    partial = torch.where(hit, sqt.tval[pos], -1).to(torch.int32)
    kmap = all_reduce_max(partial.clone(), grp.group)
    return kmap, pranks, partial


def octent_query_sharded(coords: torch.Tensor, batch: torch.Tensor,
                         valid: torch.Tensor, offsets: torch.Tensor,
                         sqt: ShardedQueryTable, *, grid_bits: int = 7,
                         batch_bits: int = 4, mesh=None,
                         return_partials: bool = False):
    """Resolve all K offset queries per voxel over the mesh.

    Returns (kmap (N, K) int32, n_blocks ()), the same on every rank of
    the table's group. ``return_partials`` also returns the (S, N, K)
    pre-merge answers of every rank in shard order (stage-1 directory
    ranks, stage-2 table lookups) for routing checks: stage 1 must be
    answered by the ``bounds`` owner, stage 2 by the ``tbounds`` owner.
    """
    del batch_bits   # part of the key contract; the query needs no bound
    mesh, axes = _resolve_mesh(mesh, sqt.axes)
    grp = shard_group(mesh, axes)
    if (len(grp.ranks), grp.shard) != (sqt.n_shards, sqt.shard):
        raise ValueError(
            f"the table holds shard {sqt.shard} of {sqt.n_shards}, but this "
            f"rank is shard {grp.shard} of {len(grp.ranks)} under the mesh")
    kmap, pranks, partial = _partial_query(
        sqt, grp, coords, batch.to(torch.int32), valid,
        offsets.to(torch.int32), grid_bits=grid_bits)
    nb = sqt.n_blocks.to(torch.int32)
    if return_partials:
        return (kmap, nb, _gather_shards(pranks, grp),
                _gather_shards(partial, grp))
    return kmap, nb


def require_blockkey_mesh(mesh=None, axes: tuple | None = None):
    """Raise the configuration ValueError unless a usable mesh exists.
    ``ops.build_kmap`` calls it before any work: a missing or axis-less
    mesh is the caller's error."""
    return _resolve_mesh(mesh, axes)


def build_kmap_sharded(coords: torch.Tensor, batch: torch.Tensor,
                       valid: torch.Tensor, *, max_blocks: int,
                       grid_bits: int = 7, batch_bits: int = 4,
                       offsets: torch.Tensor | None = None, mesh=None,
                       axes: tuple | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Submanifold OCTENT map search over the mesh.

    The contract of ``ops.build_kmap``, bit for bit: returns (kmap (N, K)
    int32 with -1 misses, n_blocks), n_blocks the same on every rank for
    the caller's overflow check. Every rank of the table's group must
    call it with the same coordinates.
    """
    mesh, axes = _resolve_mesh(mesh, axes)
    if offsets is None:
        offsets = torch.as_tensor(morton.subm3_offsets(),
                                  device=coords.device)
    sqt = build_query_table_sharded(coords, batch, valid,
                                    max_blocks=max_blocks,
                                    grid_bits=grid_bits,
                                    batch_bits=batch_bits, mesh=mesh,
                                    axes=axes)
    return octent_query_sharded(coords, batch, valid, offsets, sqt,
                                grid_bits=grid_bits, batch_bits=batch_bits,
                                mesh=mesh)
