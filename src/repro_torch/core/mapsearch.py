"""Map search building blocks: unique passes, strided maps, the baselines.

Counterpart of ``repro.core.mapsearch``. The reference orders its bounded
keys with sort-free counting passes; a stable ``torch.sort`` of the same
keys gives the same permutation, so that is what runs here. Every output
is int32 and bit-identical to the reference.

The paper's search baselines live here beside kernel 1
(``kernels/octent``): :func:`build_kmap_bruteforce` (the O(N^2) traverse
of Fig. 3(a)) and :func:`build_kmap_hash` (serial host hashing, the
GPU-engine baseline), both numpy; :func:`build_kmap_octree`, OCTENT over
a dense ``max_blocks * 4096`` table in torch ops on the inputs' device;
and :func:`build_kmap_sorted`, binary search over the sorted composite
keys, with no table at all. On duplicate coordinates the dense table and
the hash keep the last row, the sorted search and kernel 1 the first.

Map representation (gather form, output stationary):
    kmap : (N_out, K) int32 — input row feeding output i through tap k
           (-1 = no contribution)
plus, for the strided layers (Gconv2, Gconv3, Tconv2), the scatter-form
triples of :class:`StridedMaps`; :func:`strided_to_kmap` converts between
the two, which switches a layer from the input-stationary dataflow to the
output-stationary one.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import morton

INVALID = torch.iinfo(torch.int32).max

_I32 = torch.int32


def set_drop(base: torch.Tensor, idx: torch.Tensor, src) -> torch.Tensor:
    """``base.at[idx].set(src, mode='drop')`` for ``idx >= 0``: a copy of
    ``base`` with one more row, which every index past the end writes and
    which is sliced off. Where the kept indices are unique, the scatter is
    deterministic on the card too."""
    n = base.shape[0]
    out = torch.cat([base, base.new_zeros((1,) + base.shape[1:])])
    out[idx.clamp(max=n).long()] = src
    return out[:n]


def _scatter_drop(size: int, idx: torch.Tensor, src, fill, dtype):
    """``full(size, fill).at[idx].set(src, mode='drop')``."""
    return set_drop(torch.full((size,), fill, dtype=dtype,
                               device=idx.device), idx, src)


def sorted_unique(codes: torch.Tensor, size: int):
    """Sorted unique of int32 keys with a static output ``size``.

    Invalid inputs must be INVALID. Returns (uniq padded with INVALID,
    count, rank of each input by lower bound in uniq).
    """
    order = torch.sort(codes, stable=True).indices
    s = codes[order]
    is_new = torch.ones_like(s, dtype=torch.bool)
    is_new[1:] = s[1:] != s[:-1]
    is_new &= s != INVALID
    pos = torch.cumsum(is_new, 0, dtype=_I32) - 1
    tgt = torch.where(is_new & (pos < size), pos, size)
    uniq = _scatter_drop(size, tgt, s, INVALID, _I32)
    count = is_new.sum(dtype=_I32)
    rank = torch.searchsorted(uniq, codes, out_int32=True)
    return uniq, count, rank


def unique_pairs(hi: torch.Tensor, lo: torch.Tensor, valid: torch.Tensor,
                 size: int):
    """Unique over lexicographic (hi, lo) int32 pair keys.

    Returns (rep, count, rank): ``rep[r]`` is the original index of the
    representative of unique key r (-1 padding); ``rank[i]`` the unique id
    of input i (``size`` for invalid inputs). The order is the stable
    lexicographic one, invalid entries last in their original order.
    """
    n = hi.shape[0]
    hi = torch.where(valid, hi, INVALID)
    lo = torch.where(valid, lo, INVALID)
    # one stable sort on a composite int64 key: hi major, lo minor
    order = torch.sort((hi.long() << 32) | lo.long(), stable=True).indices
    shi, slo, sval = hi[order], lo[order], valid[order]
    is_new = torch.ones_like(sval)
    is_new[1:] = (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])
    is_new &= sval
    pos = torch.cumsum(is_new, 0, dtype=_I32) - 1
    count = is_new.sum(dtype=_I32)
    rank_sorted = torch.where(sval, pos, size).to(_I32)
    rank = torch.zeros(n, dtype=_I32, device=hi.device)
    rank[order] = rank_sorted
    tgt = torch.where(is_new & (pos < size), pos, size)
    rep = _scatter_drop(size, tgt, order.to(_I32), -1, _I32)
    return rep, count, rank


def build_kmap_hash(coords: np.ndarray, batch: np.ndarray,
                    valid: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Serial hash probing on the host — the GPU-engine baseline and the
    oracle every search engine is checked against."""
    table = {}
    for j in range(coords.shape[0]):
        if valid[j]:
            table[(int(batch[j]),) + tuple(int(c) for c in coords[j])] = j
    n, k = coords.shape[0], offsets.shape[0]
    kmap = np.full((n, k), -1, dtype=np.int32)
    for i in range(n):
        if not valid[i]:
            continue
        for t in range(k):
            key = (int(batch[i]),) + tuple(int(c)
                                           for c in coords[i] + offsets[t])
            kmap[i, t] = table.get(key, -1)
    return kmap


def build_kmap_bruteforce(coords: np.ndarray, batch: np.ndarray,
                          valid: np.ndarray,
                          offsets: np.ndarray) -> np.ndarray:
    """O(N^2 K) traverse (Fig. 3(a)); outputs == inputs. The first valid
    row at the target wins."""
    n, k = coords.shape[0], offsets.shape[0]
    kmap = np.full((n, k), -1, dtype=np.int32)
    for i in range(n):
        if not valid[i]:
            continue
        for t in range(k):
            target = coords[i] + offsets[t]
            for j in range(n):
                if valid[j] and batch[j] == batch[i] \
                        and np.all(coords[j] == target):
                    kmap[i, t] = j
                    break
    return kmap


class BlockTable(NamedTuple):
    """Stage 1 of OCTENT over a dense table (Fig. 5(c) lines 1-6).

    ``banks`` is the (max_blocks * 4096) flattened table: block rank, then
    bank (phi_1), then row; -1 is empty. ``ublocks`` is the sorted,
    INVALID-padded directory of occupied block keys. ``n_blocks`` is the
    true occupied-block count, which may exceed ``max_blocks``: the
    caller's overflow signal.
    """

    banks: torch.Tensor     # (max_blocks * TABLE_SIZE,) int32
    ublocks: torch.Tensor   # (max_blocks,) int32, sorted, INVALID padded
    n_blocks: torch.Tensor  # () int32


def build_block_table(coords: torch.Tensor, batch: torch.Tensor,
                      valid: torch.Tensor, *, max_blocks: int,
                      grid_bits: int = 7, batch_bits: int = 4) -> BlockTable:
    """The dense octree table of a cloud. Where several valid rows share a
    voxel the largest row index wins, the reference's last writer on the
    CPU; a max-scatter makes that winner defined on the card too."""
    n = coords.shape[0]
    size = max_blocks * morton.TABLE_SIZE
    bkey = torch.where(valid,
                       morton.block_key(coords, batch, grid_bits, batch_bits),
                       INVALID)
    ublocks, n_blocks, rank = sorted_unique(bkey, max_blocks)
    bank, row = morton.bank_and_row(morton.local_code(coords))
    flat = rank * morton.TABLE_SIZE + bank * morton.BANK_ROWS + row
    flat = torch.where(valid & (rank < max_blocks), flat, size)
    banks = torch.full((size + 1,), -1, dtype=_I32, device=coords.device)
    banks.scatter_reduce_(0, flat.long(),
                          torch.arange(n, dtype=_I32, device=coords.device),
                          reduce="amax")
    return BlockTable(banks[:size], ublocks, n_blocks.reshape(()))


def query_block_table(table: BlockTable, qcoords: torch.Tensor,
                      qbatch: torch.Tensor, qvalid: torch.Tensor, *,
                      grid_bits: int = 7, batch_bits: int = 4) -> torch.Tensor:
    """Row index of each query coordinate (..., 3), -1 for a miss. One
    gather answers every query against every bank; negative and
    out-of-grid coordinates miss."""
    max_blocks = table.ublocks.shape[0]
    limit = (1 << grid_bits) * morton.BLOCK_SIZE
    inb = ((qcoords >= 0) & (qcoords < limit)).all(dim=-1) & qvalid
    qc = qcoords.clamp(0, limit - 1)
    bkey = morton.block_key(qc, qbatch, grid_bits, batch_bits)
    brank = torch.searchsorted(table.ublocks, bkey.contiguous(),
                               out_int32=True).clamp(max=max_blocks - 1)
    hit = inb & (table.ublocks[brank.long()] == bkey)
    bank, row = morton.bank_and_row(morton.local_code(qc))
    flat = brank * morton.TABLE_SIZE + bank * morton.BANK_ROWS + row
    return torch.where(hit, table.banks[flat.long()], -1)


def offset_queries(coords, batch, valid, offsets):
    """The (N, K, 3) queries ``coords + offsets`` of every row, with the
    row's batch and valid flag broadcast to (N, K)."""
    q = coords[:, None, :] + offsets[None, :, :].to(coords.dtype)
    shape = q.shape[:2]
    return q, batch[:, None].expand(shape), valid[:, None].expand(shape)


def build_kmap_octree(coords: torch.Tensor, batch: torch.Tensor,
                      valid: torch.Tensor, offsets: torch.Tensor, *,
                      max_blocks: int, grid_bits: int = 7,
                      batch_bits: int = 4) -> torch.Tensor:
    """OCTENT map search through a dense table (outputs == inputs): the
    (N, K) int32 kmap, -1 for a miss. The table is freed on return."""
    table = build_block_table(coords, batch, valid, max_blocks=max_blocks,
                              grid_bits=grid_bits, batch_bits=batch_bits)
    return query_block_table(
        table, *offset_queries(coords, batch, valid, offsets),
        grid_bits=grid_bits, batch_bits=batch_bits)


def sorted_key_fits(grid_bits: int, batch_bits: int) -> bool:
    """Whether the composite key (block key << 12 | phi) of
    :func:`build_kmap_sorted` fits int32 at these widths."""
    return 3 * grid_bits + batch_bits + morton.LOCAL_CODE_BITS <= 31


def build_kmap_sorted(coords: torch.Tensor, batch: torch.Tensor,
                      valid: torch.Tensor, offsets: torch.Tensor, *,
                      grid_bits: int = 5, batch_bits: int = 4) -> torch.Tensor:
    """Table-free search: each query's composite key (block key << 12 |
    phi) is found by binary search in the stably sorted keys of the cloud.
    Same output as :func:`build_kmap_octree`; the key must fit int32
    (:func:`sorted_key_fits`: up to 512 voxels an axis at the defaults)."""
    if not sorted_key_fits(grid_bits, batch_bits):
        raise ValueError(
            "the sorted search needs the composite key to fit int32; use "
            "build_kmap_octree for large grids")

    def composite(c, b, v):
        key = morton.block_key(c, b, grid_bits, batch_bits)
        key = (key << morton.LOCAL_CODE_BITS) | morton.local_code(c)
        return torch.where(v, key, INVALID)

    keys = composite(coords, batch, valid)
    skeys, order = torch.sort(keys, stable=True)
    q, qb, qv = offset_queries(coords, batch, valid, offsets)
    limit = (1 << grid_bits) * morton.BLOCK_SIZE
    inb = ((q >= 0) & (q < limit)).all(dim=-1) & qv
    qk = composite(q.clamp(0, limit - 1), qb, inb)
    pos = torch.searchsorted(skeys, qk.contiguous(), out_int32=True)
    pos = pos.clamp(max=keys.shape[0] - 1).long()
    hit = inb & (skeys[pos] == qk) & (qk != INVALID)
    return torch.where(hit, order[pos].to(_I32), -1)


class StridedMaps(NamedTuple):
    """Scatter-form rulebook for strided/transposed layers.

    For Gconv2 and Gconv3, features flow in_idx -> out_idx through weight
    tap ``tap``; Tconv2 reuses the same structure with the roles swapped.
    Maps built under a static output budget (Gconv3) also carry the true
    unique-output count ``n_true`` and ``overflow`` (n_true > budget: the
    outputs were truncated); the other layers leave both None.
    """

    out_coords: torch.Tensor   # (N_out_max, 3) int32
    out_batch: torch.Tensor    # (N_out_max,) int32
    out_valid: torch.Tensor    # (N_out_max,) bool
    n_out: torch.Tensor        # () int32
    in_idx: torch.Tensor       # (M,) int32
    out_idx: torch.Tensor      # (M,) int32
    tap: torch.Tensor          # (M,) int32 weight tap
    mvalid: torch.Tensor       # (M,) bool
    n_true: torch.Tensor | None = None     # () int32
    overflow: torch.Tensor | None = None   # () bool


def _gather_rep(rep: torch.Tensor, src: torch.Tensor, fill=0):
    ok = rep >= 0
    out = src[rep.clamp(min=0).long()]
    mask = ok if out.ndim == 1 else ok[:, None]
    return torch.where(mask, out, fill), ok


def build_maps_gconv2(coords: torch.Tensor, batch: torch.Tensor,
                      valid: torch.Tensor, *, grid_bits: int = 7,
                      batch_bits: int = 4) -> StridedMaps:
    """Gconv2 (k=2, s=2): each voxel maps to its octree parent; the weight
    tap is the child octant phi_1."""
    n = coords.shape[0]
    parent = coords >> 1
    hi = morton.block_key(parent, batch, grid_bits, batch_bits)
    lo = morton.local_code(parent)
    rep, n_out, rank = unique_pairs(hi, lo, valid, n)
    out_coords, ok = _gather_rep(rep, parent)
    out_batch, _ = _gather_rep(rep, batch)
    return StridedMaps(
        out_coords=out_coords.to(_I32), out_batch=out_batch.to(_I32),
        out_valid=ok, n_out=n_out,
        in_idx=torch.arange(n, dtype=_I32, device=coords.device),
        out_idx=torch.where(valid, rank, 0).to(_I32),
        tap=morton.child_octant(coords).to(_I32), mvalid=valid)


#: (8, 3) per-axis choice of each of an input's 8 Gconv3 candidates
_CHOICE = [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)]


def build_maps_gconv3(coords: torch.Tensor, batch: torch.Tensor,
                      valid: torch.Tensor, *, grid_bits: int = 7,
                      batch_bits: int = 4,
                      out_budget: int | None = None) -> StridedMaps:
    """Gconv3 (k=3, s=2), input stationary.

    Output site o receives input i through tap d iff ``2 * o + d ==
    theta_i`` (d in {-1, 0, 1}^3): per axis an even coordinate takes d = 0
    only and an odd one d = +-1, so each input emits at most 8 (out, tap)
    candidates, enumerated statically (M = 8N). The unique outputs are kept
    up to ``out_budget`` (None: 8N); candidates past it are dropped, and
    ``n_true`` / ``overflow`` say so, for the plan to raise on.
    """
    n = coords.shape[0]
    dev = coords.device
    choice = torch.tensor(_CHOICE, dtype=_I32, device=dev)       # (8, 3)
    odd = (coords & 1).to(_I32)                                    # (N, 3)
    d = torch.where(odd[:, None, :] == 1, 2 * choice[None] - 1,
                    torch.zeros((), dtype=_I32, device=dev))       # (N, 8, 3)
    cand_ok = ((odd[:, None, :] == 1) | (choice[None] == 0)).all(dim=-1)
    cand_ok &= valid[:, None]
    out = (coords[:, None, :] - d) >> 1                            # (N, 8, 3)
    tap = (d[..., 0] + 1) + 3 * (d[..., 1] + 1) + 9 * (d[..., 2] + 1)

    out_flat = out.reshape(-1, 3)
    ob = batch[:, None].expand(n, 8).reshape(-1)
    hi = morton.block_key(out_flat, ob, grid_bits, batch_bits)
    lo = morton.local_code(out_flat)
    ok_flat = cand_ok.reshape(-1)
    budget = out_budget if out_budget is not None else ok_flat.shape[0]
    rep, n_out, rank = unique_pairs(hi, lo, ok_flat, budget)
    ok_flat = ok_flat & (rank < budget)
    out_coords, okv = _gather_rep(rep, out_flat)
    out_batch, _ = _gather_rep(rep, ob)
    return StridedMaps(
        out_coords=out_coords.to(_I32), out_batch=out_batch.to(_I32),
        out_valid=okv, n_out=n_out.clamp(max=budget),
        in_idx=torch.arange(n, dtype=_I32, device=dev).repeat_interleave(8),
        out_idx=torch.where(ok_flat, rank, 0).to(_I32),
        tap=tap.reshape(-1).to(_I32), mvalid=ok_flat,
        n_true=n_out, overflow=n_out > budget)


def transpose_maps(maps: StridedMaps, target_coords: torch.Tensor,
                   target_batch: torch.Tensor,
                   target_valid: torch.Tensor) -> StridedMaps:
    """Tconv2: reuse the Gconv2 maps with in/out swapped (no re-search)."""
    return StridedMaps(
        out_coords=target_coords, out_batch=target_batch,
        out_valid=target_valid, n_out=target_valid.sum(dtype=_I32),
        in_idx=maps.out_idx, out_idx=maps.in_idx, tap=maps.tap,
        mvalid=maps.mvalid)


def strided_to_kmap(maps: StridedMaps, *, n_out: int,
                    n_taps: int) -> torch.Tensor:
    """Scatter triples to the gather-form kmap (n_out, n_taps); each
    (out, tap) cell has at most one contributor in every SpConv layer."""
    flat = maps.out_idx * n_taps + maps.tap
    flat = torch.where(maps.mvalid, flat, n_out * n_taps)
    kmap = _scatter_drop(n_out * n_taps, flat, maps.in_idx, -1, _I32)
    return kmap.reshape(n_out, n_taps)
