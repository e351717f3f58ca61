"""Streaming frames: incremental updates of the octree search structures.

Every workload the paper motivates (robotics, AV, AR/VR) is temporal, but
a map search from scratch rebuilds stage 1 and stage 2 of OCTENT for every
cloud. The octree encoding makes a frame-to-frame delta cheap: the block
directory is sorted, so a change touches contiguous directory ranges, and
the compacted ``tkey``/``tval`` table is sorted by (block rank, local
code), so untouched blocks only shift rank. This module is that delta
path, the counterpart of the reference's ``core/stream.py``:

  * :func:`diff_frame` — the set difference of an incoming frame against
    the previous frame's canonical slot layout: evicted slots, inserted
    voxels (which take freed slots in Morton order), the 16^3 blocks whose
    membership changed, and the rows whose 27-neighbourhood touches one
    (only those are searched again).
  * :func:`apply_table_delta` — splice the inserts and evictions into the
    previous frame's stage-1 :class:`~repro_torch.kernels.octent.ops.
    QueryTable`, bit-equal to ``build_query_table`` from scratch over the
    same canonical arrays.
  * :class:`StreamSession` — a MinkUNet over a frame sequence: per
    resolution level, slot-stable canonical arrays, Subm3 plans patched
    through :class:`~repro_torch.core.plan.SubmWarmStart` and
    ``build_kmap(update=)`` (kernel 1 in row-list mode on the dirty rows),
    and strided plans rebuilt from slot probes against the parent level's
    table.

**The canonical slot contract**, which makes "incremental == scratch" a
bit identity: each level's arrays have one row budget N and evolve slot
by slot. A voxel present in both frames keeps its row; an evicted voxel
frees its row (valid False, coords left stale); inserted voxels take the
freed rows in Morton (block key, local code) order, lowest free slot
first. The delta path and a build from scratch read the same canonical
arrays, so their tables and kmaps (whose values are slots) are equal.

A row is searched again iff it was inserted, evicted, or one of its 27
offsets lands in a block whose membership changed; every other row's
query targets sit in unchanged blocks, so its kmap row is kept.

Every ``.at[...].set(mode="drop")`` of the reference is a scatter into a
buffer with one more row, which every dropped index writes and which is
cut off (``mapsearch.set_drop``); the reference's counting sorts are one
stable ``torch.sort`` of the same keys. Flags (``runtime/flags.py``
lists all of the port's): ``REPRO_STREAM`` ('0'
turns the delta path off: every frame from scratch) and
``REPRO_STREAM_MAX_DIRTY`` (the dirty-row share above which a level is
rebuilt, default 0.5).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch

from repro_torch.core import mapsearch, morton
from repro_torch.core import plan as planlib
from repro_torch.core.mapsearch import (INVALID, StridedMaps, _scatter_drop,
                                        set_drop)
from repro_torch.core.spconv import SparseTensor
from repro_torch.core.validate import sanitize_cloud
from repro_torch.device import resolve_device
from repro_torch.kernels.octent import ops as oct_ops
from repro_torch.kernels.octent.kernel import LANE
from repro_torch.kernels.octent.ref import encode_queries, octent_query_ref
from repro_torch.kernels.spconv_gemm import ops as sg_ops
from repro_torch.models import minkunet
from repro_torch.runtime import guard, sharding

_I32 = torch.int32

#: membership and slot probes since the last reset: diff_frame probes
#: every incoming row once a frame, and a canonical Gconv2 plan every
#: child row against the parent level's table
PROBE_ROWS = [0]


def stream_enabled() -> bool:
    """``REPRO_STREAM``: '0' turns the delta path off."""
    return os.environ.get("REPRO_STREAM", "1") != "0"


def max_dirty_frac() -> float:
    """``REPRO_STREAM_MAX_DIRTY``: dirty-row share above which a level is
    rebuilt from scratch instead of patched (default 0.5)."""
    return float(os.environ.get("REPRO_STREAM_MAX_DIRTY", "0.5"))


class FrameState(NamedTuple):
    """One level's slot-stable geometry (module doc contract)."""

    coords: torch.Tensor             # (N, 3) int32 canonical slot coords
    batch: torch.Tensor              # (N,) int32
    valid: torch.Tensor              # (N,) bool
    table: oct_ops.QueryTable        # stage 1 over these arrays
    kmap: torch.Tensor               # (N, 27) int32 Subm3 kernel map


class FrameDelta(NamedTuple):
    """The set difference of one frame against the previous canonical
    layout (:func:`diff_frame`)."""

    slot_of: torch.Tensor       # (N,) int32 slot of each incoming row,
                                # -1 for invalid or duplicate rows
    inserted: torch.Tensor      # (N,) bool, per canonical slot
    evicted: torch.Tensor       # (N,) bool, per canonical slot
    dirty_rows: torch.Tensor    # (N,) bool: to be searched again
    dirty_blocks: torch.Tensor  # (max_blocks,) int32 sorted, INVALID pad
    n_dirty_blocks: torch.Tensor  # () int32 true count; above max_blocks
                                  # the set was truncated: go scratch
    n_inserted: torch.Tensor    # () int32
    n_evicted: torch.Tensor     # () int32
    n_dirty_rows: torch.Tensor  # () int32
    n_free: torch.Tensor        # () int32 free slots before the inserts


def empty_state(n: int, *, max_blocks: int, grid_bits: int = 7,
                batch_bits: int = 4, device=None) -> FrameState:
    """The all-invalid state before the first frame, whose diff is then a
    100 % insert, built by the scratch builder so the bit identity holds
    from the start."""
    dev = resolve_device(device)
    coords = torch.zeros((n, 3), dtype=_I32, device=dev)
    batch = torch.zeros((n,), dtype=_I32, device=dev)
    valid = torch.zeros((n,), dtype=torch.bool, device=dev)
    table = oct_ops.build_query_table(coords, batch, valid,
                                      max_blocks=max_blocks,
                                      grid_bits=grid_bits,
                                      batch_bits=batch_bits)
    kmap = torch.full((n, 27), -1, dtype=_I32, device=dev)
    return FrameState(coords, batch, valid, table, kmap)


def probe_slots(table: oct_ops.QueryTable, coords, batch, valid, *,
                grid_bits: int = 7, batch_bits: int = 4) -> torch.Tensor:
    """The canonical slot of each (coord, batch) in ``table``'s layout, -1
    for a miss or an invalid row: a one-offset (0, 0, 0) query, since
    ``tval`` values are slots. It stays the plain version: its queries
    are another cloud's rows, which the kernel's per-row index of the
    table's own rows cannot answer."""
    zero = torch.zeros((1, 3), dtype=_I32, device=coords.device)
    return octent_query_ref(coords, batch, valid, zero, table.ublocks,
                            table.tkey, table.tval, table.n_blocks,
                            grid_bits=grid_bits,
                            batch_bits=batch_bits)[:, 0]


def _diff(state: FrameState, ic, ib, iv, *, max_blocks: int,
          grid_bits: int, batch_bits: int):
    sc, sb, sv = state.coords, state.batch, state.valid
    n = sc.shape[0]
    dev = sc.device
    hb = 3 * grid_bits + batch_bits
    limit = (1 << grid_bits) * morton.BLOCK_SIZE
    # out-of-grid incoming rows (a sensor drifting past the boundary) can
    # be neither probed nor keyed without aliasing: drop them, so that the
    # canonical arrays stay in the grid
    iv = iv & ((ic >= 0) & (ic < limit)).all(dim=-1)
    slot = probe_slots(state.table, ic, ib, iv, grid_bits=grid_bits,
                       batch_bits=batch_bits)

    seen = _scatter_drop(n, torch.where(slot >= 0, slot, n), True, False,
                         torch.bool)
    evicted = sv & ~seen
    is_new = iv & (slot < 0)

    # repeated new keys keep their first occurrence (a parent level's
    # incoming set holds up to 8 rows of one parent)
    hi = morton.block_key(ic, ib, grid_bits, batch_bits)
    lo = morton.local_code(ic)
    rep, _, _ = mapsearch.unique_pairs(hi, lo, is_new, n)
    is_new = is_new & _scatter_drop(n, torch.where(rep >= 0, rep, n), True,
                                    False, torch.bool)
    n_new = is_new.sum(dtype=_I32)

    # inserts take freed slots in Morton (block key, local code) order,
    # lowest free slot first: one stable sort of a 64-bit key whose high
    # part puts the rows that are not new last
    key = ((torch.where(is_new, hi, 1 << hb).long()
            << morton.LOCAL_CODE_BITS) | torch.where(is_new, lo, 0).long())
    order = torch.sort(key, stable=True).indices
    free = ~sv | evicted
    n_free = free.sum(dtype=_I32)
    fr = torch.cumsum(free, 0, dtype=_I32) - 1
    ar = torch.arange(n, dtype=_I32, device=dev)
    free_slot = _scatter_drop(n, torch.where(free, fr, n), ar, n, _I32)
    take = ar < torch.minimum(n_new, n_free)
    tgt = torch.where(take, free_slot, -1)
    slot_new = torch.full((n,), -1, dtype=_I32, device=dev)
    slot_new[order] = tgt

    dst = torch.where(tgt >= 0, tgt, n)
    inserted = _scatter_drop(n, dst, True, False, torch.bool)
    new_c = set_drop(sc, dst, ic[order])
    new_b = set_drop(sb, dst, ib[order])
    new_v = (sv & ~evicted) | inserted
    slot_of = torch.where(is_new, slot_new, slot)

    # dirty blocks: every block whose membership changed
    dk = torch.cat([
        torch.where(evicted, morton.block_key(sc, sb, grid_bits, batch_bits),
                    INVALID),
        torch.where(inserted, morton.block_key(new_c, new_b, grid_bits,
                                               batch_bits), INVALID)])
    dirty_blocks, n_dirty_blocks, _ = mapsearch.sorted_unique(dk, max_blocks)

    # dirty rows: inserted and evicted slots, and every row with a query of
    # its 27-neighbourhood in a dirty block
    offs = torch.as_tensor(morton.subm3_offsets(), device=dev)
    inb, qbk, _, _ = encode_queries(new_c, new_b, new_v, offs,
                                    grid_bits=grid_bits)
    qbk = qbk.contiguous()
    pos = torch.searchsorted(dirty_blocks, qbk, out_int32=True).clamp(
        max=max_blocks - 1)
    touch = (inb & (dirty_blocks[pos.long()] == qbk)).any(dim=1)
    dirty_rows = touch | inserted | evicted

    delta = FrameDelta(slot_of, inserted, evicted, dirty_rows, dirty_blocks,
                       n_dirty_blocks.to(_I32), n_new,
                       evicted.sum(dtype=_I32), dirty_rows.sum(dtype=_I32),
                       n_free)
    return delta, new_c, new_b, new_v


def diff_frame(state: FrameState, coords, batch, valid, *, max_blocks: int,
               grid_bits: int = 7, batch_bits: int = 4):
    """Diff an incoming frame against ``state``'s canonical layout.

    ``coords``, ``batch``, ``valid`` are the incoming frame on the state's
    device, padded to the state's row budget N; ``max_blocks`` sizes the
    dirty-block set (use the state table's directory capacity).

    Returns ``(delta, new_coords, new_batch, new_valid)``: the
    :class:`FrameDelta` and the new canonical arrays. Out-of-grid rows are
    invalidated, a repeated key keeps its first row. When
    ``delta.n_dirty_blocks > max_blocks`` the dirty set was truncated and
    the frame must be rebuilt from scratch.
    """
    n = state.coords.shape[0]
    if coords.shape[0] != n:
        raise ValueError(
            f"streaming frames share one static row budget: state has "
            f"{n} slots but the incoming frame has {coords.shape[0]} rows "
            f"— repad the frame to the session budget")
    PROBE_ROWS[0] += n
    return _diff(state, coords, batch, valid, max_blocks=max_blocks,
                 grid_bits=grid_bits, batch_bits=batch_bits)


def _live_slots(tval: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) bool: the slots a live table entry references, i.e. the
    previous frame's valid mask, read from the table itself."""
    return _scatter_drop(n, torch.where(tval >= 0, tval, n), True, False,
                         torch.bool)


def _splice(table: oct_ops.QueryTable, sc, sb, evicted, nc, nb_arr,
            inserted, dirty_blocks, *, max_blocks: int, grid_bits: int,
            batch_bits: int) -> oct_ops.QueryTable:
    ublocks, n_blocks, tkey, tval = table
    mb = max_blocks
    n = sc.shape[0]
    dev = sc.device
    sentinel = mb * morton.TABLE_SIZE
    d = dirty_blocks

    def lower_bound(sorted_keys, keys):
        return torch.searchsorted(sorted_keys, keys.contiguous(),
                                  out_int32=True)

    # (a) occupancy of each dirty block after the frame: live after = kept
    # (live before, not evicted) or inserted
    bk_new = morton.block_key(nc, nb_arr, grid_bits, batch_bits)
    posd = lower_bound(d, bk_new).clamp(max=mb - 1)
    live_after = inserted | (~evicted & _live_slots(tval, n))
    ind = torch.where(live_after & (d[posd.long()] == bk_new), posd, mb)
    occ_new = torch.zeros(mb + 1, dtype=_I32, device=dev).index_add_(
        0, ind.long(), torch.ones_like(ind))[:mb]

    # (b) was each dirty block in the directory before the frame
    posb = lower_bound(ublocks, d).clamp(max=mb - 1)
    present = (ublocks[posb.long()] == d) & (d != INVALID)
    removed_d = present & (occ_new == 0)
    added_d = ~present & (occ_new > 0) & (d != INVALID)

    # (c) the sorted removed and added keys (d is sorted)
    def compact(mask, src):
        p = torch.cumsum(mask, 0, dtype=_I32) - 1
        return _scatter_drop(mb, torch.where(mask, p, mb), src, INVALID,
                             _I32), p
    removed_keys, _ = compact(removed_d, d)
    added_keys, apos = compact(added_d, d)

    # (d) merge the kept directory with the added keys: both are sorted
    # and disjoint, so two lower bounds give the final ranks
    pr = lower_bound(removed_keys, ublocks).clamp(max=mb - 1)
    keep_dir = (ublocks != INVALID) & (removed_keys[pr.long()] != ublocks)
    kpos = torch.cumsum(keep_dir, 0, dtype=_I32) - 1
    kept_keys, _ = compact(keep_dir, ublocks)
    nr_kept = kpos + lower_bound(added_keys, ublocks)
    nr_added = apos + lower_bound(kept_keys, d)
    ub_new = _scatter_drop(mb, torch.where(keep_dir, nr_kept, mb), ublocks,
                           INVALID, _I32)
    ub_new = set_drop(ub_new, torch.where(added_d, nr_added, mb), d)
    nb_new = (n_blocks - removed_d.sum(dtype=_I32)
              + added_d.sum(dtype=_I32)).to(_I32)

    # (e) the compacted table: kept entries shift rank by the monotone
    # remap (and stay sorted), evicted entries drop, inserted ones merge
    new_rank_of_old = torch.where(keep_dir, nr_kept, mb)
    npad = tkey.shape[0]
    keep_e = (tval >= 0) & ~evicted[tval.clamp(0, n - 1).long()]
    old_rank = (tkey >> morton.LOCAL_CODE_BITS).clamp(0, mb - 1)
    tk_shift = (new_rank_of_old[old_rank.long()] * morton.TABLE_SIZE
                + (tkey & (morton.TABLE_SIZE - 1)))
    adst = torch.where(keep_e, torch.cumsum(keep_e, 0, dtype=_I32) - 1, npad)
    a_key = _scatter_drop(npad, adst, tk_shift, sentinel, _I32)
    a_val = _scatter_drop(npad, adst, tval, -1, _I32)

    rank_ins = lower_bound(ub_new, bk_new)
    bank, row = morton.bank_and_row(morton.local_code(nc))
    tk_ins = (rank_ins.clamp(0, mb - 1) * morton.TABLE_SIZE
              + bank * morton.BANK_ROWS + row)
    tk_ins = torch.where(inserted, tk_ins, sentinel)
    b_key, order = torch.sort(tk_ins, stable=True)
    b_val = torch.where(b_key < sentinel, order.to(_I32), -1)

    # two-way merge: a real key is never on both sides (an inserted voxel
    # would have probed a hit), so each real entry's final position is its
    # own index plus the count of smaller real entries on the other side
    pos_a = torch.arange(npad, dtype=_I32, device=dev) + lower_bound(
        b_key, a_key)
    pos_b = torch.arange(n, dtype=_I32, device=dev) + lower_bound(
        a_key, b_key)
    ra = torch.where(a_key < sentinel, pos_a, npad)
    rb = torch.where(b_key < sentinel, pos_b, npad)
    out_key = set_drop(_scatter_drop(npad, ra, a_key, sentinel, _I32), rb,
                       b_key)
    out_val = set_drop(_scatter_drop(npad, ra, a_val, -1, _I32), rb, b_val)
    return oct_ops.QueryTable(ub_new, nb_new, out_key, out_val)


def apply_table_delta(table: oct_ops.QueryTable, delta: FrameDelta,
                      old_coords, old_batch, new_coords, new_batch, *,
                      max_blocks: int, grid_bits: int = 7,
                      batch_bits: int = 4) -> oct_ops.QueryTable:
    """Splice ``delta`` into the previous frame's stage-1 table.

    The input table is never changed, so an overflow raises before any
    pinned state could be corrupted. Returns a table bit-equal to
    ``build_query_table`` over the canonical arrays ``delta`` was computed
    for. Raises :class:`~repro_torch.core.plan.CapacityOverflow` when the
    dirty-block set was truncated or the new directory exceeds
    ``max_blocks`` (one host read each).
    """
    n_dirty = int(delta.n_dirty_blocks)
    if n_dirty > max_blocks:
        raise planlib.CapacityOverflow(
            "block_table",
            f"streaming dirty-block set overflow: the frame touches "
            f"{n_dirty} 16^3 blocks but max_blocks={max_blocks}; the "
            f"truncated delta cannot be spliced — rebuild from scratch "
            f"at higher capacity", needed=n_dirty, capacity=max_blocks)
    out = _splice(table, old_coords, old_batch, delta.evicted, new_coords,
                  new_batch, delta.inserted, delta.dirty_blocks,
                  max_blocks=max_blocks, grid_bits=grid_bits,
                  batch_bits=batch_bits)
    nb = int(out.n_blocks)
    if nb > max_blocks:
        raise planlib.CapacityOverflow(
            "block_table",
            f"octree block table overflow mid-stream: the spliced frame "
            f"occupies {nb} 16^3 blocks but max_blocks={max_blocks} — "
            f"surfacing for with_replan instead of corrupting the pinned "
            f"table", needed=nb, capacity=max_blocks)
    return out


def pack_dirty_rows(dirty_rows: torch.Tensor,
                    budget: int) -> torch.Tensor | None:
    """-1-padded (budget,) int32 list of the dirty rows, on the mask's
    device (``torch.nonzero``: one host read of the count), or None when
    they do not fit ``budget``."""
    idx = torch.nonzero(dirty_rows).flatten().to(_I32)
    if idx.numel() > budget:
        return None
    return torch.cat([idx, idx.new_full((budget - idx.numel(),), -1)])


def row_budget(n_dirty: int, n: int) -> int:
    """LANE-rounded dirty-row budget, clipped to [LANE, n]."""
    return int(min(max(LANE, -(-n_dirty // LANE) * LANE), n))


# ---------------------------------------------------------------------------
# Streaming session: a MinkUNet over a frame sequence
# ---------------------------------------------------------------------------

class StreamSession:
    """Long-lived geometry of a frame sequence through MinkUNet
    (``launch/spconv_stream.py`` drives it).

    Per resolution level r = 0 .. len(cfg.enc) the session keeps a
    :class:`FrameState`. :meth:`advance` diffs the incoming frame level by
    level (level r + 1's incoming set is level r's new canonical coords
    >> 1), patches each Subm3 plan when the dirty set is small, rebuilds
    from scratch otherwise, and rebuilds the Gconv2 and Tconv2 plans from
    slot probes against the parent level's table. :meth:`forward` scatters
    the incoming rows' features into the canonical slots and runs the
    model with those plans.

    Each level's table is held by the session and pinned in the cache's
    PinnedStore under a refcounted key, so byte pressure from other work
    evicts around an active stream; :meth:`close` releases the holds.
    Failures are atomic: a :class:`~repro_torch.core.plan.CapacityOverflow`
    that escapes ``with_replan`` leaves every level at the previous frame.

    Args:
      cfg: a ``models.minkunet.MinkUNetConfig``.
      n: the row budget of every level and frame.
      max_blocks: starting directory capacity per level (None: ``n``).
      cache: a long-lived :class:`~repro_torch.core.plan.PlanCache`, whose
        content keys make a repeated frame a hit with no search (None: a
        private one).
      enabled: the delta path on or off (None: :func:`stream_enabled`).
      dirty_frac: full-rebuild threshold (None: :func:`max_dirty_frac`).
      search_impl: ``"kernel"`` (default: kernel 1, in row-list mode on
        the dirty rows) or ``"ref"`` (its plain version). Under a mesh
        the stream keeps this single-device engine and its whole table,
        as the reference's delta path does, and its pinned tables are
        keyed by the mesh fingerprint.
      replan: wrap builds in ``guard.with_replan`` (None: on unless
        ``REPRO_GUARD_REPLAN=0``).
      device: None runs on the card (raises without one); ``"cpu"`` runs
        the plain versions.
    """

    def __init__(self, cfg, n: int, *, max_blocks: int | None = None,
                 cache: planlib.PlanCache | None = None,
                 enabled: bool | None = None,
                 dirty_frac: float | None = None,
                 search_impl: str | None = None,
                 replan: bool | None = None, device=None):
        simpl = search_impl or "kernel"
        if simpl not in ("kernel", "ref"):
            raise ValueError(f"unknown search impl {simpl!r}")
        self.cfg = cfg
        self.n = n
        self.device = resolve_device(device)
        self.levels = len(cfg.enc) + 1
        self.cache = cache if cache is not None else planlib.PlanCache()
        self.enabled = stream_enabled() if enabled is None else enabled
        self.dirty_frac = max_dirty_frac() if dirty_frac is None \
            else dirty_frac
        self.simpl = simpl
        self.replan = guard.replan_retries() > 0 if replan is None \
            else replan
        mb = n if max_blocks is None else max_blocks
        self.mb = [mb] * self.levels
        self.states = [empty_state(n, max_blocks=mb,
                                   grid_bits=cfg.grid_bits,
                                   batch_bits=cfg.batch_bits,
                                   device=self.device)
                       for _ in range(self.levels)]
        self.pin_keys: list = [None] * self.levels
        self.plans = None
        self.slot_of = None
        self.counters = {k: 0 for k in (
            "frames", "delta_levels", "full_levels", "content_hit_levels",
            "rows_searched", "rows_scratch", "kmap_rows_reused",
            "kmap_rows_total", "table_refetches", "table_rebuilds")}

    # -- per-level machinery -------------------------------------------------

    def _pin_key(self, fp, mb):
        if fp is None:
            return None
        return ("qtable", fp, mb, self.cfg.grid_bits, self.cfg.batch_bits,
                sharding.mesh_fingerprint())

    def _advance_level(self, r: int, ic, ib, iv):
        """Diff and rebuild one level. Returns the new state, the Subm3
        plan, the delta, the capacity used, the pin key and the counter
        increments; nothing on the session changes (the caller commits)."""
        cfg = self.cfg
        gb, bb = cfg.grid_bits, cfg.batch_bits
        st = self.states[r]
        mb0 = self.mb[r]
        delta, nc, nb_arr, nv = diff_frame(st, ic, ib, iv, max_blocks=mb0,
                                           grid_bits=gb, batch_bits=bb)
        n_dirty, n_dblocks = torch.stack(
            [delta.n_dirty_rows, delta.n_dirty_blocks]).tolist()
        use_delta = (self.enabled and n_dblocks <= mb0
                     and n_dirty <= self.dirty_frac * self.n)
        rows = pack_dirty_rows(delta.dirty_rows,
                               row_budget(n_dirty, self.n)) \
            if use_delta and n_dirty else None
        # one fingerprint keys both the plan lookup and the pinned table
        fp = planlib.content_fingerprint((nc, nb_arr, nv))
        built: dict = {}

        def build(mb_now):
            built.clear()
            built["mb"] = mb_now

            def patch():
                if n_dirty == 0:
                    # an empty delta: the table and every kmap row stay,
                    # no query row runs
                    built["table"], built["kmap"] = st.table, st.kmap
                    return st.kmap, st.table
                table = apply_table_delta(st.table, delta, st.coords,
                                          st.batch, nc, nb_arr,
                                          max_blocks=mb_now, grid_bits=gb,
                                          batch_bits=bb)
                kmap, _ = oct_ops.build_kmap(
                    nc, nb_arr, nv, max_blocks=mb_now, grid_bits=gb,
                    batch_bits=bb, impl=self.simpl, table=table,
                    update=oct_ops.KmapUpdate(st.kmap, rows))
                built["table"], built["kmap"] = table, kmap
                return kmap, table

            # a capacity escalation changes the table's address space, so
            # the delta no longer applies: go scratch
            warm = planlib.SubmWarmStart(patch) \
                if use_delta and mb_now == mb0 else None
            ms0 = planlib.MAPSEARCH_CALLS[0]
            plan = planlib.subm3_plan(
                nc, nb_arr, nv, max_blocks=mb_now, grid_bits=gb,
                batch_bits=bb, bm=cfg.bm, bo=cfg.bo,
                search_impl=self.simpl, cache=self.cache,
                content_key=lambda: fp, warm=warm)
            built["searched"] = planlib.MAPSEARCH_CALLS[0] > ms0
            return plan

        if self.replan:
            plan = guard.with_replan(build, mb0,
                                     key=("stream-subm3", r, self.n, gb, bb))
        else:
            plan = build(mb0)
        mb_used = built.get("mb", mb0)
        pin_key = self._pin_key(fp, mb_used)
        store = self.cache.pinned

        acct = {k: 0 for k in self.counters}
        acct["kmap_rows_total"] += self.n
        acct["rows_scratch"] += self.n

        def fetch_or_rebuild():
            t = store.get(pin_key) if pin_key is not None else None
            if t is not None:
                acct["table_refetches"] += 1
                return t
            acct["table_rebuilds"] += 1
            t = oct_ops.build_query_table(nc, nb_arr, nv,
                                          max_blocks=mb_used, grid_bits=gb,
                                          batch_bits=bb)
            if pin_key is not None:
                store.put(pin_key, t)
            return t

        if "table" in built:
            # the warm patch ran
            table, kmap = built["table"], built["kmap"]
            acct["delta_levels"] += 1
            acct["rows_searched"] += rows.shape[0] if rows is not None else 0
            acct["kmap_rows_reused"] += self.n - n_dirty
        elif built.get("searched"):
            # a search from scratch inside subm3_plan, which pinned its
            # table: fetch it back for the state
            kmap = plan.kmap
            acct["full_levels"] += 1
            acct["rows_searched"] += self.n
            table = fetch_or_rebuild()
        else:
            # a cache hit: the plan was served without a build
            kmap = plan.kmap
            acct["content_hit_levels"] += 1
            acct["kmap_rows_reused"] += self.n
            table = fetch_or_rebuild()
        new_state = FrameState(nc, nb_arr, nv, table, kmap)
        return new_state, plan, delta, mb_used, pin_key, acct

    def _gconv2_stream_plan(self, child: FrameState, parent: FrameState):
        """The canonical-slot Gconv2 plan: each child row maps to its
        parent's slot in the parent level's layout by a table probe. Its
        outputs are the parent level's N slots, gaps included, so it is
        stable across frames and hits the content cache whenever both
        levels repeat."""
        cfg = self.cfg
        gb, bb = cfg.grid_bits, cfg.batch_bits
        cc, cb, cv = child.coords, child.batch, child.valid
        pc, pb, pv = parent.coords, parent.batch, parent.valid
        n = self.n

        def build(_fp):
            PROBE_ROWS[0] += n
            out_idx = probe_slots(parent.table, cc >> 1, cb, cv,
                                  grid_bits=gb, batch_bits=bb)
            mvalid = cv & (out_idx >= 0)
            maps = StridedMaps(
                out_coords=pc, out_batch=pb, out_valid=pv,
                n_out=pv.sum(dtype=_I32),
                in_idx=torch.arange(n, dtype=_I32, device=cc.device),
                out_idx=torch.where(mvalid, out_idx, 0).to(_I32),
                tap=morton.child_octant(cc).to(_I32), mvalid=mvalid)
            kmap = mapsearch.strided_to_kmap(maps, n_out=n, n_taps=8)
            tiles = sg_ops.build_tap_tiles(kmap, bm=cfg.bm, bo=cfg.bo)
            return planlib.ConvPlan("gconv2", kmap, tiles, n, 8,
                                    pc, pb, pv, maps)

        return planlib._maybe_cached(
            self.cache, (cc, cb, cv, pc, pb, pv),
            ("gconv2stream", gb, bb, cfg.bm, cfg.bo), build)

    # -- public API ----------------------------------------------------------

    def advance(self, coords, batch, valid) -> FrameDelta:
        """Ingest one frame (numpy arrays or CPU tensors, sanitized on the
        host under ``guard.validate_policy()`` and moved to the session's
        device once): update every level's canonical state and rebuild
        the MinkUNet plan set. Returns the level-0 :class:`FrameDelta`,
        whose ``slot_of`` maps incoming rows to canonical slots. Atomic:
        on an overflow (replanning off or spent) nothing changes."""
        cfg = self.cfg
        policy = guard.validate_policy()
        if policy is not None:
            coords, batch, valid, _, _ = sanitize_cloud(
                coords, batch, valid, grid_bits=cfg.grid_bits,
                batch_bits=cfg.batch_bits, policy=policy)
        ic, ib, iv = (minkunet._as_tensor(a, dt, self.device)
                      for a, dt in ((coords, _I32), (batch, _I32),
                                    (valid, torch.bool)))

        new_states, subms, mbs, pin_keys = [], [], [], []
        pending = {k: 0 for k in self.counters}
        delta0 = None
        for r in range(self.levels):
            state, plan, delta, mb_used, pin_key, acct = \
                self._advance_level(r, ic, ib, iv)
            for k, v in acct.items():
                pending[k] += v
            new_states.append(state)
            subms.append(plan)
            mbs.append(mb_used)
            pin_keys.append(pin_key)
            if r == 0:
                delta0 = delta
            ic, ib, iv = state.coords >> 1, state.batch, state.valid

        downs = [self._gconv2_stream_plan(new_states[r], new_states[r + 1])
                 for r in range(self.levels - 1)]
        ups = []
        for i in range(len(cfg.dec)):
            t = new_states[self.levels - 2 - i]
            ups.append(planlib.tconv2_plan(downs[-(i + 1)].maps, t.coords,
                                           t.batch, t.valid, bm=cfg.bm,
                                           bo=cfg.bo, cache=self.cache))

        # commit: everything above left the session as it was
        store = self.cache.pinned
        for old, new in zip(self.pin_keys, pin_keys):
            if new is not None:
                store.acquire(new)
            if old is not None:
                store.release(old)
        self.states = new_states
        self.mb = mbs
        self.pin_keys = pin_keys
        self.slot_of = delta0.slot_of
        self.plans = minkunet.MinkPlans(tuple(subms), tuple(downs),
                                        tuple(ups))
        for k, v in pending.items():
            self.counters[k] += v
        self.counters["frames"] += 1
        return delta0

    def forward(self, model, feats, *, training: bool = False,
                impl: str | None = None) -> torch.Tensor:
        """Scatter ``feats`` (aligned with the last :meth:`advance`'s
        incoming rows; numpy or a tensor) into the canonical slots and run
        ``model`` (a :class:`~repro_torch.models.minkunet.MinkUNet` on the
        session's device) with the prepared plans. Returns (N, classes)
        logits in canonical slot order."""
        if self.plans is None:
            raise RuntimeError("advance() a frame before forward()")
        st0 = self.states[0]
        f = scatter_rows(minkunet._as_tensor(feats, torch.float32,
                                             self.device),
                         self.slot_of, self.n)
        st = SparseTensor(st0.coords, st0.batch, st0.valid, f)
        return minkunet.forward(model, st, plans=self.plans, impl=impl,
                                training=training)

    def stats(self) -> dict:
        return dict(self.counters)

    def close(self) -> None:
        """Release every refcounted table pin (idempotent)."""
        store = self.cache.pinned
        for key in self.pin_keys:
            if key is not None:
                store.release(key)
        self.pin_keys = [None] * self.levels


def scatter_rows(values: torch.Tensor, slot_of: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Scatter per-incoming-row values into canonical slots; rows with
    ``slot_of < 0`` (invalid or dropped duplicates) are dropped."""
    return set_drop(values.new_zeros((n,) + values.shape[1:]),
                    torch.where(slot_of >= 0, slot_of, n), values)
