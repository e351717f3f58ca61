"""Execution plans: memoized map search + tiling for rulebook execution.

A :class:`ConvPlan` bundles everything about a convolution that depends
only on geometry — the kernel map and its tap-scheduled tile streams — and
a :class:`PlanCache` memoizes plans per coordinate set, so B stacked Subm3
blocks pay for OCTENT once, and a MinkUNet decoder stage reuses the
encoder plan at its resolution. SPAC liveness depends on the current
features and is refreshed per layer at execution time.

Cache keys come in two forms, as in the reference:

* **identity keys** (the fast path): the ids of the key tensors plus the
  static search parameters. Entries anchor their key tensors, so an id
  cannot be recycled while its alias lives.
* **content keys**: on an identity miss, :func:`array_fingerprint` of
  each integer or bool key tensor (three 32-bit words, the reference's bit
  for bit) plus its shape and dtype, or a key the caller derives from it.
  A re-allocated identical cloud (a replayed training batch, a
  re-submitted request) then hits with zero map searches. Float tensors
  are refused (identity only). ``minkunet.build_plans`` hashes each
  level's coordinate set once, on a miss, and keys that level's lookups
  by it (one host sync for a replayed cloud, one a level for a fresh
  one).

``MAPSEARCH_CALLS`` counts actual map searches, so callers can check that
a forward searches 2E+1 times, and a replayed cloud zero times.

The pinned tier: a content-keyed Subm3 build pins its stage-1
:class:`~repro_torch.kernels.octent.ops.QueryTable` in the cache's
:class:`~repro_torch.runtime.feature_cache.PinnedStore`, so a rebuild after
the plan's eviction, or a streaming frame's level, skips the table build.
A :class:`SubmWarmStart` lets a streaming session patch the previous
frame's kmap and table instead of searching (``DELTA_PATCHES``).

Durability: with a :class:`~repro_torch.runtime.persist.SnapshotStore`
(``PlanCache(persist=)``) content-keyed plans write through to disk and a
content miss reads through before building, so a restarted process
serves a geometry it has seen with no search. The plan builders check the
``plan`` fault site, and the fingerprint the ``fingerprint`` site
(``runtime/fault.py``).
"""
from __future__ import annotations

import functools
import os
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import mapsearch, morton, rulebook, sparsity
from repro_torch.core.mapsearch import StridedMaps
from repro_torch.core.validate import CapacityOverflow  # noqa: F401
from repro_torch.kernels.octent import ops as oct_ops
from repro_torch.kernels.spconv_gemm import ops as sg_ops
from repro_torch.runtime import fault, feature_cache, sharding

MAPSEARCH_CALLS = [0]

#: Subm3 plans built by a warm start's patch instead of a search
DELTA_PATCHES = [0]


def mapsearch_call_count() -> int:
    """Map-search invocations since the last reset."""
    return MAPSEARCH_CALLS[0]


def reset_mapsearch_counter() -> None:
    MAPSEARCH_CALLS[0] = 0


# ---------------------------------------------------------------------------
# Content fingerprinting: the reference's uint32 arithmetic in int64
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c_lo, c_hi) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32), ``c`` given as its
    16-bit halves ``c_lo`` and ``c_hi``, so that no product leaves int64."""
    return (x * c_lo + (((x * c_hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer (the reference's ``_mix32``) on int64 words."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x352D, 0x7FEB)          # 0x7FEB352D
    x = x ^ (x >> 15)
    x = _mul32(x, 0xA68B, 0x846C)          # 0x846CA68B
    return x ^ (x >> 16)


@functools.lru_cache(maxsize=8)
def _index_words(size: int, device: torch.device):
    """Constants of a padded length: the indices, their mix, and the 16-bit
    halves of their odd weights ``2 * idx + 1``."""
    idx = torch.arange(size, dtype=torch.int64, device=device)
    w = (2 * idx + 1) & _M32
    return idx, _mix32(idx), w & 0xFFFF, w >> 16


def _fp_words(flats: list[torch.Tensor]) -> torch.Tensor:
    """(S, 3) int64 fingerprint words of S flat int32 tensors.

    Row s is the reference's ``_fp_words(flats[s])``: each word, as uint32,
    is mixed with the mix of its index, then reduced by XOR, by a sum mod
    2**32 and by a sum weighted by ``2 * idx + 1`` mod 2**32. The tensors
    are laid out as the rows of one zero-padded (S, 2**k) array, so that
    one pass serves them all; XOR reduces by a halving fold.
    """
    size = 1 << max(max(f.numel() for f in flats) - 1, 0).bit_length()
    dev = flats[0].device
    idx, idx_mix, w_lo, w_hi = _index_words(size, dev)
    words = torch.zeros((len(flats), size), dtype=torch.int64, device=dev)
    for row, f in zip(words, flats):
        row[:f.numel()] = f
    words &= _M32
    lengths = torch.tensor([f.numel() for f in flats], device=dev)
    h = torch.where(idx < lengths[:, None], _mix32(words ^ idx_mix), 0)
    tot = h.sum(1) & _M32
    wtot = _mul32(h, w_lo, w_hi).sum(1) & _M32
    while h.shape[1] > 1:
        half = h.shape[1] // 2
        h = h[:, :half] ^ h[:, half:]
    return torch.stack([h[:, 0], tot, wtot], dim=1)


def _as_words(a: torch.Tensor) -> torch.Tensor | None:
    """The flat int32 words the reference hashes, or None for floats."""
    if a.dtype.is_floating_point or a.dtype.is_complex:
        return None
    if a.element_size() > 4:
        # every 32-bit word, little-endian as the reference's bitcast:
        # values equal mod 2**32 must not collide
        return a.reshape(-1).contiguous().view(torch.int32)
    return a.reshape(-1).to(torch.int32)


def content_fingerprint(arrays) -> tuple | None:
    """Fingerprints of a tuple of key tensors (numpy arrays are taken as
    CPU tensors), one :func:`array_fingerprint` tuple each; None if any is
    a float tensor. The words of all of them come to the host in one
    copy. Each tensor's words pass the ``fingerprint`` fault site, which
    zeroes them when it fires: a content-key collision, which a verifying
    cache detects and rebuilds."""
    arrays = [a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a)) for a in arrays]
    flats = [_as_words(a) for a in arrays]
    if any(f is None for f in flats):
        return None
    words = _fp_words(flats).cpu().numpy()
    return tuple((tuple(a.shape), str(a.dtype).removeprefix("torch."),
                  *(int(x) for x in fault.mangle("fingerprint", w)))
                 for a, w in zip(arrays, words))


def array_fingerprint(a) -> tuple | None:
    """``(shape, dtype, w0, w1, w2)`` of an integer or bool tensor: the
    reference's content fingerprint, with its three 32-bit words equal to
    the reference's bit for bit on the same values. None for floats
    (plan keys are integral; refusing keeps the cache conservative about
    NaN and -0.0)."""
    fp = content_fingerprint((a,))
    return None if fp is None else fp[0]


class ConvPlan(NamedTuple):
    """Geometry-only execution plan for one SpConv layer.

    ``out_*`` are None for coordinate-preserving layers (outputs ==
    inputs); ``maps`` carries the scatter-form triples of strided layers so
    Tconv2 and the input-stationary Gconv3 can reuse them.
    """

    kind: str                      # subm3 | gconv2 | gconv3 | tconv2
    kmap: torch.Tensor             # (N_out, K) int32
    tiles: sg_ops.TapTiles | None  # None for a plan built without tiles
                                   # (input-stationary Gconv3)
    n_out: int                     # static output row budget
    n_taps: int
    out_coords: torch.Tensor | None
    out_batch: torch.Tensor | None
    out_valid: torch.Tensor | None
    maps: StridedMaps | None

    @property
    def residency(self) -> dict:
        """Bytes per caching tier of this plan
        (:func:`~repro_torch.runtime.feature_cache.plan_tier_bytes`): the
        pinned per-tile metadata against the cached kmap and slot streams.
        The search table is pinned apart, in the cache's store."""
        return feature_cache.plan_tier_bytes(self)


def _snapshot_of(plan: ConvPlan) -> tuple:
    """What a snapshot keeps of a plan: the search results (the plan
    without its tile streams) and the ``(bm, bo)`` its tiles were built at
    (None: built without tiles). The tiles hold several times the kmap's
    bytes and :func:`_plan_from` rebuilds them from it, bit for bit."""
    t = plan.tiles
    return plan._replace(tiles=None), None if t is None else (t.bm, t.bo)


def _plan_from(snap: tuple) -> ConvPlan:
    """The plan of a :func:`_snapshot_of` tuple, its tiles rebuilt on the
    kmap's device."""
    plan, tiles_at = snap
    if tiles_at is None:
        return plan
    bm, bo = tiles_at
    return plan._replace(tiles=sg_ops.build_tap_tiles(plan.kmap, bm=bm,
                                                      bo=bo))


class _Entry(NamedTuple):
    """One canonical cache entry: the plan and the anchored key tensors of
    every identity alias pointing at it."""

    plan: ConvPlan
    aliases: OrderedDict        # identity key -> anchored tensor tuple
    fingerprint: tuple | None   # content key words, None: identity only


#: identity aliases kept per canonical entry before the oldest is dropped
#: (a loop over re-allocated clouds would otherwise anchor every step's
#: tensors for as long as the entry lives)
ALIAS_CAP = 8


def _content_enabled() -> bool:
    """``REPRO_PLANCACHE_CONTENT`` (``runtime/flags.py``): ``"0"`` turns
    content keys off process-wide; read when a cache is built."""
    return os.environ.get("REPRO_PLANCACHE_CONTENT", "1") != "0"


class PlanCache:
    """Content-addressed FIFO memo of ConvPlans with an identity fast path.

    One instance per forward, or longer-lived for a serving engine or a
    training loop, where the content keys make re-allocated identical
    clouds hit.

    Args:
      capacity: canonical entries kept (FIFO eviction).
      content: key identity misses by content (False: identity keys
        only, and no pinned tables; None: ``REPRO_PLANCACHE_CONTENT``,
        on unless it is ``"0"``).
      verify: on every content hit, compare the key tensors element-wise
        with an anchored alias's; a mismatch counts as a ``collision`` and
        rebuilds instead of serving a stale plan. Pinned tables are then
        anchored and verified too.
      pinned: the :class:`~repro_torch.runtime.feature_cache.PinnedStore`
        of the pinned tier (None: the process-wide store).
      persist: a :class:`~repro_torch.runtime.persist.SnapshotStore` that
        makes the content tier durable: a content miss reads through to
        disk before building (a verified plan on disk costs no map
        search), and every content-keyed build writes through. A snapshot
        holds the plan without its tile streams, which a read rebuilds
        from the kmap. Identity entries are never persisted: an id means
        nothing in another process.

    Counters: ``hits`` (total), ``id_hits``, ``content_hits``,
    ``persist_hits``, ``misses``, ``collisions``, and the pinned store's
    (see :meth:`stats`).
    """

    def __init__(self, capacity: int = 64, *, content: bool | None = None,
                 verify: bool = False,
                 pinned: feature_cache.PinnedStore | None = None,
                 persist=None):
        self.capacity = capacity
        self.content = _content_enabled() if content is None else content
        self.verify = verify
        self.pinned = pinned if pinned is not None \
            else feature_cache.default_store()
        self.persist = persist
        self._entries: OrderedDict = OrderedDict()  # canonical key -> _Entry
        self._by_id: dict = {}                      # identity key -> canonical
        self.hits = 0
        self.id_hits = 0
        self.content_hits = 0
        self.persist_hits = 0
        self.misses = 0
        self.collisions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        return {"entries": len(self), "hits": self.hits,
                "id_hits": self.id_hits, "content_hits": self.content_hits,
                "persist_hits": self.persist_hits,
                "misses": self.misses, "collisions": self.collisions,
                "pinned": self.pinned.stats()}

    def save(self, persist=None) -> int:
        """Write every content-keyed entry to the snapshot store (``persist``
        or the cache's own); returns the number committed."""
        store = persist if persist is not None else self.persist
        if store is None:
            return 0
        n = 0
        for ckey, entry in self._entries.items():
            if entry.fingerprint is None:
                continue
            fp, statics = ckey
            if store.put(("plan", fp, statics), _snapshot_of(entry.plan)):
                n += 1
        return n

    def load(self, persist=None) -> int:
        """Read every verified plan of the snapshot store into the content
        tier, its tensors on the store's device; returns the number
        loaded. Corrupt or stale files are dropped by the store
        (``persist.dropped``). A loaded plan has no identity alias yet:
        its first lookup hits by content, with no map search."""
        store = persist if persist is not None else self.persist
        if store is None:
            return 0
        n = 0
        for key, value in store.items():
            if not (isinstance(key, tuple) and len(key) == 3
                    and key[0] == "plan"):
                continue
            ckey = (key[1], key[2])
            if ckey in self._entries:
                continue
            self._evict_to_capacity()
            self._entries[ckey] = _Entry(_plan_from(value), OrderedDict(),
                                         key[1])
            n += 1
        return n

    def _evict_to_capacity(self) -> None:
        while len(self._entries) >= self.capacity:
            _, entry = self._entries.popitem(last=False)
            for idkey in entry.aliases:
                self._by_id.pop(idkey, None)

    def _alias(self, canonical, idkey, arrays) -> None:
        entry = self._entries[canonical]
        if idkey in entry.aliases:
            return
        entry.aliases[idkey] = tuple(arrays)
        self._by_id[idkey] = canonical
        while len(entry.aliases) > ALIAS_CAP:
            old, _ = entry.aliases.popitem(last=False)
            self._by_id.pop(old, None)

    @staticmethod
    def _verify_hit(entry: _Entry, arrays) -> bool | None:
        """Compare ``arrays`` element-wise with the entry's newest anchored
        alias; None when it has none (a plan read from disk), and the
        caller then rebuilds rather than serve it unverified."""
        if not entry.aliases:
            return None
        anchored = next(reversed(entry.aliases.values()))
        return all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
                   for a, b in zip(anchored, arrays))

    def lookup(self, arrays, statics, build, content_key=None):
        """Memoized plan for ``(arrays, statics)`` under the active mesh
        (its :func:`~repro_torch.runtime.sharding.mesh_fingerprint` joins
        the statics); ``build(fp)`` on a miss.

        On an identity miss the content key ``fp`` is ``content_key()`` if
        given (a key the caller derives for tensors whose content it
        knows), else :func:`content_fingerprint` of ``arrays`` (one host
        sync); None with ``content=False``. The builder gets the same
        ``fp``, so that it can key its pinned structures by it."""
        statics = tuple(statics) + sharding.mesh_fingerprint()
        idkey = (tuple(id(a) for a in arrays), statics)
        canonical = self._by_id.get(idkey)
        if canonical is not None and canonical in self._entries:
            self.hits += 1
            self.id_hits += 1
            return self._entries[canonical].plan

        if not self.content:
            fp = None
        else:
            fp = content_key() if content_key is not None \
                else content_fingerprint(arrays)
        if fp is not None:
            ckey = (fp, statics)
            entry = self._entries.get(ckey)
            if entry is not None:
                ok = self._verify_hit(entry, arrays) if self.verify \
                    else True
                if ok:
                    self.hits += 1
                    self.content_hits += 1
                    self._alias(ckey, idkey, arrays)
                    return entry.plan
                if ok is False:
                    self.collisions += 1
                # a collision, or unverifiable: rebuild, the latest wins
                self._entries.pop(ckey)
                for ik in entry.aliases:
                    self._by_id.pop(ik, None)
        else:
            ckey = idkey                           # identity-only entry

        snap = None
        if fp is not None and self.persist is not None:
            # durable read-through: a verified plan on disk costs no search
            snap = self.persist.get(("plan", fp, statics),
                                    device=getattr(arrays[0], "device",
                                                   None))
        if snap is not None:
            self.hits += 1
            self.persist_hits += 1
            plan = _plan_from(snap)
        else:
            self.misses += 1
            plan = build(fp)
            if fp is not None and self.persist is not None:
                self.persist.put(("plan", fp, statics), _snapshot_of(plan))
        self._evict_to_capacity()
        self._entries[ckey] = _Entry(plan, OrderedDict(), fp)
        self._alias(ckey, idkey, arrays)
        return plan


def _maybe_cached(cache: PlanCache | None, arrays, statics, build,
                  content_key=None):
    if cache is None:
        return build(None)
    return cache.lookup(arrays, statics, build, content_key)


def _require_block_capacity(n_blocks: torch.Tensor, max_blocks: int) -> None:
    """Raise instead of silently dropping voxels when the scene occupies
    more 16^3 blocks than the directory holds (one host read)."""
    needed = int(n_blocks)
    if needed > max_blocks:
        raise CapacityOverflow(
            "block_table",
            f"octree block table overflow: the scene occupies {needed} 16^3 "
            f"blocks but max_blocks={max_blocks}; voxels in the dropped "
            f"blocks would silently lose their maps — raise max_blocks",
            needed=needed, capacity=max_blocks)


def _require_out_capacity(overflow: torch.Tensor, n_true: torch.Tensor,
                          budget: int) -> None:
    """Raise instead of silently truncating when the Gconv3 candidates
    reach more output sites than the budget holds (one host read)."""
    if bool(overflow):
        needed = int(n_true)
        raise CapacityOverflow(
            "candidates",
            f"gconv3 candidate budget overflow: the cloud produces {needed} "
            f"downsampled output sites but out_budget={budget}; the "
            f"overflowing sites would silently lose their maps — raise "
            f"out_budget (or wrap the build in runtime.guard.with_replan)",
            needed=needed, capacity=budget)


class SubmWarmStart(NamedTuple):
    """Warm start of :func:`subm3_plan` from the previous frame.

    ``patch()`` gives ``(kmap, table)`` for the new frame's coordinates by
    updating the previous frame's structures (``core.stream``: the table
    splice and the dirty rows' re-search), bit-equal to a build from
    scratch over the same tensors. It runs only on a cache miss: a frame
    whose content repeats hits, and is neither searched nor patched.
    """

    patch: object   # () -> (kmap (N, 27) int32, octent ops.QueryTable)


def subm3_plan(coords, batch, valid, *, max_blocks: int,
               method: str = "octree", grid_bits: int = 7,
               batch_bits: int = 4, bm: int = 128, bo: int | None = None,
               search_impl: str | None = None,
               cache: PlanCache | None = None,
               content_key=None,
               warm: SubmWarmStart | None = None) -> ConvPlan:
    """Submanifold 3x3x3 plan: outputs == inputs, 27 taps.

    ``method``: ``"octree"`` searches by OCTENT through ``search_impl``:
    ``"kernel"`` (the CUDA query kernel on a card), ``"ref"`` (its plain
    version), ``"dense"`` (the dense-table baseline,
    ``core.mapsearch.build_block_table``) or ``"sharded"`` (the table
    partitioned over the active mesh, ``kernels/octent/sharded.py``);
    None resolves through ``octent.ops.search_impl()``, which picks
    ``"sharded"`` under a mesh that splits the block-key axes and
    ``"kernel"`` otherwise. It raises
    :class:`CapacityOverflow` when the scene occupies more than
    ``max_blocks`` blocks. ``"sorted"`` searches the sorted composite keys
    (``core.mapsearch.build_kmap_sorted``, no table, ``search_impl`` not
    used) and raises ValueError where the key does not fit int32.
    ``content_key`` stands in for the key tensors' fingerprint
    (:meth:`PlanCache.lookup`).

    With a content-keyed ``cache``, the stage-1 table of ``"kernel"`` and
    ``"ref"`` is pinned in ``cache.pinned`` under ``("qtable",
    fingerprint, max_blocks, grid_bits, batch_bits, mesh fingerprint)``:
    a build that finds it there runs the query only, and still counts one
    map search.
    ``warm`` (consulted on a cache miss only, and not part of the key: its
    plan is bit-equal to the scratch plan) builds the plan from
    ``warm.patch()`` instead, counted in ``DELTA_PATCHES``, not as a
    search.
    """
    if method not in ("octree", "sorted"):
        raise ValueError(f"unknown map search method {method!r}")
    simpl = (search_impl or oct_ops.search_impl()) \
        if method == "octree" else None
    statics = ("subm3", max_blocks, method, simpl, grid_bits, batch_bits,
               bm, bo)
    tabled = simpl in ("kernel", "ref")
    store = cache.pinned if cache is not None and tabled else None

    def search_sorted():
        MAPSEARCH_CALLS[0] += 1
        if not mapsearch.sorted_key_fits(grid_bits, batch_bits):
            bits = 3 * grid_bits + batch_bits + morton.LOCAL_CODE_BITS
            raise ValueError(
                f"map search method 'sorted' needs the composite key "
                f"(3*grid_bits + batch_bits + {morton.LOCAL_CODE_BITS}) to "
                f"fit int32, got grid_bits={grid_bits}, "
                f"batch_bits={batch_bits} -> {bits} bits. Pass grid_bits "
                f"<= {(31 - batch_bits - morton.LOCAL_CODE_BITS) // 3} or "
                f"use method='octree' for large grids.")
        offs = torch.as_tensor(morton.subm3_offsets(), device=coords.device)
        return mapsearch.build_kmap_sorted(coords, batch, valid, offs,
                                           grid_bits=grid_bits,
                                           batch_bits=batch_bits)

    def search_octree(fp):
        # anchors cost device memory against the store's budget, so only
        # verifying caches keep them
        verify = cache is not None and cache.verify
        anchor = (coords, batch, valid) if verify else None
        table = pin_key = None
        if fp is not None and store is not None:
            pin_key = ("qtable", fp, max_blocks, grid_bits, batch_bits,
                       sharding.mesh_fingerprint())
            table = store.get(pin_key, anchor=anchor, verify=verify,
                              device=coords.device)
        if warm is not None and tabled:
            DELTA_PATCHES[0] += 1
            kmap, table = warm.patch()
            _require_block_capacity(table.n_blocks, max_blocks)
            if pin_key is not None:
                store.put(pin_key, table, anchor=anchor)
            return kmap
        MAPSEARCH_CALLS[0] += 1
        if table is None and tabled:
            table = oct_ops.build_query_table(
                coords, batch, valid, max_blocks=max_blocks,
                grid_bits=grid_bits, batch_bits=batch_bits)
            if pin_key is not None:
                store.put(pin_key, table, anchor=anchor)
        kmap, n_blocks = oct_ops.build_kmap(
            coords, batch, valid, max_blocks=max_blocks, grid_bits=grid_bits,
            batch_bits=batch_bits, impl=simpl, table=table)
        _require_block_capacity(n_blocks, max_blocks)
        return kmap

    def build(fp):
        fault.check("plan")
        kmap = search_sorted() if method == "sorted" else search_octree(fp)
        tiles = sg_ops.build_tap_tiles(kmap, bm=bm, bo=bo)
        return ConvPlan("subm3", kmap, tiles, coords.shape[0], 27,
                        None, None, None, None)

    return _maybe_cached(cache, (coords, batch, valid), statics, build,
                         content_key)


def gconv2_plan(coords, batch, valid, *, grid_bits: int = 7,
                batch_bits: int = 4, bm: int = 128, bo: int | None = None,
                cache: PlanCache | None = None,
                content_key=None) -> ConvPlan:
    """Gconv2 (k=2, s=2) plan: octant taps to octree parents. Carries the
    downsampled ``out_*`` coordinate set and the scatter-form ``maps`` the
    paired Tconv2 reuses."""
    statics = ("gconv2", grid_bits, batch_bits, bm, bo)

    def build(_fp):
        fault.check("plan")
        MAPSEARCH_CALLS[0] += 1
        maps = mapsearch.build_maps_gconv2(coords, batch, valid,
                                           grid_bits=grid_bits,
                                           batch_bits=batch_bits)
        n = coords.shape[0]
        kmap = mapsearch.strided_to_kmap(maps, n_out=n, n_taps=8)
        tiles = sg_ops.build_tap_tiles(kmap, bm=bm, bo=bo)
        return ConvPlan("gconv2", kmap, tiles, n, 8, maps.out_coords,
                        maps.out_batch, maps.out_valid, maps)

    return _maybe_cached(cache, (coords, batch, valid), statics, build,
                         content_key)


def gconv3_plan(coords, batch, valid, *, grid_bits: int = 7,
                batch_bits: int = 4, out_budget: int | None = None,
                bm: int = 128, bo: int | None = None, with_tiles: bool = True,
                cache: PlanCache | None = None,
                content_key=None) -> ConvPlan:
    """Gconv3 (k=3, s=2) plan with ``out_budget`` output rows (None: the
    input rows). Carries the scatter maps, so the input-stationary
    dataflow executes from the same plan; ``with_tiles=False`` skips the
    tile build it does not need. Both are statics of the cache key. Counts
    one map search per build, one that overflows included, and raises
    :class:`CapacityOverflow` when the cloud has more output sites than
    the budget."""
    budget = out_budget if out_budget is not None else coords.shape[0]
    statics = ("gconv3", grid_bits, batch_bits, budget, bm, bo, with_tiles)

    def build(_fp):
        fault.check("plan")
        MAPSEARCH_CALLS[0] += 1
        maps = mapsearch.build_maps_gconv3(coords, batch, valid,
                                           grid_bits=grid_bits,
                                           batch_bits=batch_bits,
                                           out_budget=budget)
        _require_out_capacity(maps.overflow, maps.n_true, budget)
        kmap = mapsearch.strided_to_kmap(maps, n_out=budget, n_taps=27)
        tiles = sg_ops.build_tap_tiles(kmap, bm=bm, bo=bo) \
            if with_tiles else None
        return ConvPlan("gconv3", kmap, tiles, budget, 27, maps.out_coords,
                        maps.out_batch, maps.out_valid, maps)

    return _maybe_cached(cache, (coords, batch, valid), statics, build,
                         content_key)


def tconv2_plan(gconv2_maps: StridedMaps, target_coords, target_batch,
                target_valid, *, bm: int = 128, bo: int | None = None,
                cache: PlanCache | None = None,
                content_key=None) -> ConvPlan:
    """Tconv2 plan: transposes the paired Gconv2 maps (map reuse, so this
    never counts as a map search)."""
    statics = ("tconv2", bm, bo)

    def build(_fp):
        maps = mapsearch.transpose_maps(gconv2_maps, target_coords,
                                        target_batch, target_valid)
        n = target_valid.shape[0]
        kmap = mapsearch.strided_to_kmap(maps, n_out=n, n_taps=8)
        tiles = sg_ops.build_tap_tiles(kmap, bm=bm, bo=bo)
        return ConvPlan("tconv2", kmap, tiles, n, 8, target_coords,
                        target_batch, target_valid, maps)

    keys = (gconv2_maps.in_idx, gconv2_maps.out_idx, gconv2_maps.tap,
            gconv2_maps.mvalid, target_coords, target_batch, target_valid)
    return _maybe_cached(cache, keys, statics, build, content_key)


def execute(plan: ConvPlan, feats: torch.Tensor, weights: torch.Tensor,
            bias: torch.Tensor | None = None, *, spac: bool = True,
            act: sparsity.ActSparsity | None = None,
            epilogue: sg_ops.FusedEpilogue | None = None,
            impl: str | None = None):
    """Run the rulebook of ``plan`` over the current features.

    ``spac`` refreshes tile liveness from the features (or from ``act``,
    the previous layer's epilogue-emitted masks). ``epilogue`` fuses
    BN-inference + ReLU and changes the return value to
    ``(out, ActSparsity)``.

    impl: None / ``"kernel"`` / ``"ref"`` as in ``sg_ops.apply_tiles``;
    ``"scan"`` is the plain PyTorch tap scan over ``plan.kmap``
    (``rulebook.apply_kmap_gather``), the oracle the reference calls
    ``impl="xla"``. On the scan, SPAC elides maps in the forward and the
    backward differentiates the un-elided maps, and the epilogue runs
    after the scan (``sg_ops.apply_epilogue``).
    """
    if impl == "scan":
        if spac:
            row_nz = act.row_nz if act is not None \
                else sparsity.row_nonzero(feats)
            out = rulebook.apply_kmap_gather_spac(feats, weights, plan.kmap,
                                                  row_nz)
        else:
            out = rulebook.apply_kmap_gather(feats, weights, plan.kmap)
        if epilogue is not None:
            if bias is not None:
                raise ValueError(
                    "bias and epilogue together would apply the bias twice:"
                    " fold it into the epilogue shift")
            return sg_ops.apply_epilogue(out, epilogue)
        return out + bias if bias is not None else out
    if plan.tiles is None:
        raise ValueError(
            f"{plan.kind} plan was built with with_tiles=False (input-"
            f"stationary dataflow); rebuild it with tiles to execute the "
            f"fused path, or pass impl='scan'")
    row_nz = None
    if spac and act is None:
        row_nz = sparsity.row_nonzero(feats)
    return sg_ops.apply_tiles(feats, weights, plan.tiles, bias,
                              n_out=plan.n_out, row_nz=row_nz,
                              act=act if spac else None, epilogue=epilogue,
                              impl=impl)
