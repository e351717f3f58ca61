"""The pinned tier: small, geometry-only search structures kept on device.

SpOctA's caching is non-uniform: the small, high-reuse mapping structures
stay resident while the bulk feature stream does not. For the plan layer
that means the OCTENT stage-1 :class:`~repro_torch.kernels.octent.ops.
QueryTable` (the block directory and the compacted table, a few hundred
KiB at a 65,536-row bucket) outlives the count-bounded
:class:`~repro_torch.core.plan.PlanCache`: a plan rebuilt after eviction,
or a streaming frame's level, fetches its table instead of rebuilding it.

"Pinned" means a strong reference to a tensor on its device: holding it
keeps the buffer alive, dropping the last reference frees it. The
:class:`PinnedStore` is that reference, bounded in bytes, keyed by content
and evicting in insertion order; :func:`default_store` is one store shared
by every PlanCache that brings none. With a
:class:`~repro_torch.runtime.persist.SnapshotStore` attached
(``persist=``) the tier is durable: pins write through to disk, and a
memory miss reads through before reporting cold.

:func:`classify` and :func:`plan_tier_bytes` are the tier policy by field
name (``ConvPlan.residency`` reads it): the search structure and the
per-tile metadata are pinned, the kmap and the slot streams cached with
their plan, features, weights and biases streamed.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

#: tier names, in decreasing residency priority
TIER_PINNED = "pinned"
TIER_CACHED = "cached"
TIER_STREAM = "stream"

#: the fields of the pinned and stream tiers; every other field of a plan
#: (the kmap, the slot streams, the strided maps) is cached-tier
_PINNED_FIELDS = frozenset({
    # the octree search structure (kernels/octent ops.QueryTable)
    "ublocks", "tkey", "tval", "n_blocks",
    # per-tile metadata (kernels/spconv_gemm ops.TapTiles)
    "tile_tap", "tile_nz", "tile_ob", "tile_first", "tile_run",
    "grp_skip", "grp_contig",
})
_STREAM_FIELDS = frozenset({"feats", "weights", "bias"})


def classify(name: str) -> str:
    """Tier of a named plan component (a field of ConvPlan, TapTiles,
    StridedMaps or QueryTable) or runtime operand (``feats``,
    ``weights``, ``bias``): :data:`TIER_PINNED`, :data:`TIER_CACHED` or
    :data:`TIER_STREAM`."""
    if name in _PINNED_FIELDS:
        return TIER_PINNED
    if name in _STREAM_FIELDS:
        return TIER_STREAM
    return TIER_CACHED


def plan_tier_bytes(plan, table=None) -> dict:
    """Bytes per caching tier of one plan and, with ``table`` (its
    :class:`~repro_torch.kernels.octent.ops.QueryTable`), its search
    structure: ``{"pinned": int, "cached": int, "stream": int}``.

    The plan's NamedTuple fields are walked, nested NamedTuples (TapTiles,
    StridedMaps, QueryTable) one level down, and each tensor counts
    ``numel() * element_size()`` bytes in its field's tier. The stream
    tier is always 0: features never live on a plan.
    """
    out = {TIER_PINNED: 0, TIER_CACHED: 0, TIER_STREAM: 0}

    def visit(name, value):
        if hasattr(value, "_fields"):
            for n in value._fields:
                visit(n, getattr(value, n))
        elif isinstance(value, torch.Tensor):
            out[classify(name)] += value.numel() * value.element_size()

    visit("plan", plan)
    if table is not None:
        visit("table", table)
    return out


def nbytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree`` (tuples, lists, dicts and
    NamedTuples are walked; None and non-tensor leaves count 0)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(nbytes(v) for v in tree)
    return 0


def _anchors_match(anchored, arrays) -> bool | None:
    """Element-wise compare an anchored tensor tuple with ``arrays``; None
    when the entry was pinned without an anchor (unverifiable)."""
    if anchored is None:
        return None
    return all(torch.equal(a, torch.as_tensor(b, device=a.device))
               for a, b in zip(anchored, arrays))


class PinnedStore:
    """Byte-bounded, content-keyed store of pinned device tensors.

    One entry per key (``core.plan.subm3_plan`` uses ``("qtable",
    fingerprint, max_blocks, grid_bits, batch_bits)``); the value is any
    tree of tensors. When ``put`` would exceed ``capacity_bytes``, entries
    go in insertion order; a value larger than the whole budget is not
    stored.

    ``put`` takes the key's source tensors as an ``anchor`` and ``get(...,
    verify=True)`` compares them element-wise before serving: a mismatch
    is a fingerprint collision (counted, the entry dropped, None
    returned), and an anchorless entry is dropped for a verifying reader
    too. Anchors count against the budget, since the store's reference
    may be all that keeps them alive.

    Refcounted holds: a streaming session refetches its per-level tables
    every frame, so byte pressure must not evict them mid-sequence.
    :meth:`acquire` marks a key as held (before or after its first
    ``put``); eviction skips held entries and, when everything resident is
    held, admits over budget (counted in ``evictions_skipped``);
    :meth:`release` returns the entry to insertion-order eviction.

    Durability (``persist=``): a pin writes through to the snapshot store
    under ``("pinned", key)``, and a non-verifying reader's memory miss
    reads through (``persist_hits``) and re-pins. Anchors are not
    persisted, so an entry read from disk is anchorless: a verifying
    reader neither reads through nor uses such an entry, and rebuilds.
    """

    def __init__(self, capacity_bytes: int = 32 * 2 ** 20, *, persist=None):
        self.capacity_bytes = capacity_bytes
        self.persist = persist
        # key -> (value, bytes, anchor tensors | None)
        self._entries: OrderedDict = OrderedDict()
        self._refs: dict = {}                # key -> holds
        self.hits = 0
        self.misses = 0
        self.persist_hits = 0
        self.evictions = 0
        self.evictions_skipped = 0
        self.collisions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def resident_bytes(self) -> int:
        """Bytes the store pins: values and their anchors."""
        return sum(e[1] for e in self._entries.values())

    def get(self, key, anchor=None, verify: bool = False, *, device=None):
        """The pinned value of ``key``, or None (a hit or a miss). A value
        read through from disk lands on ``device`` (None: the store's)."""
        entry = self._entries.get(key)
        if entry is None and self.persist is not None and not verify:
            value = self.persist.get(("pinned", key), device=device)
            if value is not None:
                self.persist_hits += 1
                self.hits += 1
                self.put(key, value, _writethrough=False)
                return value
        if entry is None:
            self.misses += 1
            return None
        if verify and anchor is not None:
            ok = _anchors_match(entry[2], anchor)
            if ok is not True:
                if ok is False:
                    self.collisions += 1
                    from repro_torch.runtime import guard
                    guard.health().note("pinned.collision")
                del self._entries[key]    # collision or unverifiable:
                self.misses += 1          # the caller rebuilds
                return None
        self.hits += 1
        return entry[0]

    def put(self, key, value, anchor=None, *, _writethrough=True) -> None:
        """Pin ``value`` under ``key``, evicting in insertion order to fit.
        A key already present keeps its value and moves to the back. With a
        snapshot store the pin writes through (anchorless);
        ``_writethrough=False`` is the read-through path, which must not
        echo disk back to disk."""
        size = nbytes(value) + nbytes(anchor)
        if size > self.capacity_bytes:
            return
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        while self._entries and \
                self.resident_bytes() + size > self.capacity_bytes:
            victim = next((k for k in self._entries
                           if self._refs.get(k, 0) == 0), None)
            if victim is None:
                # every resident entry is held: admit over budget rather
                # than drop a table a stream will refetch
                self.evictions_skipped += 1
                break
            del self._entries[victim]
            self.evictions += 1
        self._entries[key] = (value, size,
                              tuple(anchor) if anchor is not None else None)
        if self.persist is not None and _writethrough:
            self.persist.put(("pinned", key), value)

    def acquire(self, key) -> None:
        """Hold ``key``: eviction skips it until every holder releases."""
        self._refs[key] = self._refs.get(key, 0) + 1

    def release(self, key) -> None:
        """Drop one hold on ``key`` (a no-op on an unheld key)."""
        c = self._refs.get(key, 0) - 1
        if c <= 0:
            self._refs.pop(key, None)
        else:
            self._refs[key] = c

    def refcount(self, key) -> int:
        """Holds on ``key`` (0 when unheld)."""
        return self._refs.get(key, 0)

    def clear(self) -> None:
        self._entries.clear()

    def save(self, persist=None) -> int:
        """Write every pinned entry to the snapshot store (anchorless);
        returns the number committed."""
        store = persist if persist is not None else self.persist
        if store is None:
            return 0
        return sum(bool(store.put(("pinned", key), value))
                   for key, (value, _, _) in self._entries.items())

    def load(self, persist=None) -> int:
        """Pin every verified search structure of the snapshot store, its
        tensors on the store's device; returns the number loaded. Corrupt or stale files are dropped by the store
        (``persist.dropped``)."""
        store = persist if persist is not None else self.persist
        if store is None:
            return 0
        n = 0
        for pkey, value in store.items():
            if not (isinstance(pkey, tuple) and len(pkey) == 2
                    and pkey[0] == "pinned") or pkey[1] in self._entries:
                continue
            self.put(pkey[1], value, _writethrough=False)
            n += 1
        return n

    def stats(self) -> dict:
        return {"entries": len(self),
                "resident_bytes": self.resident_bytes(),
                "hits": self.hits, "misses": self.misses,
                "persist_hits": self.persist_hits,
                "evictions": self.evictions,
                "evictions_skipped": self.evictions_skipped,
                "held": len(self._refs), "collisions": self.collisions}


_DEFAULT_STORE = PinnedStore()


def default_store() -> PinnedStore:
    """The process-wide store of every PlanCache that brings none, so that
    short-lived caches share one resident copy of each search structure."""
    return _DEFAULT_STORE
