"""Execution plans: memoized map search + tiling for rulebook execution.

A :class:`ConvPlan` bundles everything about a convolution that depends
only on geometry — the kernel map and its tap-scheduled tile streams — and
a :class:`PlanCache` memoizes plans per coordinate set, so B stacked Subm3
blocks pay for OCTENT once, and a MinkUNet decoder stage reuses the
encoder plan at its resolution. SPAC liveness depends on the current
features and is refreshed per layer at execution time.

The cache is keyed by the identity of the coordinate tensors plus the
static search parameters; entries hold their key tensors so an id cannot
be recycled while the entry lives. ``MAPSEARCH_CALLS`` counts actual map
searches, so callers can check that a forward searches 2E+1 times.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import torch

from repro_torch.core import mapsearch, rulebook, sparsity
from repro_torch.core.mapsearch import StridedMaps
from repro_torch.kernels.octent import ops as oct_ops
from repro_torch.kernels.spconv_gemm import ops as sg_ops

MAPSEARCH_CALLS = [0]


def mapsearch_call_count() -> int:
    """Map-search invocations since the last reset."""
    return MAPSEARCH_CALLS[0]


def reset_mapsearch_counter() -> None:
    MAPSEARCH_CALLS[0] = 0


class CapacityOverflow(RuntimeError):
    """A static capacity (the octree directory) is smaller than the scene
    needs; the search would silently drop voxels, so it raises instead."""

    def __init__(self, what: str, msg: str, *, needed: int, capacity: int):
        super().__init__(msg)
        self.what = what
        self.needed = needed
        self.capacity = capacity


class ConvPlan(NamedTuple):
    """Geometry-only execution plan for one SpConv layer.

    ``out_*`` are None for coordinate-preserving layers (outputs ==
    inputs); ``maps`` carries the scatter-form triples of strided layers so
    Tconv2 can reuse them.
    """

    kind: str                      # subm3 | gconv2 | tconv2
    kmap: torch.Tensor             # (N_out, K) int32
    tiles: sg_ops.TapTiles
    n_out: int                     # static output row budget
    n_taps: int
    out_coords: torch.Tensor | None
    out_batch: torch.Tensor | None
    out_valid: torch.Tensor | None
    maps: StridedMaps | None


class PlanCache:
    """Identity-keyed FIFO memo of ConvPlans.

    One instance per forward, or longer-lived for a serving loop. Counters:
    ``hits`` and ``misses`` (see :meth:`stats`).
    """

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._entries: OrderedDict = OrderedDict()  # key -> (plan, anchors)
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        return {"entries": len(self), "hits": self.hits,
                "misses": self.misses}

    def lookup(self, arrays, statics, build):
        """Memoized plan for ``(arrays, statics)``; ``build()`` on a miss."""
        key = (tuple(id(a) for a in arrays), tuple(statics))
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            return entry[0]
        self.misses += 1
        plan = build()
        while len(self._entries) >= self.capacity:
            self._entries.popitem(last=False)
        self._entries[key] = (plan, tuple(arrays))
        return plan


def _maybe_cached(cache: PlanCache | None, arrays, statics, build):
    if cache is None:
        return build()
    return cache.lookup(arrays, statics, build)


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


def subm3_plan(coords, batch, valid, *, max_blocks: int, grid_bits: int = 7,
               batch_bits: int = 4, bm: int = 128, bo: int | None = None,
               search_impl: str | None = None,
               cache: PlanCache | None = None) -> ConvPlan:
    """Submanifold 3x3x3 plan by OCTENT search: outputs == inputs, 27 taps.

    ``search_impl``: None / ``"kernel"`` (the CUDA query kernel on a card)
    or ``"ref"`` (its plain version). Raises :class:`CapacityOverflow` when
    the scene occupies more than ``max_blocks`` blocks.
    """
    simpl = search_impl or "kernel"
    statics = ("subm3", max_blocks, simpl, grid_bits, batch_bits, bm, bo)

    def build():
        MAPSEARCH_CALLS[0] += 1
        kmap, n_blocks = oct_ops.build_kmap(
            coords, batch, valid, max_blocks=max_blocks, grid_bits=grid_bits,
            batch_bits=batch_bits, impl=simpl)
        _require_block_capacity(n_blocks, max_blocks)
        tiles = sg_ops.build_tap_tiles(kmap, bm=bm, bo=bo)
        return ConvPlan("subm3", kmap, tiles, coords.shape[0], 27,
                        None, None, None, None)

    return _maybe_cached(cache, (coords, batch, valid), statics, build)


def gconv2_plan(coords, batch, valid, *, grid_bits: int = 7,
                batch_bits: int = 4, bm: int = 128, bo: int | None = None,
                cache: PlanCache | None = None) -> ConvPlan:
    """Gconv2 (k=2, s=2) plan: octant taps to octree parents. Carries the
    downsampled ``out_*`` coordinate set and the scatter-form ``maps`` the
    paired Tconv2 reuses."""
    statics = ("gconv2", grid_bits, batch_bits, bm, bo)

    def build():
        MAPSEARCH_CALLS[0] += 1
        maps = mapsearch.build_maps_gconv2(coords, batch, valid,
                                           grid_bits=grid_bits,
                                           batch_bits=batch_bits)
        n = coords.shape[0]
        kmap = mapsearch.strided_to_kmap(maps, n_out=n, n_taps=8)
        tiles = sg_ops.build_tap_tiles(kmap, bm=bm, bo=bo)
        return ConvPlan("gconv2", kmap, tiles, n, 8, maps.out_coords,
                        maps.out_batch, maps.out_valid, maps)

    return _maybe_cached(cache, (coords, batch, valid), statics, build)


def tconv2_plan(gconv2_maps: StridedMaps, target_coords, target_batch,
                target_valid, *, bm: int = 128, bo: int | None = None,
                cache: PlanCache | None = None) -> ConvPlan:
    """Tconv2 plan: transposes the paired Gconv2 maps (map reuse, so this
    never counts as a map search)."""
    statics = ("tconv2", bm, bo)

    def build():
        maps = mapsearch.transpose_maps(gconv2_maps, target_coords,
                                        target_batch, target_valid)
        n = target_valid.shape[0]
        kmap = mapsearch.strided_to_kmap(maps, n_out=n, n_taps=8)
        tiles = sg_ops.build_tap_tiles(kmap, bm=bm, bo=bo)
        return ConvPlan("tconv2", kmap, tiles, n, 8, target_coords,
                        target_batch, target_valid, maps)

    keys = (gconv2_maps.in_idx, gconv2_maps.out_idx, gconv2_maps.tap,
            gconv2_maps.mvalid, target_coords, target_batch, target_valid)
    return _maybe_cached(cache, keys, statics, build)


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
    row_nz = None
    if spac and act is None:
        row_nz = sparsity.row_nonzero(feats)
    return sg_ops.apply_tiles(feats, weights, plan.tiles, bias,
                              n_out=plan.n_out, row_nz=row_nz,
                              act=act if spac else None, epilogue=epilogue,
                              impl=impl)
