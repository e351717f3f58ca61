"""Fixed-order segment sums: the port's floating-point scatter-adds.

A segment sum adds the rows of an (n, C) value array into ``n_rows``
destination rows. ``index_add`` on a card adds a row's sources in no fixed
order, so a row with three or more sources can change its bits from one
run to the next. Here every destination row adds its sources in ascending
source order, starting from zero, on every device: the order of a
sequential loop, and the one the reference's scatters take
(``.at[].add`` in row order, or a ``lax.scan`` of per-tap scatters).

:func:`segments` builds the index of one sum (:class:`Segments`): the
sources sorted stably by destination and each row's offset into them,
computed on the device. :func:`ordered_sum` adds each row's sources in that
order through ``kernels/segment_sum``: on the card one launch of the
hand-written kernel, on the CPU its plain version, which adds one column
of a count-sorted, column-major layout at a time. Only a CPU index carries
that layout, built with one host read of its column sizes (two when a row
has more than :data:`GUESS` sources); an index on the card reads nothing
back, and neither do the sums and their backwards.

:func:`ordered_sum` is differentiable: its backward is the gather
``g[dst]``, which is exact since each source adds into one row.
:func:`ordered_gather` is its mirror, ``vals[idx]``, whose backward is the
ordered sum by ``idx``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.segment_sum import ref as _ref
from repro_torch.kernels.segment_sum.kernel import segment_sum

GUESS = _ref.GUESS


class Segments(NamedTuple):
    """The index of one fixed-order segment sum over ``n_rows`` rows."""
    key: torch.Tensor    # (n,) int64 destination of each source, n_rows
                         # where it is dropped
    src: torch.Tensor    # (n,) int64 the sources sorted stably by key:
                         # row r's are src[starts[r]:starts[r + 1]],
                         # ascending, the dropped ones last
    starts: torch.Tensor  # (n_rows + 1,) int64 each row's first slot
    # the plain version's column-major layout (``segment_sum/ref.py``
    # Layout), on a CPU index only; None on the card
    perm: torch.Tensor | None
    pos: torch.Tensor | None
    cols: tuple | None
    n_rows: int


def _index(dst: torch.Tensor, n_rows: int) -> tuple:
    """``(key, src, starts)`` of one sum, on ``dst``'s device: no host
    read."""
    dst = dst.long()
    key = torch.where((dst >= 0) & (dst < n_rows), dst, n_rows)
    srt = torch.sort(key, stable=True)
    starts = torch.searchsorted(
        srt.values, torch.arange(n_rows + 1, device=dst.device))
    return key, srt.indices, starts


def segments(*specs) -> list[Segments]:
    """The :class:`Segments` of each ``(dst, n_rows)`` in ``specs``.
    ``dst`` holds each source's destination row; sources outside
    ``[0, n_rows)`` are dropped. An index on the card reads nothing back
    to the host; the CPU ones get their column layouts with one host read
    for all of them (and one more for each whose widest row has more than
    :data:`GUESS` sources)."""
    idx = [_index(dst, n_rows) for dst, n_rows in specs]
    cpu = [i for i in idx if i[0].device.type == "cpu"]
    lays = iter(_ref.layouts(*cpu))
    return [Segments(*i, *(next(lays) if i[0].device.type == "cpu"
                           else (None, None, None)), n_rows)
            for i, (_, n_rows) in zip(idx, specs)]


class _OrderedSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, vals, seg):
        ctx.seg = seg
        return segment_sum(vals, seg)

    @staticmethod
    def backward(ctx, g):
        pad = torch.cat([g, g.new_zeros((1, *g.shape[1:]))])
        return pad.index_select(0, ctx.seg.key), None


class _OrderedGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, vals, idx, seg):
        ctx.seg = seg
        return vals.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        return segment_sum(g, ctx.seg), None, None


def ordered_sum(vals: torch.Tensor, seg: Segments) -> torch.Tensor:
    """``(n_rows, ...)``: row r adds ``vals[i]`` for every source i whose
    destination is r, in ascending i, from zero. ``seg`` is the
    :func:`segments` index of the n destinations of ``vals`` (n, ...).
    The backward is the gather ``g[dst]``, zero for dropped sources."""
    return _OrderedSum.apply(vals, seg)


def ordered_gather(vals: torch.Tensor, idx: torch.Tensor,
                   seg: Segments) -> torch.Tensor:
    """``vals[idx]``, whose backward adds each row's gradients in ascending
    position of ``idx``: ``seg`` is ``segments((idx, vals.shape[0]))``."""
    return _OrderedGather.apply(vals, idx, seg)
