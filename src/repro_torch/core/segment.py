"""Fixed-order segment sums: the port's floating-point scatter-adds.

A segment sum adds the rows of an (n, C) value array into ``n_rows``
destination rows. ``index_add`` on a card adds a row's sources in no fixed
order, so a row with three or more sources can change its bits from one
run to the next. Here every destination row adds its sources in ascending
source order, starting from zero, on every device: the order of a
sequential loop, and the one the reference's scatters take
(``.at[].add`` in row order, or a ``lax.scan`` of per-tap scatters).

:func:`segments` builds the index of one sum (:class:`Segments`): the
sources sorted stably by destination, and laid out column-major, with the
rows sorted by their source count, descending. Column j holds the j-th
source of every row that has more than j, those rows first, so a column
is one contiguous block and its add touches only the rows that have such
a source. :func:`ordered_sum` gathers the values into that layout once and
adds one column at a time: a row with L sources takes L adds, in order,
and a row with none is never touched. A table padded to the widest row
would make every column a pass over every row, and a BEV grid piles
thousands of clipped voxels onto one corner cell.

:func:`ordered_sum` is differentiable: its backward is the gather
``g[dst]``, which is exact since each source adds into one row.
:func:`ordered_gather` is its mirror, ``vals[idx]``, whose backward is the
ordered sum by ``idx``. An index is built with one host read of its
column sizes (two when a row has more than :data:`GUESS` sources); the
sums and their backwards read nothing back.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

#: column sizes read back with the widest row's count, in the index's one
#: read; a row with more sources takes a second read for the rest
GUESS = 32


class Segments(NamedTuple):
    """The index of one fixed-order segment sum over ``n_rows`` rows."""
    key: torch.Tensor    # (n,) int64 destination of each source, n_rows
                         # where it is dropped
    perm: torch.Tensor   # (n_kept,) int64 the source at each slot of the
                         # column-major layout
    pos: torch.Tensor    # (n_rows,) int64 each row's place in the
                         # count-descending row order
    cols: tuple          # host ints: the rows of each column, descending
    n_rows: int


class _Pending(NamedTuple):
    key: torch.Tensor
    dst: torch.Tensor    # (n,) sorted destinations
    src: torch.Tensor    # (n,) the source of each
    rank: torch.Tensor   # (n,) each source's place among its row's
    pos: torch.Tensor
    asc: torch.Tensor    # (n_rows,) the rows' source counts, ascending
    head: torch.Tensor   # (1 + GUESS,) widest count, first column sizes
    n_rows: int


def _col_sizes(asc, lo, hi):
    """Rows with more than j sources, for j in [lo, hi)."""
    j = torch.arange(lo, hi, device=asc.device)
    return asc.shape[0] - torch.searchsorted(asc, j, right=True)


def _prepare(dst: torch.Tensor, n_rows: int) -> _Pending:
    """Everything of the index that the device computes: no host read."""
    dev, n = dst.device, dst.shape[0]
    dst = dst.long()
    key = torch.where((dst >= 0) & (dst < n_rows), dst, n_rows)
    srt = torch.sort(key, stable=True)
    starts = torch.searchsorted(srt.values,
                                torch.arange(n_rows + 1, device=dev))
    rank = torch.arange(n, device=dev) - starts[srt.values]
    desc = torch.sort(starts[1:] - starts[:-1], descending=True, stable=True)
    pos = torch.empty_like(desc.indices)
    pos[desc.indices] = torch.arange(n_rows, device=dev)
    asc = desc.values.flip(0)
    widest = desc.values[:1] if n_rows else torch.zeros(
        1, dtype=torch.long, device=dev)
    return _Pending(key, srt.values, srt.indices, rank, pos, asc,
                    torch.cat([widest, _col_sizes(asc, 0, GUESS)]), n_rows)


def _finish(p: _Pending, head: list) -> Segments:
    width = head[0]
    cols = head[1:1 + min(width, GUESS)]
    if width > GUESS:
        cols += _col_sizes(p.asc, GUESS, width).tolist()
    n_kept = sum(cols)
    # the column sizes again on the device: copying ``cols`` there from
    # the host would wait for the device's queue
    sizes = _col_sizes(p.asc, 0, width)
    start = torch.cumsum(sizes, 0) - sizes
    slot = start[p.rank[:n_kept]] + p.pos[p.dst[:n_kept]]
    perm = torch.empty(n_kept, dtype=torch.long, device=p.key.device)
    perm[slot] = p.src[:n_kept]
    return Segments(p.key, perm, p.pos, tuple(cols), p.n_rows)


def segments(*specs) -> list[Segments]:
    """The :class:`Segments` of each ``(dst, n_rows)`` in ``specs``, with
    one host read for all of them (and one more for each whose widest row
    has more than :data:`GUESS` sources). ``dst`` holds each source's
    destination row; sources outside ``[0, n_rows)`` are dropped."""
    pending = [_prepare(dst, n_rows) for dst, n_rows in specs]
    heads = torch.cat([p.head for p in pending]).tolist()
    step = 1 + GUESS
    return [_finish(p, heads[i * step:(i + 1) * step])
            for i, p in enumerate(pending)]


def _sum(vals: torch.Tensor, seg: Segments) -> torch.Tensor:
    laid = vals.index_select(0, seg.perm)
    acc = vals.new_zeros((seg.n_rows, *vals.shape[1:]))
    if seg.cols:
        # one add a column, in column order. The host paces a long run of
        # columns (a BEV corner cell's thousands of one-row columns), so
        # each column height's view of acc is made once, not a slice a
        # column
        heads = {n: acc[:n] for n in set(seg.cols)}
        add = torch.Tensor.add_
        for head, col in zip([heads[n] for n in seg.cols],
                             torch.split(laid, seg.cols)):
            add(head, col)
    del laid
    return acc.index_select(0, seg.pos)


class _OrderedSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, vals, seg):
        ctx.seg = seg
        return _sum(vals, seg)

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
        return _sum(g, ctx.seg), None, None


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
