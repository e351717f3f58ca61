"""Plain PyTorch version of the fixed-order segment sum: its oracle.

Row r of the sum adds ``vals[src[i]]`` for i from ``starts[r]`` to
``starts[r + 1] - 1``, in that order, from zero (a
:class:`~repro_torch.core.segment.Segments` index). Here the sources are
laid out column-major, with the rows sorted by their source count,
descending (:class:`Layout`): column j holds the j-th source of every row
that has more than j, those rows first, so a column is one contiguous
block and its add touches only the rows that have such a source. The sum
gathers the values into that layout once and adds one column at a time: a
row with L sources takes L adds, in order, and a row with none is never
touched. That is one launch a column on the card, so the host paces a
long row; the kernel (``csrc/segment_sum.cu``) takes the index as it is.

:func:`layouts` builds the layouts of several indexes with one host read
of their column sizes (one more for each whose widest row has more than
:data:`GUESS` sources).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

#: column sizes read back with the widest row's count, in the layouts' one
#: read; a row with more sources takes a second read for the rest
GUESS = 32


class Layout(NamedTuple):
    """The column-major layout of one index."""
    perm: torch.Tensor   # (n_kept,) int64 the source at each slot of the
                         # column-major layout
    pos: torch.Tensor    # (n_rows,) int64 each row's place in the
                         # count-descending row order
    cols: tuple          # host ints: the rows of each column, descending


class _Pending(NamedTuple):
    dst: torch.Tensor    # (n,) sorted destinations
    src: torch.Tensor    # (n,) the source of each
    rank: torch.Tensor   # (n,) each source's place among its row's
    pos: torch.Tensor
    asc: torch.Tensor    # (n_rows,) the rows' source counts, ascending
    head: torch.Tensor   # (1 + GUESS,) widest count, first column sizes


def _col_sizes(asc, lo, hi):
    """Rows with more than j sources, for j in [lo, hi)."""
    j = torch.arange(lo, hi, device=asc.device)
    return asc.shape[0] - torch.searchsorted(asc, j, right=True)


def _prepare(key, src, starts) -> _Pending:
    """Everything of the layout that the device computes: no host read."""
    dev, n, n_rows = key.device, key.shape[0], starts.shape[0] - 1
    dst = key[src]
    rank = torch.arange(n, device=dev) - starts[dst]
    desc = torch.sort(starts[1:] - starts[:-1], descending=True, stable=True)
    pos = torch.empty_like(desc.indices)
    pos[desc.indices] = torch.arange(n_rows, device=dev)
    asc = desc.values.flip(0)
    widest = desc.values[:1] if n_rows else torch.zeros(
        1, dtype=torch.long, device=dev)
    return _Pending(dst, src, rank, pos, asc,
                    torch.cat([widest, _col_sizes(asc, 0, GUESS)]))


def _finish(p: _Pending, head: list) -> Layout:
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
    perm = torch.empty(n_kept, dtype=torch.long, device=p.src.device)
    perm[slot] = p.src[:n_kept]
    return Layout(perm, p.pos, tuple(cols))


def layouts(*indexes) -> list[Layout]:
    """The :class:`Layout` of each ``(key, src, starts)`` in ``indexes``
    (the fields of a ``Segments``), with one host read for all of them."""
    pending = [_prepare(*idx) for idx in indexes]
    if not pending:
        return []
    heads = torch.cat([p.head for p in pending]).tolist()
    step = 1 + GUESS
    return [_finish(p, heads[i * step:(i + 1) * step])
            for i, p in enumerate(pending)]


def with_layout(seg):
    """``seg`` with its column layout, built here (host reads) if it has
    none: an index built on the card carries none."""
    if seg.cols is not None:
        return seg
    return seg._replace(**layouts((seg.key, seg.src, seg.starts))[0]
                        ._asdict())


def segment_sum_ref(vals: torch.Tensor, seg) -> torch.Tensor:
    """``(n_rows, ...)``: row r adds ``vals[i]`` for every source i whose
    destination is r, in ascending i, from zero, one column of the
    layout a launch. ``seg`` is the ``Segments`` index of the n
    destinations of ``vals`` (n, ...)."""
    seg = with_layout(seg)
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
