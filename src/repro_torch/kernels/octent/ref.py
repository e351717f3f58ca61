"""Plain PyTorch version of the OCTENT query: the kernel's oracle.

Same clipping, same Morton ladder and the same two lower-bound searches as
the CUDA kernel (csrc/octent_query.cu), vectorized over the whole cloud so
every intermediate, the (N, K, 3) query tensor included, materializes.
Integer in, integer out: the kernel must match it bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import morton
from repro_torch.core.mapsearch import set_drop


def encode_queries(coords: torch.Tensor, batch: torch.Tensor,
                   valid: torch.Tensor, offsets: torch.Tensor, *,
                   grid_bits: int):
    """All K offset queries per voxel and their search keys.

    Returns (inb, bkey, bank, row), each (N, K): the in-grid mask (queries
    out of the grid or from invalid voxels rejected), the batch-tagged block
    Morton key, and the banked-table address of the local code.
    """
    q = coords[:, None, :] + offsets[None, :, :]          # (N, K, 3)
    limit = (1 << grid_bits) * morton.BLOCK_SIZE
    inb = ((q >= 0) & (q < limit)).all(dim=-1) & valid[:, None]
    qc = q.clamp(0, limit - 1)
    bt = batch[:, None].expand(q.shape[:2]).to(torch.int32)
    bkey = (morton.interleave3(qc >> morton.BLOCK_BITS, grid_bits)
            | (bt << (3 * grid_bits)))
    phi = morton.interleave3(qc & (morton.BLOCK_SIZE - 1), morton.BLOCK_BITS)
    bank, row = morton.bank_and_row(phi)
    return inb, bkey, bank, row


def octent_query_ref(coords: torch.Tensor, batch: torch.Tensor,
                     valid: torch.Tensor, offsets: torch.Tensor,
                     ublocks: torch.Tensor, tkey: torch.Tensor,
                     tval: torch.Tensor, n_blocks: torch.Tensor, *,
                     grid_bits: int = 7, batch_bits: int = 4,
                     rows: torch.Tensor | None = None,
                     prev: torch.Tensor | None = None) -> torch.Tensor:
    """Resolve all K offset queries per voxel. Returns kmap (N, K) int32.

    Row-list mode (``rows`` (Q,) -1 padded, ``prev`` (N, K)): gather the
    listed rows, search them, and scatter the result into a copy of
    ``prev`` through a drop row (index N, cut off), so that a -1 entry is
    dropped.
    """
    if rows is not None:
        n = coords.shape[0]
        live = rows >= 0
        sel = torch.where(live, rows, 0).long()
        sub = octent_query_ref(coords[sel], batch[sel], valid[sel] & live,
                               offsets, ublocks, tkey, tval, n_blocks,
                               grid_bits=grid_bits, batch_bits=batch_bits)
        return set_drop(prev, torch.where(live, rows, n), sub)
    del batch_bits   # part of the key contract; the query needs no bound
    max_blocks = ublocks.shape[0]
    inb, bkey, bank, row = encode_queries(coords, batch, valid, offsets,
                                          grid_bits=grid_bits)
    nb = n_blocks.reshape(()).to(torch.int32).clamp(max=max_blocks)
    rank = torch.minimum(
        torch.searchsorted(ublocks, bkey.contiguous(), out_int32=True), nb)
    hit_b = ((rank < nb)
             & (ublocks[rank.clamp(max=max_blocks - 1).long()] == bkey))
    key2 = rank * morton.TABLE_SIZE + bank * morton.BANK_ROWS + row
    n_t = tkey.shape[0]
    pos = torch.searchsorted(tkey, key2.contiguous(),
                             out_int32=True).clamp(max=n_t - 1).long()
    hit = hit_b & inb & (tkey[pos] == key2)
    return torch.where(hit, tval[pos], -1).to(torch.int32)
