"""Octree / Morton encoding (SpOctA eq. 3) and block partitioning.

A voxel coordinate (x, y, z) is bit-interleaved with x in the least
significant position of each octal digit. Search is restricted to 16^3
blocks whose octree table is 8 banks x 512 rows (bank = phi_1):

  * local code = 12-bit Morton code of (x & 15, y & 15, z & 15);
    bank = code & 7, row = code >> 3;
  * block key  = Morton code of (x >> 4, y >> 4, z >> 4) with the batch
    index in the top bits, so maps never cross batch items.

All functions take int32 tensors of any leading shape and return int32,
using the same signed shift/mask ladder as the reference.
"""
from __future__ import annotations

import numpy as np
import torch

BLOCK_BITS = 4               # 16^3 blocks, as in the paper
BLOCK_SIZE = 1 << BLOCK_BITS
LOCAL_CODE_BITS = 3 * BLOCK_BITS          # 12-bit within-block code
BANK_COUNT = 8                            # phi_1 selects one of 8 banks
BANK_ROWS = 1 << (LOCAL_CODE_BITS - 3)    # 512 rows per bank
TABLE_SIZE = BANK_COUNT * BANK_ROWS       # 4096 = 16^3


def _part1by2(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Spread the low ``bits`` bits of ``v`` so consecutive bits are 3 apart
    (magic-number smearing, valid for bits <= 10 in int32)."""
    v = v.to(torch.int32) & ((1 << bits) - 1)
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _compact1by2(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`_part1by2`."""
    v = v.to(torch.int32) & 0x09249249
    v = (v | (v >> 2)) & 0x030C30C3
    v = (v | (v >> 4)) & 0x0300F00F
    v = (v | (v >> 8)) & 0x030000FF
    v = (v | (v >> 16)) & 0x000003FF
    return v & ((1 << bits) - 1)


def interleave_xyz(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                   bits: int) -> torch.Tensor:
    """Morton-encode separate x/y/z channels into an int32 code, x at bit 0."""
    return (_part1by2(x, bits) | (_part1by2(y, bits) << 1)
            | (_part1by2(z, bits) << 2))


def interleave3(coords: torch.Tensor, bits: int) -> torch.Tensor:
    """Morton-encode ``coords[..., (x, y, z)]``; each octal digit is {z y x}."""
    return interleave_xyz(coords[..., 0], coords[..., 1], coords[..., 2], bits)


def deinterleave3(code: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`interleave3`; returns (..., 3) int32 coords."""
    return torch.stack([_compact1by2(code >> s, bits) for s in (0, 1, 2)],
                       dim=-1)


def local_code(coords: torch.Tensor) -> torch.Tensor:
    """12-bit within-block octree code (the table address {phi_hi, phi_1})."""
    return interleave3(coords & (BLOCK_SIZE - 1), BLOCK_BITS)


def bank_and_row(code: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a local code into (bank = phi_1, row address)."""
    return code & (BANK_COUNT - 1), code >> 3


def block_key(coords: torch.Tensor, batch: torch.Tensor, grid_bits: int = 7,
              batch_bits: int = 4) -> torch.Tensor:
    """Morton key of the 16^3 block holding each voxel, batch-tagged.

    3*grid_bits bits of block Morton code plus batch_bits on top must fit
    in 31 bits.
    """
    if 3 * grid_bits + batch_bits > 31:
        raise ValueError("block key overflows int32")
    bcode = interleave3(coords >> BLOCK_BITS, grid_bits)
    return bcode | (batch.to(torch.int32) << (3 * grid_bits))


def child_octant(coords: torch.Tensor) -> torch.Tensor:
    """phi_1 of the coordinate: which child of its size-2 octree parent
    (the weight tap of Gconv2/Tconv2)."""
    return ((coords[..., 0] & 1) | ((coords[..., 1] & 1) << 1)
            | ((coords[..., 2] & 1) << 2))


def subm3_offsets() -> np.ndarray:
    """The 27 kernel offsets of Subm3 in weight-index order (x fastest)."""
    rng = (-1, 0, 1)
    return np.array([(dx, dy, dz) for dz in rng for dy in rng for dx in rng],
                    dtype=np.int32)


def build_pnelut() -> tuple[np.ndarray, np.ndarray, int]:
    """The PNELUT (Parallel Neighbor-Encoding LUT, Fig. 5(b)): for each
    center phi_1 (8) the 27 Subm3 neighbour queries grouped by the bank
    (the neighbour's phi_1) they hit.

    Returns ``(lut, depth, max_rot)``: ``lut`` (8, 8, max_rot) int32 offset
    indices into :func:`subm3_offsets`, [center phi_1, bank, slot], -1
    padded; ``depth`` (8, 8) int32 valid entries per row; ``max_rot`` the
    deepest row, the query cycles of an 8-bank Query Transmitter (8 for
    Subm3).
    """
    offs = subm3_offsets()
    groups = [[[] for _ in range(8)] for _ in range(8)]
    for p1 in range(8):
        cx, cy, cz = p1 & 1, (p1 >> 1) & 1, (p1 >> 2) & 1
        for oi, (dx, dy, dz) in enumerate(offs):
            nb = (((cx + dx) & 1) | (((cy + dy) & 1) << 1)
                  | (((cz + dz) & 1) << 2))
            groups[p1][nb].append(oi)
    max_rot = max(len(g) for row in groups for g in row)
    lut = np.full((8, 8, max_rot), -1, dtype=np.int32)
    depth = np.zeros((8, 8), dtype=np.int32)
    for p1 in range(8):
        for b in range(8):
            lut[p1, b, :len(groups[p1][b])] = groups[p1][b]
            depth[p1, b] = len(groups[p1][b])
    return lut, depth, max_rot


def pnelut_query_cycles() -> int:
    """Query cycles per voxel for Subm3 with 8 parallel banks (paper: 8)."""
    return build_pnelut()[2]
