"""Non-uniform weight caching (paper §V-C) — policy + traffic model.

LiDAR geometry makes the delta_z = 0 kernel slice serve 45-83 % of all maps
(Fig. 8(a)), so SpOctA partitions the weight SRAM into {center, mid, up,
down} and gives the hot partitions full residency.

This module is the analytical traffic/energy model used to reproduce
Fig. 9(c): external-memory bytes for weights under ``uniform`` vs
``nonuniform`` residency with a fixed on-chip budget. It is the port's own
copy of ``repro.core.caching`` (numpy only); the tests hold it to the
reference's with exact float equality.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

# tap index = (dx+1) + 3*(dy+1) + 9*(dz+1), so delta_z slices are contiguous
TAP_CENTER = 13
TAPS_DOWN = tuple(range(0, 9))       # delta_z = -1
TAPS_MID = tuple(t for t in range(9, 18) if t != TAP_CENTER)
TAPS_UP = tuple(range(18, 27))       # delta_z = +1

DDR_PJ_PER_BIT = 15.0                # paper §VI-A2 [26]
DDR_BYTES_PER_SEC = 16e9             # moderate DDR4


class TrafficReport(NamedTuple):
    bytes_fetched: float
    energy_pj: float
    resident_bytes: float
    policy: str


def tap_partition(tap: int) -> str:
    if tap == TAP_CENTER:
        return "center"
    if tap in TAPS_MID:
        return "mid"
    if tap in TAPS_UP:
        return "up"
    return "down"


def weight_traffic(tap_counts: np.ndarray, c_in: int, c_out: int,
                   *, capacity_bytes: float, tile_rows: int = 16,
                   policy: str = "nonuniform",
                   dtype_bytes: int = 1) -> TrafficReport:
    """Model DRAM->SRAM weight traffic for one Subm3 layer.

    Output-stationary processing walks output tiles of ``tile_rows`` rows;
    a tile touches tap t iff any of its windows has a map through t. A
    resident fraction of a tap's weight matrix is fetched once; the rest is
    re-streamed for every tile that touches the tap. ``nonuniform`` ranks
    taps center > mid > up/down (the paper's partitions, Fig. 8(b)) and, as
    a refinement, by measured map count inside each partition; ``uniform``
    spreads the budget evenly over all 27 taps.
    """
    k = len(tap_counts)
    bytes_per_tap = c_in * c_out * dtype_bytes
    n_tiles = max(1, int(np.ceil(tap_counts.max() / tile_rows)))
    # tiles touched by tap t: every tile if the tap is dense, fewer if sparse
    tiles_touched = np.minimum(n_tiles, np.ceil(tap_counts / tile_rows)).astype(np.int64)

    resident = np.zeros(k)
    if policy == "uniform":
        resident[:] = min(1.0, (capacity_bytes / k) / bytes_per_tap)
    elif policy == "nonuniform":
        prio_rank = {"center": 0, "mid": 1, "up": 2, "down": 2}
        order = sorted(range(k), key=lambda t: (prio_rank[tap_partition(t)],
                                                -int(tap_counts[t])))
        budget = capacity_bytes
        for t in order:
            take = min(1.0, budget / bytes_per_tap)
            resident[t] = take
            budget -= take * bytes_per_tap
            if budget <= 0:
                break
    else:
        raise ValueError(policy)

    active = tap_counts > 0
    fetched = (
        resident * bytes_per_tap * active                      # once
        + (1.0 - resident) * bytes_per_tap * tiles_touched     # streamed
    ).sum()
    return TrafficReport(bytes_fetched=float(fetched),
                         energy_pj=float(fetched * 8 * DDR_PJ_PER_BIT),
                         resident_bytes=float((resident * bytes_per_tap).sum()),
                         policy=policy)


def saving(tap_counts: np.ndarray, c_in: int, c_out: int,
           capacity_bytes: float, **kw) -> float:
    """Fractional DRAM-energy saving of nonuniform over uniform (Fig. 9(c))."""
    u = weight_traffic(tap_counts, c_in, c_out, capacity_bytes=capacity_bytes,
                       policy="uniform", **kw)
    n = weight_traffic(tap_counts, c_in, c_out, capacity_bytes=capacity_bytes,
                       policy="nonuniform", **kw)
    return 1.0 - n.energy_pj / max(u.energy_pj, 1e-9)
