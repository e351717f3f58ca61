"""Cycle/energy model of SpOctA (the paper's cycle-accurate simulator role).

The port's own copy of ``repro.core.cyclemodel`` (numpy only), so that the
port imports nothing of the reference; the tests hold every function to
the reference's on the same inputs with exact float equality.

Reproduces the paper's evaluation figures from first principles:

  * Fig. 9(a) — map-search latency: serial hash baseline vs serial OCTENT
    vs parallel OCTENT (8-bank Query Transmitter).
  * Fig. 9(b) — overall latency: coarse pipeline vs fine-grained pipeline
    (search/compute overlap, §IV-C) vs + sparsity-aware computing (§V-B).
  * Fig. 10  — throughput/energy comparison vs a dense-serial reference.

Hardware constants mirror §VI: 400 MHz, 16x16 PE array (256 MACs/cycle),
8-bank octree table, DDR4 16 GB/s at 15 pJ/b. Logic/SRAM energies are
typical 40 nm numbers (absolute energy is calibration; *ratios* are the
reproduction targets).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import morton

FREQ_HZ = 400e6
PE_ROWS, PE_COLS = 16, 16
MACS_PER_CYCLE = PE_ROWS * PE_COLS
E_MAC_PJ = 0.23          # 8-bit MAC @40nm (Horowitz-scaled)
E_SRAM_PJ_PER_BYTE = 1.2
E_DRAM_PJ_PER_BIT = 15.0

# Serial hash baseline (GPU-style engine [9] mapped to one probe/cycle):
# build inserts with collision factor, queries probe chains. Calibrated so
# dataset-dependent occupancy spans the paper's 8.8-21.2x overall range.
HASH_BUILD_CPV = 2.0      # cycles per voxel insert
HASH_PROBE_CPQ = 2.5      # average probe chain per query


@dataclass
class SearchLatency:
    hash_serial: float
    octent_serial: float
    octent_parallel: float

    @property
    def serial_algo_saving(self) -> float:       # paper: >65 %
        return 1.0 - self.octent_serial / self.hash_serial

    @property
    def parallel_arch_saving(self) -> float:     # paper: 66.7-68.3 %
        return 1.0 - self.octent_parallel / self.octent_serial

    @property
    def total_speedup(self) -> float:            # paper: 8.8-21.2x
        return self.hash_serial / self.octent_parallel


def search_cycles(n_voxels: int, k_queries: int = 27,
                  probe_factor: float = HASH_PROBE_CPQ) -> SearchLatency:
    """Map-search cycle counts for one Subm3 layer over n_voxels."""
    hash_serial = n_voxels * (HASH_BUILD_CPV + k_queries * probe_factor)
    # OCTENT serial: 1-cycle table insert + 27 direct-indexed queries (no
    # probing — the octree code *is* the address), loop at Fig. 5(c) line 9
    # not unrolled.
    octent_serial = n_voxels * (1 + k_queries)
    # OCTENT parallel: 8 banks, PNELUT rows <= 8 deep => 8 query cycles for
    # Subm3 (1 for Gconv2); build pipelined behind queries.
    q_cycles = morton.pnelut_query_cycles() if k_queries == 27 else 1
    octent_parallel = n_voxels * (1 + q_cycles)
    return SearchLatency(hash_serial, octent_serial, octent_parallel)


def compute_cycles(n_maps: int, c_in: int, c_out: int,
                   value_sparsity: float = 0.0,
                   gather_grain: int = PE_ROWS) -> float:
    """SPAC compute cycles for one layer.

    ``value_sparsity`` is the inherent ifmap sparsity (Fig. 3(b), 40-60 %).
    The Gather Unit compacts nonzero operands in groups of ``gather_grain``
    input channels, so elision quantizes to ceil(nnz/grain) — utilization
    matches the paper's "44.4-79.1 % latency saving" band rather than the
    raw sparsity.
    """
    dense_vec_loads = n_maps * int(np.ceil(c_in / PE_ROWS))
    nnz = c_in * (1.0 - value_sparsity)
    sparse_vec_loads = n_maps * max(1.0, np.ceil(nnz / gather_grain))
    cycles = sparse_vec_loads * int(np.ceil(c_out / PE_COLS))
    del dense_vec_loads
    return float(cycles)


def dense_compute_cycles(n_maps: int, c_in: int, c_out: int) -> float:
    return float(n_maps * np.ceil(c_in / PE_ROWS) * np.ceil(c_out / PE_COLS))


@dataclass
class LayerLatency:
    coarse: float          # search then compute (VLSI'22-style, §IV-C)
    fine: float            # fine-grained pipeline (FIFO Map Table)
    fine_spac: float       # + sparsity-aware computing

    def fps(self, layers: int = 1) -> float:
        return FREQ_HZ / (self.fine_spac * layers)


def layer_latency(n_voxels: int, n_maps: int, c_in: int, c_out: int,
                  value_sparsity: float) -> LayerLatency:
    s = search_cycles(n_voxels).octent_parallel
    c_dense = dense_compute_cycles(n_maps, c_in, c_out)
    c_sparse = compute_cycles(n_maps, c_in, c_out, value_sparsity)
    # fine-grained pipeline: block-wise overlap leaves only one block's
    # search exposed (Fig. 6(c)); blocks ~ voxels / avg-occupancy.
    n_blocks = max(1, n_voxels // 64)
    startup = s / n_blocks
    return LayerLatency(
        coarse=s + c_dense,
        fine=max(s, c_dense) + startup,
        fine_spac=max(s, c_sparse) + startup,
    )


def layer_energy_pj(n_maps: int, c_in: int, c_out: int,
                    value_sparsity: float, dram_bytes: float) -> float:
    macs = n_maps * c_in * c_out * (1.0 - value_sparsity)
    sram = n_maps * (c_in + c_out)          # ifmap reads + psum writes (8b)
    return (macs * E_MAC_PJ + sram * E_SRAM_PJ_PER_BYTE
            + dram_bytes * 8 * E_DRAM_PJ_PER_BIT)
