"""Quickstart: the SpOctA pipeline on one synthetic LiDAR scan, through the
PyTorch/CUDA port (the counterpart of ``examples/quickstart.py``).

Octree-encode -> OCTENT parallel map search -> SPAC sparse conv ->
non-uniform caching report. Mirrors Fig. 4's dataflow end to end.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Runs on the card unless ``--device cpu`` is given: the map search and the
layer's gather-GEMM launch kernels 1 and 2 there, their plain versions on
the CPU.
"""
import argparse
import math

import numpy as np
import torch

from repro_torch.core import caching, mapsearch, morton, rulebook, sparsity
from repro_torch.core import spconv
from repro_torch.data import pointcloud
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--voxels", type=int, default=4096)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    vb = pointcloud.make_batch(rng, "lidar", batch_size=1,
                               max_voxels=args.voxels)
    n = int(vb.valid.sum())
    print(f"voxelized scan: {n} voxels, grid extent "
          f"{vb.coords[vb.valid].max(0)}")
    coords, batch, valid, feats = (torch.as_tensor(np.array(a), device=dev)
                                   for a in (vb.coords, vb.batch, vb.valid,
                                             vb.feats))

    # --- OCTENT map search (paper §IV) -----------------------------------
    offs = torch.as_tensor(morton.subm3_offsets(), device=dev)
    kmap = mapsearch.build_kmap_octree(coords, batch, valid, offs,
                                       max_blocks=args.voxels)
    n_maps = int((kmap >= 0).sum())
    print(f"OCTENT search: {n_maps} IN-OUT maps "
          f"({n_maps / max(n, 1):.1f} per voxel)")

    # --- weight-distribution skew (Fig. 8a) ------------------------------
    counts = rulebook.tap_counts(kmap).cpu().numpy()
    mid = sum(int(counts[t]) for t in range(27)
              if caching.tap_partition(t) in ("center", "mid"))
    print(f"delta_z=0 taps serve {mid / n_maps:.0%} of maps "
          f"(paper: 45-83% on LiDAR)")

    # --- one Subm3 layer with SPAC (paper §V) -----------------------------
    st = spconv.SparseTensor(coords, batch, valid, feats)
    gen = torch.Generator().manual_seed(0)
    w = (torch.randn((27, 4, 32), generator=gen)
         * math.sqrt(2.0 / (27 * 4))).to(dev)
    out = spconv.relu(spconv.subm_conv3(st, w, torch.zeros(32, device=dev),
                                        max_blocks=args.voxels))
    stats = sparsity.sparsity_stats(out.feats, kmap, 32)
    print(f"post-ReLU inherent sparsity: "
          f"{float(stats.element_sparsity):.0%} elements "
          f"(paper Fig. 3b: 40-60%)")

    # --- non-uniform caching (paper §V-C) ---------------------------------
    saving = caching.saving(counts, 64, 64, capacity_bytes=27 * 32 * 32)
    print(f"non-uniform caching saves {saving:.0%} DRAM energy at C_in=64")
    finite = bool(torch.isfinite(out.feats).all())
    print("output features:", tuple(out.feats.shape), "finite:", finite)
    return {"voxels": n, "maps": n_maps, "tap_counts": counts,
            "saving": saving, "finite": finite,
            "element_sparsity": float(stats.element_sparsity)}


if __name__ == "__main__":
    main()
