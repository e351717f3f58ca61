#!/usr/bin/env python3
"""Kernel 3 (the materialized tiled GEMM) of this checkout against another
version of its source, on one GPU: at the 20 distinct layer shapes of one
MinkUNet-large forward (the lidar scene of ``chip_smoke.py``, phase
``spconv_gemm``'s seeded inputs) and at one Mixtral-8x7B ``w_gate``
product on the router's rulebook (phase ``moe_ragged``'s inputs).

    mkdir -p build/ab
    git archive <commit> src/repro_torch/csrc/spconv_gemm.cu | tar -x -C build/ab
    python3 scripts/spconv_gemm_ab.py --other build/ab/src/repro_torch/csrc/spconv_gemm.cu

Both sources are built with the port's nvcc flags and called through their
C launch function ``spconv_gemm_launch``, whose interface both forms
share. Each shape checks both against the plain version (1e-4 x
max|plain|, as ``chip_smoke.py``), then times other, this, this, other
(``octent_ab.ab_times``). Prints the card's name and power limit, one JSON
line per shape, then the sums: over the 20 shapes once each (the
``apply_kmap`` path's 20 launches), weighted by layers (the 25 layers of a
forward), and the ``w_gate`` product.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: launches a timing, as phases spconv_gemm and moe_ragged time kernel 3
ITERS = 5


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True,
                    help="the other spconv_gemm.cu")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("spconv_gemm_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from octent_ab import ab_times, build_launch
    from repro_torch.data import pointcloud
    from repro_torch.kernels import build
    from repro_torch.kernels.spconv_gemm import ops as sg_ops
    from repro_torch.kernels.spconv_gemm.ref import spconv_gemm_ref
    from repro_torch.models import minkunet
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.build_dir().mkdir(parents=True, exist_ok=True)
    p, i = ctypes.c_void_p, ctypes.c_int
    argtypes = [p, i, p, i, i, i, p, p, p, p]
    fns = {"this": build_launch(build.CSRC / build.SOURCES["spconv_gemm"],
                                build.build_dir() / "ab_k3_this.so",
                                "spconv_gemm_launch", argtypes),
           "other": build_launch(args.other.resolve(),
                                 build.build_dir() / "ab_k3_other.so",
                                 "spconv_gemm_launch", argtypes)}
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ab(label, lhs, w, tiles, bm):
        """Both forms at one shape: checked, then timed; the record."""
        want = spconv_gemm_ref(lhs, w, tiles.tile_tap, tiles.tile_nz, bm=bm)
        ref_max = want.abs().max().item()
        out = torch.empty_like(want)
        call_args = (lhs.data_ptr(), lhs.shape[1], w.data_ptr(), w.shape[2],
                     bm, tiles.n_tiles, tiles.tile_tap.data_ptr(),
                     tiles.tile_nz.data_ptr(), out.data_ptr(), stream)
        calls, err = {}, {}
        for name, fn in fns.items():
            calls[name] = (lambda fn=fn: cs.check(fn(*call_args) == 0,
                                                  "launch failed"))
            out.fill_(float("nan"))
            calls[name]()
            torch.cuda.synchronize()
            err[name] = (out - want).abs().max().item()
            cs.check(err[name] <= cs.TOL_KERNEL * max(ref_max, 1e-30),
                     f"{name} differs from the plain version at {label}: "
                     f"{err[name]} > {cs.TOL_KERNEL} * {ref_max}")
        del want
        ms = ab_times(calls, ITERS)
        return {"shape": label, "cin": lhs.shape[1], "cout_pad": w.shape[2],
                "bm": bm, "tiles": tiles.n_tiles,
                "live_tiles": int(tiles.tile_nz.sum()), "max_abs_err": err,
                "ms": ms, "mean_ms": {k: float(np.mean(v))
                                      for k, v in ms.items()}}

    scene = pointcloud.make_batch(np.random.default_rng(cs.SEED), "lidar", 1,
                                  cs.BUCKET, voxel_size=cs.LIDAR_VOXEL)
    _, shapes = cs.layer_shapes(dev, scene, minkunet.LARGE)
    path = {"this": 0.0, "other": 0.0}
    forward = {"this": 0.0, "other": 0.0}
    for shp in shapes:
        tiles, lhs, wp = cs.materialized_args(shp)
        rec = ab(shp["layers"][0], lhs, wp, tiles, shp["plan"].tiles.bm)
        rec["layers"] = len(shp["layers"])
        for name in path:
            path[name] += rec["mean_ms"][name]
            forward[name] += rec["layers"] * rec["mean_ms"][name]
        print(json.dumps(rec), flush=True)
        del tiles, lhs, wp
        torch.cuda.empty_cache()
    del shapes

    ex = cs._moe_ragged_example()
    x, w_router, w_in = cs.w_gate_inputs(dev)
    k, bm = cs.MOE_RAGGED[4], cs.MOE_RAGGED[5]
    tiles = sg_ops.build_tap_tiles(ex.route(x, w_router, k), bm=bm)
    lhs = x[tiles.gather_idx.long()]
    lhs.masked_fill_(~tiles.slot_valid[:, None], 0.0)
    w_gate = ab("mixtral_w_gate", lhs, w_in, tiles, bm)
    print(json.dumps(w_gate), flush=True)
    print(json.dumps({
        "apply_kmap_path_ms": path, "forward_ms": forward,
        "w_gate_ms": w_gate["mean_ms"],
        "path_this_over_other": path["this"] / path["other"],
        "w_gate_this_over_other": (w_gate["mean_ms"]["this"]
                                   / w_gate["mean_ms"]["other"])}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
