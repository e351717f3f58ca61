#!/usr/bin/env python3
"""Kernel 1 (the OCTENT query) of this checkout against another version of
its source, on one GPU, at the 5 query shapes of one served MinkUNet-large
request (the lidar scene of ``chip_smoke.py``, one shape per resolution).

    git archive <commit> src/repro_torch/csrc/octent_query.cu | tar -x -C build/ab
    python3 scripts/octent_ab.py --other build/ab/src/repro_torch/csrc/octent_query.cu

Both sources are built with the port's nvcc flags and called through their
C launch functions (an ``octent_query_launch`` with a scratch argument, or
the earlier one without). Each shape checks both against the plain version
bit for bit, then times other, this, this, other (CUDA events, 50 calls
each, as ``chip_smoke.time_ms``). Prints one JSON line per shape, then the
sums a request, with the card's name and power limit first.
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


def build_launch(src: Path, out: Path, entry: str, argtypes):
    """Compile one kernel source with the port's nvcc flags into the
    library ``out`` and return its C launch function ``entry`` (``int``
    result, ``argtypes`` arguments). Shared by the kernels' A/B scripts."""
    from repro_torch.kernels import build
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                          str(out), str(src)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
    fn = getattr(ctypes.CDLL(str(out)), entry)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def ab_times(calls, iters: int) -> dict:
    """Device ms of ``calls["other"]`` and ``calls["this"]`` in the order
    other, this, this, other (``chip_smoke.time_ms``, ``iters`` calls
    each), so that a drift of the card's clock over the run falls on both."""
    import chip_smoke as cs
    ms = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        ms[name].append(cs.time_ms(calls[name], iters))
    return ms


def _load(src: Path, out: Path):
    p, i = ctypes.c_void_p, ctypes.c_int
    scratch = "scratch" in src.read_text()
    return build_launch(src, out, "octent_query_launch",
                        [p, p, p, i, p, i, p, i, p, p, p, i, i] + (
                            [p, p, p] if scratch else [p, p])), scratch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True,
                    help="the other octent_query.cu")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("octent_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import morton
    from repro_torch.data import pointcloud
    from repro_torch.kernels import build
    from repro_torch.kernels.octent import ops as oct_ops
    from repro_torch.kernels.octent.ref import octent_query_ref
    from repro_torch.models import minkunet
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.build_dir().mkdir(parents=True, exist_ok=True)
    fns = {"this": _load(build.CSRC / build.SOURCES["octent_query"],
                         build.build_dir() / "ab_this.so"),
           "other": _load(args.other.resolve(),
                          build.build_dir() / "ab_other.so")}
    dev = torch.device("cuda", 0)
    cfg = minkunet.LARGE
    scene = pointcloud.make_batch(np.random.default_rng(cs.SEED), "lidar", 1,
                                  cs.BUCKET, voxel_size=cs.LIDAR_VOXEL)
    plans = minkunet.build_plans(scene.coords, scene.batch, scene.valid, cfg,
                                 device=dev)
    levels = [tuple(torch.as_tensor(a, device=dev) for a in (
        scene.coords, scene.batch, scene.valid))] + [
        (d.out_coords, d.out_batch, d.out_valid) for d in plans.down]
    offs = torch.as_tensor(morton.subm3_offsets(), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    total = {"this": 0.0, "other": 0.0}
    for res, (c, b, v) in enumerate(levels):
        qt = oct_ops.build_query_table(c, b, v, max_blocks=cs.BUCKET,
                                       grid_bits=cfg.grid_bits,
                                       batch_bits=cfg.batch_bits)
        n, k = c.shape[0], offs.shape[0]
        want = octent_query_ref(c, b, v, offs, qt.ublocks, qt.tkey, qt.tval,
                                qt.n_blocks, grid_bits=cfg.grid_bits)
        out = torch.empty((n, k), dtype=torch.int32, device=dev)
        scratch = torch.empty(29 * cs.BUCKET + n, dtype=torch.int32,
                              device=dev)
        head = (c.data_ptr(), b.data_ptr(), v.data_ptr(), n, offs.data_ptr(),
                k, qt.ublocks.data_ptr(), qt.ublocks.shape[0],
                qt.n_blocks.data_ptr(), qt.tkey.data_ptr(),
                qt.tval.data_ptr(), qt.tkey.shape[0], cfg.grid_bits)
        calls = {}
        for name, (fn, has_scratch) in fns.items():
            tail = ((scratch.data_ptr(),) if has_scratch else ()) + (
                out.data_ptr(), stream)
            calls[name] = (lambda fn=fn, tail=tail:
                           cs.check(fn(*head, *tail) == 0, "launch failed"))
            out.fill_(7)
            calls[name]()
            torch.cuda.synchronize()
            cs.check(torch.equal(out, want),
                     f"{name} differs from the plain version at res {res}")
        ms = ab_times(calls, 50)
        for name in total:
            total[name] += float(np.mean(ms[name]))
        print(json.dumps({"res": res, "voxels": int(v.sum()),
                          "blocks": int(qt.n_blocks), "ms": ms}), flush=True)
    print(json.dumps({"ms_per_request": total,
                      "this_over_other": total["this"] / total["other"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
