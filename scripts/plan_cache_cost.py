#!/usr/bin/env python3
"""What the plan cache's content keys cost a fresh MinkUNet-large request
on the card, and what they save on a repeated one.

For 8 distinct 65,536-voxel scenes (alternately indoor and LiDAR, the
bucket of ``chip_smoke.py``), each in fresh tensors:

* ``build``: ``build_plans`` with no cache (one request's plans, nothing
  kept);
* ``fingerprint``: ``content_fingerprint`` of the request's coordinates,
  batch and validity alone, in a tree that has it;
* ``long``: ``build_plans`` through one cache, sized as the serving
  engine's and kept across the 8 scenes, then the device memory that the
  cache holds (allocated, its 8 scenes' plans and anchored inputs) and
  the memory reserved;
* ``repeat``: the 8 scenes again, in fresh tensors, through that cache;
* ``serve``: the 8 scenes served one at a time by a ``ServeEngine`` over
  seeded MinkUNet-large weights (submit-to-result ms), then the first
  scene again (``resubmit_ms``).

Host clock around synchronized work; one warm-up pass, then two passes.
Each ``--src`` tree (a ``src`` directory holding ``repro_torch``) is
measured in a process of its own, in the order given, so that two
commits compare within one call: unpack the other commit with
``git archive`` into a directory ``.gitignore`` lists and name both trees
in the order parent, change, change, parent:

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python3 scripts/plan_cache_cost.py --src build/parent/src --src src \\
        --src src --src build/parent/src

Prints the card's name and power limit, then one JSON line per tree and
pass.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BUCKET, N_SCENES, SEED = 65536, 8, 0


def measure(src: Path) -> None:
    """The measurements of one tree, in this process."""
    sys.path.insert(0, str(src))
    import torch
    from repro_torch.core import plan as planlib
    from repro_torch.data import pointcloud
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch.spconv_serve import ServeEngine
    from repro_torch.models import minkunet
    from repro_torch.runtime import admission
    kbuild.build_all()
    dev, cfg = torch.device("cuda"), minkunet.LARGE
    scenes = [pointcloud.make_batch(
        np.random.default_rng(100 + i), "lidar" if i % 2 else "indoor", 1,
        BUCKET, voxel_size=0.0125 if i % 2 else 0.05)
        for i in range(N_SCENES)]
    fingerprint = getattr(planlib, "content_fingerprint", None)
    # the serving engine's cache size (8 requests' plans)
    capacity = max(64, 8 * (2 * (len(cfg.enc) + len(cfg.dec)) + 2))
    model = minkunet.MinkUNet(cfg, device=dev,
                              generator=torch.Generator().manual_seed(SEED))

    def fresh(vb):
        return [torch.as_tensor(a, device=dev)
                for a in (vb.coords, vb.batch, vb.valid)]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def build_ms(vb, cache):
        arrays = fresh(vb)
        return timed(lambda: minkunet.build_plans(
            *arrays, cfg, cache=cache, n_max=BUCKET, device=dev))

    for n in range(3):
        rec = {"src": str(src), "pass": n}
        planlib.reset_mapsearch_counter()
        rec["build_ms"] = [build_ms(vb, None) for vb in scenes]
        rec["build_searches"] = planlib.mapsearch_call_count()
        if fingerprint is not None:
            rec["fingerprint_ms"] = [
                timed(lambda a=fresh(vb): fingerprint(a)) for vb in scenes]
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        cache = planlib.PlanCache(capacity=capacity)
        planlib.reset_mapsearch_counter()
        rec["long_ms"] = [build_ms(vb, cache) for vb in scenes]
        rec["long_searches"] = planlib.mapsearch_call_count()
        rec["long_cache_gb"] = (torch.cuda.memory_allocated() - base) / 1e9
        rec["reserved_gb"] = torch.cuda.memory_reserved() / 1e9
        planlib.reset_mapsearch_counter()
        rec["repeat_ms"] = [build_ms(vb, cache) for vb in scenes]
        rec["repeat_searches"] = planlib.mapsearch_call_count()
        rec["cache"] = cache.stats()
        del cache
        engine = ServeEngine(model, queue=admission.AdmissionQueue(
            buckets=(BUCKET,)), max_batch=1)
        served = []
        for i, vb in enumerate(scenes + scenes[:1]):
            engine.submit(f"r{i}", vb.coords.copy(), vb.batch.copy(),
                          vb.valid.copy(), vb.feats.copy())
            (res,) = engine.step()
            assert res.status == "completed", res
            served.append(res.latency_s * 1e3)
        rec["serve_ms"], rec["resubmit_ms"] = served[:-1], served[-1]
        del engine
        torch.cuda.empty_cache()
        for k in ("build_ms", "fingerprint_ms", "long_ms", "repeat_ms",
                  "serve_ms"):
            if k in rec:
                rec[k.replace("_ms", "_median_ms")] = float(
                    np.median(rec[k]))
        if n:                                          # pass 0: warm-up
            print(json.dumps(rec), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", action="append", default=None,
                    help="a source tree to measure (repeatable; default: "
                         "this checkout's src)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        measure(Path(args.child).resolve())
        return 0
    import torch
    if not torch.cuda.is_available():
        print("plan_cache_cost: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rc = 0
    for src in args.src or [str(ROOT / "src")]:
        rc |= subprocess.run([sys.executable, __file__, "--child", src],
                             cwd=ROOT).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
