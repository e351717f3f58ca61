#!/usr/bin/env python3
"""What the compiled-step memo of ``run_spconv_demo`` costs on the card,
at MinkUNet-large and the bucket of ``chip_smoke.py`` (65,536 voxels,
indoor scenes):

* ``fresh``: ``run_spconv_demo(STEP_MEMO + 1, replay=False)``, a new scene
  at every step, so every step makes a memo entry (the ninth evicts the
  first): each step's plan and step ms and how it ran (a scene seen once
  runs its step eagerly), the pool bytes its captures added, and the
  card's memory reserved and its peak allocated after the run;
* ``replayed``: ``run_spconv_demo(4)``, one scene: eager, captured and
  replayed, then replayed;
* ``shared``: two scenes' steps over one state and one graph pool, as
  the memo holds them, called A A B B A B A: how each call ran, its ms,
  the pool bytes each capture added, and each call's state held bit for
  bit to an eager step's from the same state and batch.

Host clock around synchronized calls. Prints the card's name and power
limit, then one JSON line a part:

    PYTHONPATH=src python3 scripts/train_memo_cost.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.checkpoint import checkpoint  # noqa: E402
from repro_torch.data import pointcloud  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import minkunet  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

BUCKET = 65536
SEED = 0
GB = 1e9


def _scene(dev, cfg, seed):
    vb = pointcloud.make_batch(np.random.default_rng(seed), "indoor", 1,
                               BUCKET)
    batch = {k: torch.as_tensor(np.array(v), device=dev)
             for k, v in vb._asdict().items()}
    batch["labels"] = batch["labels"].clamp(0, cfg.classes - 1)
    plans = minkunet.build_plans(batch["coords"], batch["batch"],
                                 batch["valid"], cfg, device=dev)
    return batch, plans


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()


def _demo(dev, cfg, steps, replay):
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = train.run_spconv_demo(steps, voxels=BUCKET, cfg=cfg, seed=SEED,
                                scene="indoor", replay=replay, device=dev)
    torch.cuda.synchronize()
    return {"steps": steps, "replay": replay,
            "compiled_steps": res["compiled_steps"],
            "timings": res["timings"], "pool_bytes": res["pool_bytes"],
            "reserved_gb_after": torch.cuda.memory_reserved() / GB,
            "peak_allocated_gb": torch.cuda.max_memory_allocated() / GB}


def _shared(dev, cfg):
    model = minkunet.MinkUNet(cfg, device=dev,
                              generator=torch.Generator().manual_seed(SEED))
    opt_cfg = adamw.AdamWConfig(lr=1e-3, total_steps=8, warmup_steps=1)
    scenes = [_scene(dev, cfg, SEED + i) for i in (0, 1)]
    steps = [train.make_spconv_step(model, opt_cfg, plans, donate=True)
             for _, plans in scenes]
    pool = torch.cuda.graph_pool_handle()
    compiled = [train.CompiledStep(st, dev, pool) for st in steps]
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = (params, adamw.init(params))
    calls = []
    for i in (0, 0, 1, 1, 0, 1, 0):
        twin = _clone(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = compiled[i](state, scenes[i][0])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        twin, tm = steps[i](twin, scenes[i][0])
        equal = torch.equal(m["loss"], tm["loss"]) and all(
            torch.equal(a, b) for a, b in zip(checkpoint.tree_leaves(state),
                                              checkpoint.tree_leaves(twin)))
        mode = compiled[i].last
        calls.append({"scene": i, "graph": mode, "ms": ms,
                      "bit_equal": equal,
                      "pool_bytes": compiled[i].graph.pool_bytes
                      if mode == "capture" else None})
        del twin
    torch.cuda.synchronize()
    out = {"calls": calls,
           "reserved_gb_after": torch.cuda.memory_reserved() / GB}
    for c in compiled:
        c.release()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("train_memo_cost: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    cfg = minkunet.LARGE
    parts = {"replayed": lambda: _demo(dev, cfg, 4, True),
             "fresh": lambda: _demo(dev, cfg, train.STEP_MEMO + 1, False),
             "shared": lambda: _shared(dev, cfg)}
    ok = True
    for name, fn in parts.items():
        rec = fn()
        if name == "shared":
            ok &= all(c["bit_equal"] for c in rec["calls"])
        print(json.dumps({"part": name, **rec}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
