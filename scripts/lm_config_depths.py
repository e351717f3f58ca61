#!/usr/bin/env python3
"""The depth cuts of ``chip_smoke.py``'s phase ``lm_configs``, sized with
the port's own dry run (``launch/dryrun.run_cell`` on ``meta`` tensors at
a (1, 1) mesh, so nothing is allocated and no card is needed).

For each of the phase's runs, a config at its published width and a cell
at the run's batch (serve: a prefill of ``SERVE_BATCH`` x ``SERVE_SEQ``
tokens, the prompt plus the generated tokens; train: a donated train cell
of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens, AdamW in place), the cell is
counted at depths 1 and 2; arguments plus temporaries grow by one
layer's bytes a layer, which gives the deepest cut under ``LIMIT``
(72 GB of the card's 80). That depth, capped at the published one, is
counted once more, and made shallower while it does not fit. One JSON
line a run, its record's bytes and the depth chosen:

    PYTHONPATH=src python3 scripts/lm_config_depths.py
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import SHAPE_CELLS, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

ARCHS = ("qwen3-1.7b", "yi-9b", "deepseek-67b", "mixtral-8x22b")
SERVE_BATCH, SERVE_SEQ = 4, 512 + 16
TRAIN_BATCH, TRAIN_SEQ = 2, 512
LIMIT = 72e9                       # bytes of arguments plus temporaries


def _total(arch, cfg, shape, cell, depth, donate):
    rec = dryrun.run_cell(arch, shape, "one", donate=donate,
                          cfg=dataclasses.replace(cfg, n_layers=depth),
                          cell=cell)
    if rec["status"] != "ok":
        raise RuntimeError(f"{arch} {shape} at depth {depth}: {rec}")
    return rec, rec["argument_bytes"] + rec["temp_bytes"]


def size(arch: str, kind: str) -> dict:
    """The deepest cut of ``arch``'s ``kind`` run ("serve" or "train")
    whose arguments plus temporaries stay under ``LIMIT`` bytes."""
    cfg = get_config(arch)
    if kind == "serve":
        shape, b, s, donate = "prefill_32k", SERVE_BATCH, SERVE_SEQ, False
    else:
        shape, b, s, donate = "train_4k", TRAIN_BATCH, TRAIN_SEQ, True
    cell = dataclasses.replace(SHAPE_CELLS[shape], seq_len=s, global_batch=b)
    _, t1 = _total(arch, cfg, shape, cell, 1, donate)
    _, t2 = _total(arch, cfg, shape, cell, 2, donate)
    per_layer = t2 - t1
    depth = max(1, min(cfg.n_layers, 1 + int((LIMIT - t1) // per_layer)))
    while True:
        rec, total = _total(arch, cfg, shape, cell, depth, donate)
        if total <= LIMIT or depth == 1:
            break
        depth -= 1
    return {"arch": arch, "run": kind, "batch": b, "seq": s,
            "donate": donate, "published_layers": cfg.n_layers,
            "layers": depth, "cut": depth < cfg.n_layers,
            "depth1_bytes": t1, "per_layer_bytes": per_layer,
            "bytes_per_device": rec["bytes_per_device"],
            "argument_bytes": rec["argument_bytes"],
            "temp_bytes": rec["temp_bytes"], "total_bytes": total,
            "limit": LIMIT, "fits": total <= LIMIT}


def main() -> int:
    for arch in ARCHS:
        for kind in ("serve", "train"):
            print(json.dumps(size(arch, kind)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
