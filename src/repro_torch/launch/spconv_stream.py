"""Streaming inference: a moving-sensor replay through MinkUNet.

One long-lived :class:`~repro_torch.core.stream.StreamSession` keeps a
pinned stage-1 table per resolution level, and every frame of a
:func:`~repro_torch.data.pointcloud.moving_sensor_sequence` is diffed
against it: only the dirty neighbourhoods are searched again (kernel 1 in
row-list mode on the card), the other kmap rows are kept, and a repeated
frame costs no search. Each frame's line says which path each level took
(delta / full / content hit), the rows searched against a build from
scratch, and the plan and forward wall clock:

    PYTHONPATH=src python -m repro_torch.launch.spconv_stream \\
        --device cpu --config tiny

On the card, ``--config large`` replays MinkUNet-large on 65,536-row
frames of a 512-voxel window (the frames of phase ``stream`` of
``chip_smoke.py``). ``--no-stream`` replays the same frames with the delta
path off, every frame from scratch.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import plan as planlib
from repro_torch.core import stream
from repro_torch.data.pointcloud import moving_sensor_sequence
from repro_torch.device import resolve_device
from repro_torch.models import minkunet
from repro_torch.runtime import feature_cache

CONFIGS = {
    "tiny": minkunet.MinkUNetConfig(name="stream-tiny", in_ch=3, classes=4,
                                    stem=8, enc=(8, 8), dec=(8, 8),
                                    blocks=1, grid_bits=5, batch_bits=2),
    "small": minkunet.MinkUNetConfig(name="stream-small", in_ch=3,
                                     classes=8, stem=16, enc=(16, 32),
                                     dec=(32, 16), blocks=1, grid_bits=6,
                                     batch_bits=2),
    "large": minkunet.LARGE,
}

#: frame parameters of each config: (voxels, window, step, depth, density)
FRAMES = {
    "tiny": (1024, 192, 4, 16, 0.15),
    "small": (1024, 192, 4, 16, 0.15),
    "large": (65536, 512, 32, 256, 0.35),
}


def run_stream(cfg, n_frames: int, n: int, *, max_blocks: int | None = None,
               window: int = 192, step: int = 4, depth: int = 16,
               density: float = 0.15, seed: int = 0,
               enabled: bool | None = None, impl: str | None = None,
               pinned_bytes: int | None = None, device=None,
               log=print) -> dict:
    """Replay ``n_frames`` through one long-lived session on ``device``
    (None: the card); returns the session's stats and wall-clock means.
    ``impl`` is the search impl (``"kernel"`` | ``"ref"``); ``log=None``
    silences the per-frame lines."""
    dev = resolve_device(device)
    store = feature_cache.PinnedStore(pinned_bytes) if pinned_bytes \
        else feature_cache.default_store()
    sess = stream.StreamSession(
        cfg, n, max_blocks=max_blocks, search_impl=impl, enabled=enabled,
        cache=planlib.PlanCache(pinned=store), device=dev)
    model = minkunet.MinkUNet(
        cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    frames = moving_sensor_sequence(np.random.default_rng(seed), n_frames,
                                    n, window=window, step=step,
                                    depth=depth, density=density)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    advance_ms, forward_ms = [], []
    for t, f in enumerate(frames):
        before = sess.stats()
        sync()
        t0 = time.perf_counter()
        delta = sess.advance(f.coords, f.batch, f.valid)
        sync()
        t1 = time.perf_counter()
        sess.forward(model, f.feats[:, :cfg.in_ch])
        sync()
        t2 = time.perf_counter()
        advance_ms.append((t1 - t0) * 1e3)
        forward_ms.append((t2 - t1) * 1e3)
        if log is not None:
            inc = {k: v - before[k] for k, v in sess.stats().items()}
            log(f"frame {t:3d}: valid={int(f.valid.sum()):5d} "
                f"dirty={int(delta.n_dirty_rows):5d} "
                f"levels(delta/full/hit)={inc['delta_levels']}/"
                f"{inc['full_levels']}/{inc['content_hit_levels']} "
                f"searched={inc['rows_searched']:5d}"
                f"/{inc['rows_scratch']:5d} "
                f"plan={t1 - t0:6.3f}s fwd={t2 - t1:6.3f}s")
    stats = sess.stats()
    sess.close()
    out = {
        **stats,
        "advance_ms_mean": float(np.mean(advance_ms)),
        "forward_ms_mean": float(np.mean(forward_ms)),
        "search_fraction":
            stats["rows_searched"] / max(stats["rows_scratch"], 1),
        "reused_kmap_row_fraction":
            stats["kmap_rows_reused"] / max(stats["kmap_rows_total"], 1),
        "pinned": store.stats(),
    }
    if log is not None:
        log(f"-- {stats['frames']} frames: searched "
            f"{out['search_fraction']:.1%} of the from-scratch rows, "
            f"reused {out['reused_kmap_row_fraction']:.1%} of kmap rows, "
            f"advance {out['advance_ms_mean']:.1f} ms/frame "
            f"(forward {out['forward_ms_mean']:.1f} ms)")
        log(f"   pinned store: {out['pinned']}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="tiny")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--voxels", type=int, default=None)
    ap.add_argument("--max-blocks", type=int, default=None)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--density", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impl", default=None, choices=("kernel", "ref"),
                    help="OCTENT search impl (default: kernel)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--no-stream", action="store_true",
                    help="disable the delta path (from-scratch baseline)")
    ap.add_argument("--pinned-bytes", type=int, default=None,
                    help="private PinnedStore byte budget (default: the "
                         "process-wide store)")
    args = ap.parse_args()
    voxels, window, step, depth, density = (
        given if given is not None else default for given, default in zip(
            (args.voxels, args.window, args.step, args.depth, args.density),
            FRAMES[args.config]))
    run_stream(CONFIGS[args.config], args.frames, voxels,
               max_blocks=args.max_blocks, window=window, step=step,
               depth=depth, density=density, seed=args.seed, impl=args.impl,
               enabled=False if args.no_stream else None,
               pinned_bytes=args.pinned_bytes, device=args.device)


if __name__ == "__main__":
    main()
