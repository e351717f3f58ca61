#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a host with one CUDA card:

    python3 chip_smoke.py

It builds both hand-written kernels from the checkout's sources, holds
each against its plain PyTorch version on the card at the shapes the
serving path gives it, then serves MinkUNet-large (full published widths
and depth, seeded random weights) through ``ServeEngine`` and checks the
launch counts and the logits against the same forward through the plain
versions. Output is one JSON object per line; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no last line. It also exits non-zero when no
CUDA device is visible or when ``src/repro_torch`` is not beside it.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
BUCKET = 65536                 # padding bucket of the served requests
LIDAR_VOXEL = 0.0125           # make_batch lidar voxel: 4 x this = 5 cm
TOL_KERNEL = 1e-4              # f32, another summation order than plain
TOL_LOGITS = 1e-3              # 25 layers of it, relative to max |logit|
DEAD_SHARE = 0.125             # of rows (and per Cin block) zeroed by tile
# published peaks of one H100 SXM (NVIDIA data sheet, 700 W)
PEAK_F32_FLOPS = 67e12         # float32 outside the tensor cores
PEAK_BYTES_S = 3.35e12         # HBM3
OCTENT_SRC = "src/repro_torch/csrc/octent_query.cu"
GEMM_SRC = "src/repro_torch/csrc/spconv_gemm_fused.cu"


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch
    from repro_torch.kernels import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    reports = build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in reports.items()}
    emit(phase="device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), build_s=build_s, ptxas=ptxas)
    return smi


def phase_octent(dev, scene):
    """Kernel 1 on a real scene against its plain version and the host
    hash oracle."""
    import torch
    from repro_torch.core import mapsearch, morton
    from repro_torch.kernels.octent import kernel as oct_kernel
    from repro_torch.kernels.octent import ops as oct_ops
    from repro_torch.kernels.octent.ref import octent_query_ref
    c, b, v = (torch.as_tensor(a, device=dev)
               for a in (scene.coords, scene.batch, scene.valid))
    offs = torch.as_tensor(morton.subm3_offsets(), device=dev)
    qt = oct_ops.build_query_table(c, b, v, max_blocks=BUCKET)
    args = (c, b, v, offs, qt.ublocks, qt.tkey, qt.tval, qt.n_blocks)
    got = oct_kernel.octent_query(*args)
    want = octent_query_ref(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "octent_query differs from its plain version")
    rng = np.random.default_rng(SEED)
    rows = rng.choice(np.flatnonzero(scene.valid), 2000, replace=False)
    host = mapsearch.build_kmap_hash(scene.coords, scene.batch, scene.valid,
                                     morton.subm3_offsets())
    check(np.array_equal(got.cpu().numpy()[rows], host[rows]),
          "octent_query differs from the host hash oracle")
    ms = time_ms(lambda: oct_kernel.octent_query(*args), 50)
    plain_ms = time_ms(lambda: octent_query_ref(*args), 5)
    # bytes the function needs: every valid flag, coords and batch of the
    # valid rows only, the live prefix of ublocks, the non-sentinel table
    # entries, the offsets and n_blocks, and the whole (N, K) kmap out
    n, k = c.shape[0], offs.shape[0]
    n_valid = int(v.sum())
    live_blocks = min(int(qt.n_blocks), qt.ublocks.numel())
    n_table = int((qt.tkey < BUCKET * morton.TABLE_SIZE).sum())
    nbytes = (n + 16 * n_valid + 4 * live_blocks + 8 * n_table
              + k * 3 * 4 + 4 + n * k * 4)
    bound_ms = nbytes / PEAK_BYTES_S * 1e3
    emit(phase="octent_query", voxels=int(scene.valid.sum()),
         blocks=int(qt.n_blocks), rows=n, hits=int((got >= 0).sum()),
         equal_to_plain=True, hash_rows_checked=int(rows.size), ms=ms,
         plain_ms=plain_ms, bound_ms=bound_ms, bytes=nbytes)
    return {"name": "octent_query", "route": "cuda", "source": OCTENT_SRC,
            "replaces": "src/repro/kernels/octent/kernel.py:122",
            "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def model_layers(cfg, plans, valids):
    """The 25 SpConv layers of one MinkUNet forward as (name, plan,
    in_valid, out_valid, Cin, Cout, is_subm), in forward order."""
    n_enc = len(cfg.enc)
    layers = [("stem", plans.subm[0], valids[0], valids[0], cfg.in_ch,
               cfg.stem, True)]
    c_prev, skips = cfg.stem, [cfg.stem]
    for i, c in enumerate(cfg.enc):
        layers.append((f"enc{i}.down", plans.down[i], valids[i],
                       valids[i + 1], c_prev, c, False))
        layers += [(f"enc{i}.block{b}", plans.subm[i + 1], valids[i + 1],
                    valids[i + 1], c, c, True) for b in range(cfg.blocks)]
        c_prev = c
        skips.append(c)
    for i, c in enumerate(cfg.dec):
        r = n_enc - 1 - i
        layers.append((f"dec{i}.up", plans.up[i], valids[r + 1], valids[r],
                       c_prev, c, False))
        layers += [(f"dec{i}.block{b}", plans.subm[r], valids[r], valids[r],
                    c + skips[-(i + 2)] if b == 0 else c, c, True)
                   for b in range(cfg.blocks)]
        c_prev = c
    return layers


def _kill_tiles(f, tiles, bk, rng):
    """Zero features so that whole tiles and whole (tile, Cin-block) pairs
    are dead, as post-ReLU activations make them: first the rows gathered
    by seeded live tiles, up to DEAD_SHARE of the nonzero rows, then, for
    each bk-wide Cin block, that block alone on the rows of further seeded
    tiles that are still live. Without this, relu(randn) features leave no
    tile and no block dead, and the kernel's two skip branches would never
    be held against the plain version at full size."""
    import torch
    from repro_torch.core import sparsity
    g = tiles.gather_idx.reshape(-1, tiles.bm).cpu().numpy()
    sv = tiles.slot_valid.reshape(-1, tiles.bm).cpu().numpy()
    rows_of = {t: np.unique(g[t][sv[t]]) for t in np.flatnonzero(sv.any(1))}
    share = int(DEAD_SHARE * int(sparsity.row_nonzero(f).sum()))

    def pick(tiles_left):
        """Rows of seeded tiles, whole tiles only, up to the share (or the
        smallest tile, so that at least one is taken), and those tiles."""
        budget = max(share, min(rows_of[t].size for t in tiles_left))
        mask, used, taken = np.zeros(f.shape[0], bool), 0, set()
        for t in rng.permutation(tiles_left):
            new = rows_of[t][~mask[rows_of[t]]]
            if used + new.size <= budget:
                mask[new], used = True, used + new.size
                taken.add(t)
        return mask, taken

    dead, _ = pick(list(rows_of))
    f = f.clone()
    f[torch.as_tensor(dead, device=f.device)] = 0
    # each block on other tiles, so that no tile loses all its blocks
    alive = [t for t, r in rows_of.items() if not dead[r].all()]
    for b in range(f.shape[1] // bk):
        rows, taken = pick(alive)
        f[torch.as_tensor(rows, device=f.device), b * bk:(b + 1) * bk] = 0
        alive = [t for t in alive if t not in taken] or alive
    return f


def phase_gemm(dev, scene, cfg):
    """Kernel 2 at every distinct layer shape of the model on the scene's
    plans, in both modes, against its plain version, on features with
    dead tiles and dead Cin blocks so that both skip branches run."""
    import torch
    from repro_torch.core import sparsity
    from repro_torch.kernels.spconv_gemm import ops as sg_ops
    from repro_torch.kernels.spconv_gemm.kernel import spconv_gemm_fused
    from repro_torch.kernels.spconv_gemm.ref import spconv_gemm_fused_ref
    from repro_torch.models import minkunet
    plans = minkunet.build_plans(scene.coords, scene.batch, scene.valid, cfg,
                                 device=dev)
    valids = [torch.as_tensor(scene.valid, device=dev)] + [
        d.out_valid for d in plans.down]
    layers = model_layers(cfg, plans, valids)
    check(len(layers) == 25, f"expected 25 layers, got {len(layers)}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    per_shape = {}
    for name, plan, vin, vout, cin, cout, subm in layers:
        key = (id(plan), cin, cout)
        if key in per_shape:
            per_shape[key]["layers"].append(name)
            continue
        k, bk = plan.n_taps, sg_ops.pick_bk(cin)
        f = torch.relu(torch.randn((vin.shape[0], cin), generator=gen,
                                   device=dev))
        f = torch.where(vin[:, None], f, 0.0)
        f = _kill_tiles(f, plan.tiles, bk, rng)
        w = torch.randn((k, cin, cout), generator=gen, device=dev) \
            * (2.0 / (k * cin)) ** 0.5
        row_nz = sparsity.row_nonzero(f)
        blk_nz = sparsity.row_block_nonzero(f, bk) & row_nz[:, None]
        gidx = plan.tiles.gather_idx.long()
        live_slot = plan.tiles.slot_valid & row_nz[gidx]
        live = int(live_slot.sum())
        # work this data needs: the live Cin blocks of each live map, and
        # the live blocks of the feature rows read once
        live_blocks = int((blk_nz[gidx] & live_slot[:, None]).sum())
        flops = 2.0 * live_blocks * bk * cout
        nbytes = 4.0 * (int(blk_nz.sum()) * bk + k * cin * cout
                        + int(vout.sum()) * cout) + 8.0 * live
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
        rec = {"layers": [name], "cin": cin, "cout": cout, "taps": k,
               "bk": bk, "live_maps": live, "flops": flops, "bytes": nbytes,
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "ops_ms": t_ops * 1e3, "bytes_ms": t_bytes * 1e3}
        modes = [("plain", None)]
        if subm:
            epi = sg_ops.FusedEpilogue(
                scale=torch.rand(cout, generator=gen, device=dev) + 0.5,
                shift=torch.rand(cout, generator=gen, device=dev) - 0.5,
                valid=vout)
            modes.append(("epilogue", epi))
        for mode, epi in modes:
            args, kw = sg_ops.kernel_inputs(f, w, plan.tiles,
                                            n_out=plan.n_out, row_nz=row_nz,
                                            epilogue=epi)
            tile_nz, tile_bk_nz = args[5], args[7]
            rec["dead_tiles"] = int(((plan.tiles.tile_nz != 0)
                                     & (tile_nz == 0)).sum())
            rec["dead_blocks_in_live_tiles"] = int(
                ((tile_nz != 0)[:, None] & (tile_bk_nz == 0)).sum())
            check(rec["dead_tiles"] > 0,
                  f"{name}: no dead tile, the tile skip is not exercised")
            check(cin == bk or rec["dead_blocks_in_live_tiles"] > 0,
                  f"{name}: no dead Cin block in a live tile, the block "
                  f"skip is not exercised")
            got = spconv_gemm_fused(*args, **kw)
            want = spconv_gemm_fused_ref(*args, **kw)
            torch.cuda.synchronize()
            if epi is not None:
                (got, nz), (want, _) = got, want
                sweep = (got.reshape(got.shape[0], -1, 128) != 0).any(-1)
                check(torch.equal(nz, sweep.int()),
                      f"{name}: epilogue liveness is not a sweep of the "
                      f"kernel's own output")
            err = (got - want).abs().max().item()
            ref_max = want.abs().max().item()
            check(err <= TOL_KERNEL * max(ref_max, 1e-30),
                  f"{name} ({mode}): max|k-p| {err} > {TOL_KERNEL} * "
                  f"{ref_max}")
            rec[mode] = {
                "max_abs_err": err, "ref_max": ref_max,
                "ms": time_ms(lambda: spconv_gemm_fused(*args, **kw), 10),
                "plain_ms": time_ms(
                    lambda: spconv_gemm_fused_ref(*args, **kw), 3)}
        per_shape[key] = rec
        emit(phase="spconv_gemm_fused", **rec)
    # per request: every layer of one forward at its shape's time
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0,
             "bytes_ms": 0.0}
    for rec in per_shape.values():
        n = len(rec["layers"])
        total["ms"] += n * rec["plain"]["ms"]
        total["plain_ms"] += n * rec["plain"]["plain_ms"]
        for key in ("bound_ms", "ops_ms", "bytes_ms"):
            total[key] += n * rec[key]
    err = max(r[m]["max_abs_err"] for r in per_shape.values()
              for m in ("plain", "epilogue") if m in r)
    emit(phase="spconv_gemm_fused.per_request", shapes=len(per_shape),
         layers=len(layers), **total)
    return {"name": "spconv_gemm_fused", "route": "cuda", "source": GEMM_SRC,
            "replaces": "src/repro/kernels/spconv_gemm/kernel.py:287",
            "max_abs_err": err, "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": ("operations" if total["ops_ms"] >= total["bytes_ms"]
                         else "bytes"),
            "library_ms": None,
            "timing": "sum over the 25 layers of one forward, unfused mode"}


def _seeded_model(cfg, dev):
    """MinkUNet with seeded random weights and batch-norm statistics."""
    import torch
    from repro_torch.models import minkunet
    gen = torch.Generator().manual_seed(SEED)
    model = minkunet.MinkUNet(cfg, device=dev, generator=gen)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, minkunet.BatchNorm):
                c = mod.scale.shape[0]
                for t, lo, hi in ((mod.scale, 0.5, 1.5), (mod.bias, -0.2, 0.2),
                                  (mod.mean, -0.2, 0.2), (mod.var, 0.5, 2.0)):
                    t.copy_(torch.empty(c).uniform_(lo, hi, generator=gen))
    return model


def _counts():
    from repro_torch.core import plan as planlib
    from repro_torch.kernels.octent import kernel as oct_kernel
    from repro_torch.kernels.spconv_gemm import kernel as sg_kernel
    return (oct_kernel.launches, sg_kernel.launches,
            sg_kernel.epilogue_launches, planlib.MAPSEARCH_CALLS[0])


def _reset_counts():
    from repro_torch.core import plan as planlib
    from repro_torch.kernels.octent import kernel as oct_kernel
    from repro_torch.kernels.spconv_gemm import kernel as sg_kernel
    oct_kernel.launches = 0
    sg_kernel.launches = sg_kernel.epilogue_launches = 0
    planlib.MAPSEARCH_CALLS[0] = 0


def phase_serve(dev, cfg, scenes, warm):
    """The main path: ServeEngine over MinkUNet-large, one request per
    tick, then one request with the fused epilogue. Returns the launch
    counts of the whole run and the results."""
    import torch
    from repro_torch.launch.spconv_serve import ServeEngine
    from repro_torch.runtime import admission
    model = _seeded_model(cfg, dev)
    fused = _seeded_model(dataclasses.replace(cfg, fused_epilogue=True), dev)
    fused.load_state_dict(model.state_dict())
    engines = [ServeEngine(m, queue=admission.AdmissionQueue(
        buckets=(BUCKET,)), max_batch=1) for m in (model, fused)]
    for eng in engines:                    # CUDA/cuBLAS init, not measured
        eng.submit("warmup", *warm)
        eng.step()
    n_layers = 1 + len(cfg.enc) + len(cfg.dec) \
        + cfg.blocks * (len(cfg.enc) + len(cfg.dec))
    n_subm = 1 + cfg.blocks * (len(cfg.enc) + len(cfg.dec))
    want_per_req = (len(cfg.enc) + 1, n_layers, 2 * len(cfg.enc) + 1)
    _reset_counts()
    results = []
    for (rid, sc), eng in [(s, engines[0]) for s in scenes] + \
            [(("fused-" + scenes[0][0], scenes[0][1]), engines[1])]:
        before = _counts()
        eng.submit(rid, sc.coords, sc.batch, sc.valid, sc.feats)
        (res,) = eng.step()
        after = _counts()
        d = [a - b for a, b in zip(after, before)]
        check(res.status == "completed", f"{rid}: {res.status} {res.reason}")
        check(bool(np.isfinite(res.logits).all()), f"{rid}: non-finite logit")
        check((d[0], d[1], d[3]) == want_per_req,
              f"{rid}: (octent, gemm, searches) = {(d[0], d[1], d[3])}, "
              f"want {want_per_req}")
        check(d[2] == (n_subm if eng is engines[1] else 0),
              f"{rid}: {d[2]} epilogue launches")
        results.append((rid, sc, res))
    counts = _counts()
    lat = [r.latency_s for _, _, r in results[:len(scenes)]]
    vox = sum(int(sc.valid.sum()) for _, sc, _ in results[:len(scenes)])
    emit(phase="serve", config=cfg.name, bucket=BUCKET,
         requests=[{"rid": rid, "voxels": int(sc.valid.sum()),
                    "latency_ms": r.latency_s * 1e3, "digest": r.digest}
                   for rid, sc, r in results],
         latency_p50_ms=float(np.percentile(lat, 50)) * 1e3,
         voxels_per_s=vox / sum(lat),
         launches_per_request={"octent_query": want_per_req[0],
                               "spconv_gemm_fused": want_per_req[1],
                               "mapsearch": want_per_req[2]},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return model, results, counts


def phase_reference(dev, cfg, model, results):
    """Served logits against the same forward through the plain versions
    (search and gather-GEMM), and the fused-epilogue request against the
    unfused one."""
    import torch
    from repro_torch.core.spconv import SparseTensor
    from repro_torch.models import minkunet
    errs = {}
    by_rid = {rid: res for rid, _, res in results}
    for rid, sc, res in results:
        if rid.startswith("fused-"):
            want = by_rid[rid[len("fused-"):]].logits
        else:
            st = SparseTensor(*(torch.as_tensor(a, device=dev) for a in (
                sc.coords, sc.batch, sc.valid, sc.feats)))
            plans = minkunet.build_plans(st.coords, st.batch, st.valid, cfg,
                                         n_max=BUCKET, search_impl="ref",
                                         device=dev)
            want = minkunet.forward(model, st, plans=plans,
                                    impl="ref").cpu().numpy()
        scale = float(np.abs(want).max())
        err = float(np.abs(res.logits - want).max())
        check(err <= TOL_LOGITS * scale,
              f"{rid}: max|served - plain| {err} > {TOL_LOGITS} * {scale}")
        errs[rid] = {"max_abs_err": err, "max_abs_logit": scale}
    emit(phase="reference", tolerance=f"{TOL_LOGITS} * max|logit|", **errs)


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.data import pointcloud
    from repro_torch.models import minkunet
    dev = torch.device("cuda", 0)
    cfg = minkunet.LARGE

    t0 = time.perf_counter()
    phase_device()
    lidar = [pointcloud.make_batch(np.random.default_rng(SEED + i), "lidar",
                                   1, BUCKET, voxel_size=LIDAR_VOXEL)
             for i in range(2)]
    indoor = [pointcloud.make_batch(np.random.default_rng(SEED + 10 + i),
                                    "indoor", 1, BUCKET) for i in range(2)]
    warm = pointcloud.make_batch(np.random.default_rng(SEED + 99), "lidar",
                                 1, BUCKET, voxel_size=LIDAR_VOXEL)
    k1 = phase_octent(dev, lidar[0])
    k2 = phase_gemm(dev, lidar[0], cfg)
    scenes = [("lidar-0", lidar[0]), ("lidar-1", lidar[1]),
              ("indoor-0", indoor[0]), ("indoor-1", indoor[1])]
    model, results, counts = phase_serve(
        dev, cfg, scenes, (warm.coords, warm.batch, warm.valid, warm.feats))
    phase_reference(dev, cfg, model, results)
    k1["launches"], k2["launches"] = counts[0], counts[1]
    k2["epilogue_launches"] = counts[2]
    for k in (k1, k2):
        check(k["launches"] > 0, f"{k['name']} never launched on the path")
    emit(phase="done", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
