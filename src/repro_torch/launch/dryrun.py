"""Multi-pod dry run: size every (arch x shape x mesh) cell for H100s, the
port's counterpart of the reference's ``src/repro/launch/dryrun.py``.

For each applicable cell the train, prefill or decode step runs once on
``meta`` tensors: parameters, optimizer state, inputs and cache are
DTensors placed by ``launch/shardings.py`` on the (16, 16) single-pod or
(2, 16, 16) multi-pod mesh, laid over a fake world of 256 or 512 ranks
(``launch/mesh.fake_world``), so nothing is allocated and no card is
touched. It records, per cell:

* each device's argument bytes, split into params, optimizer, batch and
  cache: exact, from the shard shapes;
* ``temp_bytes``, the counterpart of XLA's ``temp_size_in_bytes``: the
  peak of the bytes live on rank 0 above the arguments while the step
  runs (``hlo_analysis.CostMode``'s walk of the storages each op makes
  and frees, the step's outputs included); ``fits`` compares arguments
  plus temporaries with one H100's 80 GB;
* FLOPs, bytes accessed and collective bytes and counts by kind, counted
  on rank 0's local ops by ``hlo_analysis.CostMode`` and scaled by the
  mesh size to whole-program totals, as the reference scales XLA's
  per-device ``cost_analysis``;
* ``model_flops``, ``useful_flops_ratio`` and the roofline terms at the
  H100's constants (``hlo_analysis.roofline_terms``).

The count is eager, so it sees every layer: it runs at full depth
where the reference counts depths 1 and 2 and extrapolates (XLA counts a
loop body once); :func:`measure_costs` keeps that extrapolation, the
peak of live bytes included, to check the two agree. The walk counts
each storage's exact bytes; a card's caching allocator rounds blocks up,
so its peak lies a little above (phase ``dryrun``'s cross-check on the
card holds the two together). No kernel runs on ``meta``: the step takes the plain
versions (``impl="ref"``), recorded as ``"impl": "ref"``. The counted path
has no host read of a tensor (``.item()``, ``int(t)``, ``torch.nonzero``),
which ``meta`` tensors refuse: every size it uses is a host integer of the
config and the cell.

``--donate`` is the reference's ``donate_argnums`` of the train step: the
step is ``make_train_step(donate=True)``, whose AdamW
(``adamw.update_``) writes the new parameters and moments into the
state's own tensors, so no second copy of the state is live and a train
cell's ``temp_bytes`` drops by up to the state's bytes. Prefill and
decode cells are the same either way. Every record carries ``"donate"``;
donated records are written under their own file tag. The reference's
``--save-hlo`` has no counterpart: torch emits no HLO.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --mesh single [--donate]

Results go to ``--out`` (default ``build/dryrun/``), one JSON file a cell,
resumable (``--force`` reruns); ``--jobs N`` runs cells in N processes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs import (SHAPE_CELLS, cell_applicable, get_config,
                                 list_archs)
from repro_torch.launch import hlo_analysis, shardings
from repro_torch.launch import mesh as meshlib
from repro_torch.models import api, common
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as rs

RESULTS_DIR = os.path.join("build", "dryrun")
#: one H100 SXM5's memory, the datasheet's 80 GB
H100_HBM_BYTES = 80 * 10 ** 9
#: mesh kind -> (ranks, the mesh over a fake world of that many)
MESH_KINDS = {
    "single": (256, lambda: meshlib.make_production_mesh()),
    "multi": (512, lambda: meshlib.make_production_mesh(multi_pod=True)),
    "test": (8, lambda: meshlib.make_test_mesh(2, 4)),
    "one": (1, lambda: meshlib.make_test_mesh(1, 1)),
}


class Cell(NamedTuple):
    """A built cell: ``fn(*args)`` runs its step; ``groups`` maps each
    argument group (params, optimizer, batch, cache) to its (full meta
    tensors, shardings), from which :func:`device_bytes` sizes a device."""

    fn: Callable[..., Any]
    args: tuple
    groups: dict


def build_cell(model: api.Model, cell, mesh, *, strategy: str = "tp",
               kv_layout: str = "kv", donate: bool = False) -> Cell:
    """The step of ``cell`` (train: ``make_train_step``, in place on its
    state if ``donate``; prefill; decode: one step against a
    ``cell.seq_len``-deep cache) with its arguments as ``meta`` DTensors
    placed on ``mesh``; the plain versions throughout."""
    from repro_torch.launch.train import make_train_step
    flat = dict(model.module(common.META).state_dict())
    p_sh = shardings.param_shardings(flat, mesh, strategy)
    params = shardings.distribute(flat, p_sh)
    batch = model.input_specs(cell)
    b_sh = shardings.batch_shardings(batch, mesh)
    dbatch = shardings.distribute(batch, b_sh)
    groups = {"params": (flat, p_sh), "batch": (batch, b_sh)}

    if cell.kind == "train":
        opt = adamw.init(flat)
        o_sh = shardings.opt_state_shardings(opt, mesh, strategy)
        groups["optimizer"] = (opt, o_sh)
        step = make_train_step(model, adamw.AdamWConfig(), impl="ref",
                               donate=donate)
        return Cell(step, ((params, shardings.distribute(opt, o_sh)),
                           dbatch), groups)
    if cell.kind == "prefill":
        def prefill(p, b):
            return model.prefill(model.nest(p), b, cell.seq_len, impl="ref")
        return Cell(prefill, (params, dbatch), groups)
    cache = api.abstract_cache(model, cell)
    c_sh = shardings.cache_shardings(cache, mesh, kv_layout)
    groups["cache"] = ({k: v for k, v in cache.items()
                        if isinstance(v, torch.Tensor)}, c_sh)

    def decode(p, c, t):
        return model.decode_step(model.nest(p), c, t)
    return Cell(decode, (params, shardings.distribute(cache, c_sh),
                         dbatch["tokens"]), groups)


def device_bytes(built: Cell) -> dict[str, int]:
    """Bytes one device holds of each argument group: exact, from the
    shard shapes."""
    return {g: shardings.device_bytes(t, sh)
            for g, (t, sh) in built.groups.items()}


def count_step(built: Cell, mesh, warm: Cell | None = None
               ) -> hlo_analysis.CostMode:
    """The per-device (rank 0's) counts of the built step under
    :class:`hlo_analysis.CostMode`. ``warm`` (default: the step itself)
    runs once before, uncounted: DTensor's first call of an op on new
    placements runs ops of its own (strategy search by decomposition)
    that are not the program's. A shallower build of the same cell warms
    every op the step calls, since its layers are alike."""
    warm = built if warm is None else warm
    with rs.set_mesh(mesh):
        warm.fn(*warm.args)
    return _count(built, mesh)


def _count(built: Cell, mesh) -> hlo_analysis.CostMode:
    """:func:`count_step` without its warm-up."""
    with rs.set_mesh(mesh), hlo_analysis.CostMode() as cm:
        built.fn(*built.args)
    return cm


def _depth_variants(cfg):
    """Two shallow same-width configs + the unit count for extrapolation:
    total = F(d1) + (units - 1) * (F(d2) - F(d1)), exact for homogeneous
    stacks (RecurrentGemma's groups: both variants carry the same tail)."""
    if cfg.family == "rglru":
        tail = cfg.n_layers % 3
        return (dataclasses.replace(cfg, n_layers=3 + tail),
                dataclasses.replace(cfg, n_layers=6 + tail),
                cfg.n_layers // 3)
    return (dataclasses.replace(cfg, n_layers=1),
            dataclasses.replace(cfg, n_layers=2), cfg.n_layers)


def _totals(cm: hlo_analysis.CostMode, n: int) -> dict:
    coll = cm.collectives
    return {"flops": float(cm.flops) * n, "bytes": float(cm.bytes) * n,
            "temp": float(cm.peak_bytes),
            "coll": float(coll.total_bytes) * n,
            "coll_by_kind": {k: v * n for k, v in coll.bytes_by_kind.items()}}


def measure_costs(cfg, cell, mesh, *, strategy: str = "tp",
                  kv_layout: str = "kv", donate: bool = False) -> dict:
    """The reference's depth-1/2 extrapolation of FLOPs, bytes and
    collective bytes to the full depth (whole-program totals), and of the
    peak of live bytes a device (``temp_bytes``): each depth unit holds
    the same saved activations and caches, so the peak grows by one
    unit's bytes a unit as the counts do."""
    c1, c2, units = _depth_variants(cfg)
    b1, b2 = (build_cell(api.build_model(c, device="meta"), cell, mesh,
                         strategy=strategy, kv_layout=kv_layout,
                         donate=donate)
              for c in (c1, c2))
    # the deeper one's warm-up warms both
    meas = {"d1": _totals(count_step(b1, mesh, b2), mesh.size()),
            "d2": _totals(_count(b2, mesh), mesh.size())}

    def extrap(a, b):
        return a + (units - 1) * max(b - a, 0.0)

    kinds = set(meas["d1"]["coll_by_kind"]) | set(meas["d2"]["coll_by_kind"])
    return {"flops": extrap(meas["d1"]["flops"], meas["d2"]["flops"]),
            "bytes": extrap(meas["d1"]["bytes"], meas["d2"]["bytes"]),
            "temp_bytes": extrap(meas["d1"]["temp"], meas["d2"]["temp"]),
            "collective_bytes": extrap(meas["d1"]["coll"],
                                       meas["d2"]["coll"]),
            "collective_bytes_by_kind": {
                k: extrap(meas["d1"]["coll_by_kind"].get(k, 0.0),
                          meas["d2"]["coll_by_kind"].get(k, 0.0))
                for k in kinds},
            "depth_units": units}


def run_cell(arch: str, shape: str, mesh_kind: str, *, strategy: str = "tp",
             kv_layout: str = "kv", donate: bool = False, cfg=None,
             cell=None) -> dict:
    """One cell's record (the reference's fields; ``cfg`` / ``cell``
    override the arch's config and the shape's cell, for reduced runs).
    Runs in a fake world of the mesh's size, which it leaves on return."""
    cfg = get_config(arch) if cfg is None else cfg
    cell = SHAPE_CELLS[shape] if cell is None else cell
    ok, why = cell_applicable(cfg, cell)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "kind": cell.kind, "status": "skip", "skip_reason": why,
           "strategy": strategy, "kv_layout": kv_layout, "donate": donate,
           "impl": "ref"}
    if not ok:
        return rec
    n_chips, make_mesh = MESH_KINDS[mesh_kind]
    with meshlib.fake_world(n_chips):
        mesh = make_mesh()
        if strategy == "pure_dp":
            rs.set_batch_axes(("pod", "data", "model"))
        try:
            t0 = time.perf_counter()
            built = build_cell(api.build_model(cfg, device="meta"), cell,
                               mesh, strategy=strategy, kv_layout=kv_layout,
                               donate=donate)
            per_dev = device_bytes(built)
            t_build = time.perf_counter() - t0
            t0 = time.perf_counter()
            # warmed at the extrapolation's second depth, whose layers and
            # their seams are the full step's
            shallow = _depth_variants(cfg)[1]
            warm = None if shallow.n_layers >= cfg.n_layers else build_cell(
                api.build_model(shallow, device="meta"), cell, mesh,
                strategy=strategy, kv_layout=kv_layout, donate=donate)
            cm = count_step(built, mesh, warm)
            t_count = time.perf_counter() - t0
        finally:
            rs.set_batch_axes(("pod", "data"))
    tot = _totals(cm, n_chips)
    arg_bytes = sum(per_dev.values())
    temp = cm.peak_bytes
    mf = hlo_analysis.model_flops(cfg, cell)
    rec.update({
        "status": "ok", "n_chips": n_chips,
        "build_s": t_build, "count_s": t_count,
        "bytes_per_device": per_dev, "argument_bytes": arg_bytes,
        "temp_bytes": temp, "temp_storages": cm.peak_storages,
        "fits": arg_bytes + temp <= H100_HBM_BYTES,
        "hlo_flops": tot["flops"], "hlo_bytes": tot["bytes"],
        "collective_bytes": tot["coll"],
        "collective_bytes_by_kind": tot["coll_by_kind"],
        "collective_count_by_kind": dict(cm.collectives.count_by_kind),
        "local_ops": cm.n_ops,
        "depth_units": _depth_variants(cfg)[2],
        "model_flops": mf,
        "useful_flops_ratio": mf / tot["flops"] if tot["flops"] else 0.0,
        **hlo_analysis.roofline_terms(tot["flops"], tot["bytes"],
                                      tot["coll"], n_chips),
    })
    return rec


def file_tag(tag: str = "", donate: bool = False) -> str:
    """The tag of a record's file: ``tag``, and ``donate`` after it for a
    donated run, so that donated and copying records never share a
    file."""
    return "__".join(t for t in (tag, "donate" if donate else "") if t)


def result_path(out_dir, arch, shape, mesh_kind, tag=""):
    suffix = f"__{tag}" if tag else ""
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}{suffix}.json")


def run_job(job) -> dict:
    """One ``(arch, shape, mesh, knobs)`` job, as a worker process runs
    it: the knobs set, then :func:`run_cell`; a failure becomes a
    ``fail`` record."""
    arch, shape, mesh_kind, knobs = job
    torch.set_num_threads(1)
    _apply_knobs(knobs)
    try:
        return run_cell(arch, shape, mesh_kind, strategy=knobs["strategy"],
                        kv_layout=knobs["cache_shard"],
                        donate=knobs["donate"])
    except Exception as e:                               # noqa: BLE001
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "donate": knobs["donate"],
                "status": "fail", "error": repr(e),
                "traceback": traceback.format_exc()}


def _apply_knobs(knobs: dict) -> None:
    if knobs.get("remat"):
        from repro_torch.models import transformer
        transformer.set_remat_mode(knobs["remat"])
    if knobs.get("moe_impl"):
        from repro_torch.models import moe
        moe.set_moe_impl(knobs["moe_impl"])


def run_grid(cells, *, knobs: dict, jobs: int = 1):
    """Yield the record of each (arch, shape, mesh) of ``cells`` (in order
    with one job, as they finish with more);
    ``jobs`` > 1 runs them in that many spawned processes (each cell in
    its own fake world)."""
    grid = [(a, s, m, knobs) for a, s, m in cells]
    if jobs <= 1:
        yield from map(run_job, grid)
        return
    import multiprocessing as mp
    with mp.get_context("spawn").Pool(jobs) as pool:
        yield from pool.imap_unordered(run_job, grid, chunksize=1)


def _summary(rec: dict) -> str:
    if rec["status"] != "ok":
        return rec.get("skip_reason") or rec.get("error", "")
    b = rec["bytes_per_device"]
    return (f"fits={rec['fits']} GB/device "
            + " ".join(f"{k}={v / 1e9:.3f}" for k, v in b.items())
            + f" temp={rec['temp_bytes'] / 1e9:.3f}"
            + f" compute={rec['compute_s']:.3e}s memory={rec['memory_s']:.3e}s"
            f" coll={rec['collective_s']:.3e}s count={rec['count_s']:.1f}s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="perf-iteration tag")
    ap.add_argument("--remat", default=None,
                    choices=[None, "full", "dots", "dots_no_batch"])
    ap.add_argument("--strategy", default="tp", choices=["tp", "pure_dp"])
    ap.add_argument("--moe-impl", default=None,
                    choices=[None, "einsum", "shard_map"])
    ap.add_argument("--cache-shard", default="kv", choices=["kv", "ctx"])
    ap.add_argument("--donate", action="store_true",
                    help="train cells update their state in place")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPE_CELLS) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)
    knobs = {"remat": args.remat, "moe_impl": args.moe_impl,
             "strategy": args.strategy, "cache_shard": args.cache_shard,
             "donate": args.donate}
    tag = file_tag(args.tag, args.donate)
    todo = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                path = result_path(args.out, arch, shape, mesh_kind, tag)
                if os.path.exists(path) and not args.force:
                    print(f"[cached] {arch} {shape} {mesh_kind}")
                    continue
                todo.append((arch, shape, mesh_kind))
    n = {"ok": 0, "skip": 0, "fail": 0}
    _apply_knobs(knobs)
    for rec in run_grid(todo, knobs=knobs, jobs=args.jobs):
        rec["tag"] = args.tag
        with open(result_path(args.out, rec["arch"], rec["shape"],
                              rec["mesh"], tag), "w") as f:
            json.dump(rec, f, indent=1)
        n[rec["status"]] += 1
        print(f"[{rec['status']}] {rec['arch']} {rec['shape']} "
              f"{rec['mesh']}: {_summary(rec)}", flush=True)
    print(f"done: ok={n['ok']} skip={n['skip']} fail={n['fail']}")


if __name__ == "__main__":
    main()
