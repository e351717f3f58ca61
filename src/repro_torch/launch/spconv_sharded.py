"""Serve MinkUNet under a device mesh, one process a rank.

The reference runs a model under a mesh in one process: ``set_mesh``
makes the mesh active and ``shard_map`` runs the search body once a
device. The port's form is one process a rank of a ``torch.distributed``
process group. :func:`spawn_ranks` starts the ranks, each joining the
group through a file store (parallel test workers never race for a TCP
port), and :func:`make_mesh` lays a ``DeviceMesh`` with named dimensions
(``pod``, ``data``, ``model``) over them. Inside
``runtime.sharding.set_mesh(mesh)`` every Subm3 search of
``minkunet.forward_multicloud`` runs the sharded OCTENT search
(``kernels/octent/sharded.py``): each rank holds one key range of the
octree table, and the kmaps, hence the logits, are bit-equal to one
device's.

CLI (every rank serves the same scenes and prints its digests)::

    python -m repro_torch.launch.spconv_sharded --shape 2,2 \\
        --names data,model [--backend gloo] [--device cpu] [--rows N]

Rank r runs on card ``r % device_count``. The backend defaults to NCCL
when every rank has a card of its own, else to gloo (NCCL takes one rank
a card, so two or more ranks sharing a card run over gloo; it takes their
CUDA tensors as they are). The scenes are :func:`serve_scenes` at
``--rows`` rows from ``--seed`` (LiDAR at :data:`LIDAR_VOXEL`), and the model MinkUNet-large
(``--config small`` for a quick CPU run) with weights drawn from
``--seed``.
"""
from __future__ import annotations

import argparse
import datetime
import hashlib
import math
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

LIDAR_VOXEL = 0.0125   # the CLI's LiDAR voxel size: 4 x this = a 5 cm grid


def _rank_main(rank, fn, world, backend, init_file, timeout_s):
    args = torch.load(f"{init_file}.args", weights_only=False)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, *args)
        torch.save(out, f"{init_file}.rank{rank}")
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, *, backend: str, init_file: str,
                args: tuple = (), timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes, the ranks of
    one process group, and return their results in rank order.

    ``fn`` must be picklable (a module-level function) and its result
    ``torch.save``-able, and so must ``args`` be: they reach the ranks
    through a file next to ``init_file``, written here before any rank
    starts, and each rank loads its own copy. The caller's tensors are
    only read. (Pickled through ``multiprocessing`` instead, each CPU
    tensor's storage would be moved into shared memory in place, freeing
    the old buffer under any other thread of the caller that reads the
    tensor at that moment, and the ranks would share one copy.)
    ``init_file`` is the rendezvous file of
    ``init_process_group(init_method="file://...")``: a path that does not
    exist yet, in a directory the ranks can write (it and the files next
    to it are removed on return). A rank that raises makes this raise with
    its traceback; ranks still running after ``timeout_s`` are killed and
    TimeoutError is raised, so a lost collective fails instead of hanging.
    """
    if os.path.exists(init_file):
        raise ValueError(f"{init_file} exists: the file rendezvous needs a "
                         f"fresh path")
    outs = [f"{init_file}.rank{r}" for r in range(world)]
    torch.save(tuple(args), f"{init_file}.args")
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, backend, init_file, timeout_s),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout_s} s")
        return [torch.load(p, weights_only=False) for p in outs]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
        for p in [init_file, f"{init_file}.args", *outs]:
            if os.path.exists(p):
                os.remove(p)


def make_mesh(shape, names, device="cpu", ranks=None):
    """A ``DeviceMesh`` of ``shape`` with dimension ``names`` over the
    global ``ranks`` (default: ``0 .. prod(shape)-1``) on ``device``'s
    type. Every rank of the default group must call it, members or not:
    the mesh's groups are created collectively."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, names = tuple(shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in "
                         f"length")
    if ranks is None:
        ranks = range(math.prod(shape))
    grid = torch.tensor(list(ranks), dtype=torch.int).reshape(shape)
    return DeviceMesh(torch.device(device).type, grid, mesh_dim_names=names)


def serve_scenes(rows: int, seed: int, lidar_voxel: float):
    """Four ``(rid, VoxelBatch)`` scenes of ``rows`` rows: two LiDAR
    scenes at voxel size ``lidar_voxel`` from seeds ``seed`` and
    ``seed + 1``, two indoor ones from ``seed + 10`` and ``seed + 11``."""
    from repro_torch.data import pointcloud
    lidar = [(f"lidar-{i}", pointcloud.make_batch(
        np.random.default_rng(seed + i), "lidar", 1, rows,
        voxel_size=lidar_voxel)) for i in range(2)]
    indoor = [(f"indoor-{i}", pointcloud.make_batch(
        np.random.default_rng(seed + 10 + i), "indoor", 1, rows))
        for i in range(2)]
    return lidar + indoor


def _serve_rank(rank, shape, names, device, config, rows, seed,
                lidar_voxel):
    from repro_torch.core.spconv import SparseTensor
    from repro_torch.models import minkunet
    from repro_torch.runtime import sharding
    dev = torch.device(device)
    cfg = minkunet.LARGE if config == "large" else minkunet.SMALL
    model = minkunet.MinkUNet(cfg, device=dev,
                              generator=torch.Generator().manual_seed(seed))
    scenes = serve_scenes(rows, seed, lidar_voxel)
    clouds = [SparseTensor(*(torch.as_tensor(a, device=dev) for a in (
        vb.coords, vb.batch, vb.valid, vb.feats))) for _, vb in scenes]
    mesh = make_mesh(shape, names, device)
    with sharding.set_mesh(mesh):
        outs = minkunet.forward_multicloud(model, clouds)
    return {rid: hashlib.sha256(o.cpu().numpy().tobytes()).hexdigest()
            for (rid, _), o in zip(scenes, outs)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", default="2", help="mesh shape, e.g. 2,2")
    ap.add_argument("--names", default="data",
                    help="mesh dimension names, e.g. data,model")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: nccl when every rank has "
                         "a card of its own, else gloo)")
    ap.add_argument("--device", default=None)
    ap.add_argument("--config", choices=("large", "small"), default="large")
    ap.add_argument("--rows", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)
    shape = tuple(int(x) for x in args.shape.split(","))
    names = tuple(args.names.split(","))
    world = math.prod(shape)
    backend = args.backend or (
        "nccl" if dev.type == "cuda" and world <= torch.cuda.device_count()
        else "gloo")
    with tempfile.TemporaryDirectory() as tmp:
        digests = spawn_ranks(
            _serve_rank, world, backend=backend,
            init_file=os.path.join(tmp, "rendezvous"),
            args=(shape, names, str(dev), args.config, args.rows, args.seed,
                  LIDAR_VOXEL))
    for rank, d in enumerate(digests):
        for rid, h in d.items():
            print(f"rank {rank} {rid} {h}")
    same = all(d == digests[0] for d in digests)
    print(f"mesh {dict(zip(names, shape))} over {backend}: "
          f"{'every rank served the same logits' if same else 'RANKS DIFFER'}")
    if not same:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
