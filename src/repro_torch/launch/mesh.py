"""Production and test meshes, the reference's ``src/repro/launch/mesh.py``.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
dimensions over the active process group: the caller's real group (one
process a rank, as ``launch/spconv_sharded.spawn_ranks`` starts them), or
a fake world. :func:`fake_world` joins torch's ``fake`` backend as rank 0
of ``n``: collectives return at once and move nothing, which is all a dry
run on ``meta`` tensors needs (``launch/dryrun.py``). A mesh's device type
is ``cuda`` over NCCL and ``cpu`` over gloo and the fake backend (DTensor
prices its redistributions by the devices of the mesh's type, which a
``meta`` mesh lacks); on a ``cpu`` mesh DTensor replaces an all-to-all by
an all-gather and a chunk. Nothing here initializes a group at import.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

PRODUCTION_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """``with fake_world(n):`` runs the body as ``rank`` of a fake process
    group of ``n`` ranks; the group is destroyed on exit. Refuses to nest
    in an initialized group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape, names, device_type: str | None):
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.arange(world, dtype=torch.int).reshape(shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """(16, 16) ``data`` x ``model``, or (2, 16, 16) with ``pod`` in front,
    over the active group (256 or 512 ranks)."""
    if multi_pod:
        return _mesh(MULTI_POD_SHAPE, ("pod", "data", "model"), device_type)
    return _mesh(PRODUCTION_SHAPE, ("data", "model"), device_type)


def make_test_mesh(n_data: int = 2, n_model: int = 4, *,
                   device_type: str | None = None):
    """The tests' small ``data`` x ``model`` mesh (8 ranks by default)."""
    return _mesh((n_data, n_model), ("data", "model"), device_type)
