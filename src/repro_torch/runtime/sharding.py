"""The active device mesh and the block-key axes of the sharded search.

The reference names three mesh axes (its DESIGN.md §4):

* ``pod``   — inter-pod axis: data parallelism / pipeline stages only.
* ``data``  — intra-pod data parallelism (batch).
* ``model`` — tensor/expert parallelism.

The port's mesh is a :class:`torch.distributed.device_mesh.DeviceMesh`
whose ``mesh_dim_names`` use those names, one process a rank.
:func:`set_mesh` makes one active for a with-block (the counterpart of the
reference's ``sharding_compat.set_mesh``) and :func:`get_mesh` returns it;
off-mesh every helper here answers as for one device. The octree table of
the sharded OCTENT search (``kernels/octent/sharded.py``) partitions its
block-key range over every ``data``/``model`` axis of the mesh
(:data:`SHARD_AXES`); ``pod`` never holds a key range.

Nothing here starts a process group: the caller initializes
``torch.distributed`` and builds the mesh (``launch/spconv_sharded.py``).
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

AXIS_POD = "pod"
AXIS_DATA = "data"
AXIS_MODEL = "model"

#: axes eligible to hold a block-key range of the octree table: block keys
#: are batch-tagged Morton codes and maps never cross batch items, so every
#: axis inside a pod, data and model parallel alike, can serve table shards
SHARD_AXES = (AXIS_DATA, AXIS_MODEL)

_ACTIVE = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh):
    """``with set_mesh(mesh):`` makes ``mesh`` (a ``DeviceMesh`` with named
    dimensions, or None for none) the active mesh; the previous one comes
    back on exit. Yields ``mesh``."""
    if mesh is not None and not mesh.mesh_dim_names:
        raise ValueError("the active mesh needs named dimensions "
                         f"({AXIS_POD!r}, {AXIS_DATA!r}, {AXIS_MODEL!r})")
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def get_mesh():
    """The active ``DeviceMesh``, or None."""
    return _ACTIVE.get()


def _extents(mesh) -> dict:
    return {a: int(mesh.size(i)) for i, a in enumerate(mesh.mesh_dim_names)}


def active_axes() -> tuple[str, ...]:
    """Dimension names of the active mesh; () off-mesh."""
    mesh = get_mesh()
    return tuple(mesh.mesh_dim_names) if mesh is not None else ()


def axis_size(name: str) -> int:
    """Extent of axis ``name`` in the active mesh; 1 off-mesh or when the
    mesh has no such axis."""
    mesh = get_mesh()
    return 1 if mesh is None else _extents(mesh).get(name, 1)


def blockkey_axes(mesh=None) -> tuple[str, ...]:
    """Mesh axes the sorted block directory shards over: every data/model
    axis present in ``mesh`` (default: the active mesh), in
    :data:`SHARD_AXES` order."""
    mesh = get_mesh() if mesh is None else mesh
    if mesh is None:
        return ()
    return tuple(a for a in SHARD_AXES if a in mesh.mesh_dim_names)


def blockkey_shards(mesh=None) -> int:
    """Number of contiguous block-key ranges the octree table splits into
    (the product of the block-key axes' extents); 1 off-mesh."""
    mesh = get_mesh() if mesh is None else mesh
    if mesh is None:
        return 1
    ext = _extents(mesh)
    n = 1
    for a in blockkey_axes(mesh):
        n *= ext[a]
    return n


def mesh_fingerprint(mesh=None) -> tuple:
    """Hashable signature of ``mesh`` (default: the active one); () off-mesh.

    Part of every PlanCache key and pinned-table key: a plan built under
    one mesh carries that mesh's sharded search, so the same coordinates
    under another mesh must miss. The ``(axis, extent)`` pairs alone are
    not enough: two meshes of one shape over different ranks would replay
    a plan made among other processes. So the fingerprint also carries the
    global ranks of ``mesh.mesh`` and, on a CUDA mesh, this process's
    current device index.
    """
    mesh = get_mesh() if mesh is None else mesh
    if mesh is None:
        return ()
    fp = tuple(_extents(mesh).items())
    fp += (tuple(int(r) for r in mesh.mesh.flatten().tolist()),)
    if mesh.device_type == "cuda":
        fp += (("cuda", torch.cuda.current_device()),)
    return fp
