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

The LM's tensor sharding keeps the reference's logical-to-physical form
(``src/repro/runtime/sharding.py``): :func:`resolve` turns logical dims
(None, an axis name, a tuple of names, or ``"batch"``, which stands for
:func:`batch_axes`) into the reference's spec, one entry a tensor dim,
dropping axes the active mesh lacks, axes whose extent does not divide the
dim, and any axis a previous dim already took. :func:`placements` turns a
spec into DTensor placements, one a mesh dim, and :func:`shard` is the
counterpart of ``with_sharding_constraint``: on a ``DTensor`` under an
active mesh it redistributes to the resolved placements (that is where
the collectives fall), anywhere else it is the identity.

Nothing here starts a process group: the caller initializes
``torch.distributed`` and builds the mesh (``launch/spconv_sharded.py``,
``launch/mesh.py``).
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
# logical 'batch' axes; the pure-DP strategy extends them with 'model'
_BATCH_AXES = [(AXIS_POD, AXIS_DATA)]


def set_batch_axes(axes: tuple[str, ...]) -> None:
    _BATCH_AXES[0] = tuple(axes)


def batch_axes() -> tuple[str, ...]:
    return _BATCH_AXES[0]


@contextlib.contextmanager
def set_mesh(mesh):
    """``with set_mesh(mesh):`` makes ``mesh`` (a ``DeviceMesh`` with named
    dimensions, or None for none) the active mesh; the previous one comes
    back on exit. Yields ``mesh``. Inside, DTensor ops take a plain tensor
    argument as replicated (``implicit_replication``): the model code makes
    its positions and masks as plain tensors, alike on every rank."""
    if mesh is not None and not mesh.mesh_dim_names:
        raise ValueError("the active mesh needs named dimensions "
                         f"({AXIS_POD!r}, {AXIS_DATA!r}, {AXIS_MODEL!r})")
    token = _ACTIVE.set(mesh)
    try:
        if mesh is None:
            yield mesh
        else:
            # a plain tensor beside a DTensor (positions, masks, constants
            # made on every rank alike) is taken as replicated
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
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


def resolve(*dims, shape: tuple[int, ...] | None = None,
            mesh=None) -> tuple:
    """The reference's ``PartitionSpec`` as a tuple, one entry a dim: None,
    an axis name, or a tuple of names (major to minor).

    Each dim is None, an axis name, a tuple of names, or ``"batch"``
    (:func:`batch_axes`). Only axes of ``mesh`` (default: the active one)
    are kept, each at most once; with ``shape``, an axis is dropped where
    the extent taken so far times its own does not divide the dim (8 KV
    heads or vocab 50,280 on a 16-way ``model`` axis are replicated).
    Off-mesh every entry is None.
    """
    mesh = get_mesh() if mesh is None else mesh
    ext = {} if mesh is None else _extents(mesh)
    used: set[str] = set()

    def one(i, d):
        if d is None:
            return None
        if d == "batch":
            d = batch_axes()
        if isinstance(d, str):
            d = (d,)
        keep, extent = [], 1
        for a in d:
            if a not in ext or a in used:
                continue
            if shape is not None and shape[i] % (extent * ext[a]) != 0:
                continue
            keep.append(a)
            used.add(a)
            extent *= ext[a]
        if not keep:
            return None
        return keep[0] if len(keep) == 1 else tuple(keep)

    return tuple(one(i, d) for i, d in enumerate(dims))


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh dim:
    ``Shard(i)`` where tensor dim i names the mesh dim, else
    ``Replicate()``. A dim sharded over (``pod``, ``data``) gives
    ``Shard(i)`` on both, pod major, as the reference's tuple."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {}
    for i, d in enumerate(spec):
        for a in ((d,) if isinstance(d, str) else (d or ())):
            owner[a] = i
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh.mesh_dim_names)


def local_shape(shape, spec: tuple, mesh) -> tuple[int, ...]:
    """The shard shape of a tensor of ``shape`` under ``spec`` on
    ``mesh`` (every sharded dim divides: :func:`resolve` keeps no other)."""
    ext = _extents(mesh)
    out = []
    for n, d in zip(shape, spec):
        for a in ((d,) if isinstance(d, str) else (d or ())):
            n //= ext[a]
        out.append(n)
    return tuple(out)


def is_dtensor(x) -> bool:
    if type(x) is torch.Tensor:     # the single-device path, per op
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard(x: torch.Tensor, *dims) -> torch.Tensor:
    """The counterpart of the reference's ``shard``
    (``with_sharding_constraint``): a ``DTensor`` is redistributed to the
    placements of ``resolve(*dims, shape=x.shape)`` on its own mesh (a
    partial sum is reduced there); a plain tensor is returned as it is,
    as off-mesh in the reference. The DTensor's mesh, not the active one,
    decides: the backward (and a checkpoint's recomputation in it) runs on
    the autograd engine's device thread, outside the caller's context."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    want = placements(resolve(*dims, shape=tuple(x.shape), mesh=mesh), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def local_map(fn, args: tuple, free: tuple, outs: tuple):
    """``fn(*args)`` run on each rank's shards, the counterpart of the
    reference's ``shard_map`` for a function that is independent along
    some dims (the batch rows, the heads): with no DTensor argument (off
    a mesh), just ``fn(*args)``.

    ``free[i]`` names the dims of ``args[i]`` that may stay sharded (a
    DTensor sharded, or holding a partial sum, on any other dim is
    gathered or reduced first); non-tensor arguments pass as they are.
    ``outs[j]`` places output j: one entry a dim, None (whole on every
    rank) or ``(i, d)``, sharded as dim d of ``args[i]``. A replicated
    argument used beside a sharded one has, on that mesh dim, a partial
    sum for its gradient. Used where DTensor has no sharding strategy for
    the ops inside ``fn`` or plans them for minutes (the SSD scan of
    ``models/mamba2.py``)."""
    tensors = [a for a in args if is_dtensor(a)]
    if not tensors:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = tensors[0].device_mesh
    n_mesh = mesh.ndim
    placed = []
    for a, ok in zip(args, free):
        if is_dtensor(a):
            want = tuple(p if isinstance(p, Shard) and type(p) is Shard
                         and p.dim in ok else Replicate()
                         for p in a.placements)
            if want != tuple(a.placements):
                a = a.redistribute(mesh, want)
        placed.append(a)
    # a mesh dim that shards any argument splits the work over its ranks
    split = [any(is_dtensor(a) and a.placements[m].is_shard()
                 for a in placed) for m in range(n_mesh)]
    local = [a.to_local(grad_placements=tuple(
                 Partial() if split[m] and a.placements[m].is_replicate()
                 else a.placements[m] for m in range(n_mesh)))
             if is_dtensor(a) else a for a in placed]
    res = fn(*local)
    single = not isinstance(res, tuple)
    res = (res,) if single else res
    wrapped = []
    for r, dims in zip(res, outs):
        pl = []
        for m in range(n_mesh):
            hit = [j for j, src in enumerate(dims) if src is not None
                   and is_dtensor(placed[src[0]])
                   and placed[src[0]].placements[m] == Shard(src[1])]
            pl.append(Shard(hit[0]) if hit else Replicate())
        wrapped.append(DTensor.from_local(r, mesh, tuple(pl),
                                          run_check=False))
    return wrapped[0] if single else tuple(wrapped)


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
