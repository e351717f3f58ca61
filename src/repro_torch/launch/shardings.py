"""Parameter, optimizer-state, batch and cache sharding rules, the
reference's ``src/repro/launch/shardings.py`` (its DESIGN.md §4).

The rules are keyed on a leaf's last name and are rank-generic; the
divisibility filter of ``runtime.sharding.resolve`` replicates a dim the
mesh extent does not divide (8 KV heads or vocab 50,280 on a 16-way
``model`` axis), so one table covers every architecture and mesh. Each
function returns, per leaf, a :class:`Sharding`: the reference's spec (one
entry a tensor dim: None, an axis name or a tuple of names) and its
DTensor placements (one a mesh dim).

**Stacked layers.** The reference stacks each layer's leaves on a leading
(L, ...) axis (``groups`` in RecurrentGemma); the port keeps one leaf a
layer, ``layers.<i>.<name>`` (``groups.<i>.``), from
``common.params_from_jax``. The rules count that axis: a leaf under a
stacked key is resolved at the reference's rank on the shape (L, *shape),
and its spec is the reference's with the layer dim dropped. So a port
``norm_w`` of shape (D,) is sharded on D over ``model``, as the
reference's (L, D) one is, where a rank-1 rule applied to (D,) would
replicate it. RecurrentGemma's ``tail`` is a list in the reference too,
so its leaves are not stacked. Only one rule shards the layer dim itself:
``pure_dp``'s ZeRO-1 placement of AdamW's m and v takes the first dim the
whole mesh divides, the layer dim when L is a multiple of an axis extent
(32 or 48 layers over 16). A port leaf holds one layer and cannot spread
layers over ranks, so those axes move to the first dim of the leaf that
they divide (:func:`_drop_layer`): each device then holds the
reference's bytes, and the spec differs from the reference's there only
by where those axes sit. Where no dim takes them all (Mamba2's three
(80,) leaves on the multi-pod mesh) the largest subset that one dim takes
moves, and those leaves' m and v hold more bytes a device than the
reference's.

**Caches.** The port's caches are laid out as the reference's: stacked
tensors with the layer (or group) axis in front, under the reference's
names (``k``, ``v``, ``pos``, ``conv``, ``ssm``, ``rec_h``, ``rec_conv``,
``tail_h``, ``tail_conv``), so the cache rules apply unchanged, leading
None included. The cache's ``step`` is a host integer in the port, not a
tensor: it has no sharding and no device bytes (the reference's is a
4-byte int32 scalar).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.runtime import sharding as rs

# weight matrices whose LAST dim is the TP-sharded output features
_LAST = {"wq", "wk", "wv", "w_gate", "w_up", "lm_head", "pred_head",
         "in_proj", "conv_w", "conv_b", "w_x", "w_gate_branch", "proj_in",
         "frontend_proj", "norm_w", "lam", "w"}
# weight matrices whose SECOND-TO-LAST dim is the TP-sharded input features
_SECOND_LAST = {"wo", "w_down", "out_proj", "w_out", "proj_out"}
# token/state caches: name -> logical dims. Two layouts for attention KV:
#   'kv'  (baseline) — shard the kv-head dim; falls back to REPLICATED when
#          kv_heads < |model| (the GQA trap);
#   'ctx' — context parallelism: shard the capacity dim over 'model'.
_CACHE_RULES_KV = {
    "k": (None, "batch", None, "model", None),
    "v": (None, "batch", None, "model", None),
}
_CACHE_RULES_CTX = {
    "k": (None, "batch", "model", None, None),
    "v": (None, "batch", "model", None, None),
}
_CACHE_RULES = {
    "conv": (None, "batch", None, "model"),
    "ssm": (None, "batch", "model", None, None),
    "rec_h": (None, None, "batch", "model"),
    "rec_conv": (None, None, "batch", None, "model"),
    "tail_h": (None, "batch", "model"),
    "tail_conv": (None, "batch", None, "model"),
}

#: top-level keys whose leaves the reference stacks on a leading axis
STACKED_KEYS = ("layers", "groups")


class Sharding(NamedTuple):
    """One leaf's placement: the reference's spec and DTensor placements
    on ``mesh``."""

    spec: tuple
    placements: tuple
    mesh: object

    def local_shape(self, shape) -> tuple[int, ...]:
        return rs.local_shape(shape, self.spec, self.mesh)


def _sharding(spec, mesh) -> Sharding:
    return Sharding(spec, rs.placements(spec, mesh), mesh)


def _split(key: str):
    """``(leaf name, stack key or None)`` of a flat ``state_dict`` key."""
    parts = key.split(".")
    stacked = (len(parts) > 2 and parts[0] in STACKED_KEYS
               and parts[1].isdigit())
    return parts[-1], parts[0] if stacked else None


def _stack_lengths(keys) -> dict[str, int]:
    """The stacked extent (L) of each stack key, from the indices used."""
    seen: dict[str, set] = {}
    for key in keys:
        _, stack = _split(key)
        if stack is not None:
            seen.setdefault(stack, set()).add(int(key.split(".")[1]))
    return {k: len(v) for k, v in seen.items()}


def _param_dims(name: str, rank: int, strategy: str = "tp"):
    if strategy == "pure_dp":           # replicate everything
        return (None,) * rank
    if rank <= 1:                       # scales/biases: replicate
        return (None,) * rank
    if name == "embed":
        return ("model",) + (None,) * (rank - 1)
    if name in _LAST:
        return (None,) * (rank - 1) + ("model",)
    if name in _SECOND_LAST:
        return (None,) * (rank - 2) + ("model", None)
    return (None,) * rank


def _axes(d) -> tuple:
    return (d,) if isinstance(d, str) else tuple(d or ())


def _drop_layer(spec_full: tuple, shape, mesh) -> tuple:
    """The spec of one layer's leaf from the stacked leaf's spec: the layer
    dim dropped. Axes on it (ZeRO-1 only) move to the first dim of
    ``shape`` that the extent taken there times theirs divides: all of
    them if some dim takes them, else the subset of largest extent that
    one does (the others then replicate the leaf; the one case among the
    configs is Mamba2's (80,) ``A_log``, ``D_skip`` and ``dt_bias`` on the
    multi-pod mesh, whose layer dim the reference shards 32 ways)."""
    lead, rest = spec_full[0], list(spec_full[1:])
    if lead is None:
        return tuple(rest)
    ext = rs._extents(mesh)
    axes = _axes(lead)
    subsets = [tuple(a for j, a in enumerate(axes) if m >> j & 1)
               for m in range(2 ** len(axes) - 1, 0, -1)]
    subsets.sort(key=lambda sub: -math.prod(ext[a] for a in sub))
    for moved in subsets:
        need = math.prod(ext[a] for a in moved)
        for i, n in enumerate(shape):
            have = _axes(rest[i])
            if n % (math.prod(ext[a] for a in have) * need) == 0:
                both = have + moved
                rest[i] = both[0] if len(both) == 1 else both
                return tuple(rest)
    return tuple(rest)


def _leaf_spec(key, shape, mesh, lengths, dims_of) -> tuple:
    """Resolve ``dims_of(name, rank, full_shape)`` at the reference's rank."""
    name, stack = _split(key)
    full = tuple(shape) if stack is None else (lengths[stack],) + tuple(shape)
    spec = dims_of(name, len(full), full)
    if stack is None:
        return spec
    return _drop_layer(spec, tuple(shape), mesh)


def param_shardings(abstract_params: dict, mesh,
                    strategy: str = "tp") -> dict[str, Sharding]:
    """Per ``state_dict`` key of the parameters (tensors, e.g. ``meta``):
    its :class:`Sharding` on ``mesh`` (AdamW's m and v take the same under
    ``tp``)."""
    lengths = _stack_lengths(abstract_params)

    def dims_of(name, rank, full):
        return rs.resolve(*_param_dims(name, rank, strategy), shape=full,
                          mesh=mesh)

    return {k: _sharding(_leaf_spec(k, t.shape, mesh, lengths, dims_of),
                         mesh)
            for k, t in abstract_params.items()}


def opt_state_shardings(abstract_opt: dict, mesh,
                        strategy: str = "tp") -> dict:
    """``{"m": {...}, "v": {...}, "count": Sharding}`` for an AdamW state
    (``optim/adamw.init``): m and v mirror the parameters, ``count`` is
    replicated. ``pure_dp`` shards m and v over the whole mesh on the
    first dim it divides (ZeRO-1): parameters stay replicated but the
    optimizer state is 1/N a device."""
    all_axes = tuple(mesh.mesh_dim_names)
    lengths = _stack_lengths(abstract_opt["m"])

    def dims_of(name, rank, full):
        if strategy == "pure_dp" and rank >= 1:
            for i in range(rank):
                spec = rs.resolve(
                    *((None,) * i + (all_axes,) + (None,) * (rank - i - 1)),
                    shape=full, mesh=mesh)
                if spec[i] is not None:
                    return spec
            return (None,) * rank
        return rs.resolve(*_param_dims(name, rank, strategy), shape=full,
                          mesh=mesh)

    out = {}
    for part in ("m", "v"):
        out[part] = {k: _sharding(_leaf_spec(k, t.shape, mesh, lengths,
                                             dims_of), mesh)
                     for k, t in abstract_opt[part].items()}
    out["count"] = _sharding(rs.resolve(
        *(None,) * abstract_opt["count"].dim(), mesh=mesh), mesh)
    return out


def batch_shardings(abstract_batch: dict, mesh) -> dict[str, Sharding]:
    """Model inputs: the leading dim is the global batch
    (``runtime.sharding.set_batch_axes``)."""
    return {k: _sharding(rs.resolve(
        "batch", *(None,) * (t.dim() - 1), shape=tuple(t.shape), mesh=mesh),
        mesh) for k, t in abstract_batch.items()}


def cache_shardings(abstract_cache: dict, mesh,
                    kv_layout: str = "kv") -> dict[str, Sharding]:
    """Per cache tensor, ``step`` (a scalar) replicated."""
    rules = dict(_CACHE_RULES)
    rules.update(_CACHE_RULES_CTX if kv_layout == "ctx" else _CACHE_RULES_KV)
    out = {}
    for name, t in abstract_cache.items():
        if not isinstance(t, torch.Tensor):
            continue
        rank = t.dim()
        dims = rules.get(name, (None,) * rank)
        dims = dims[:rank] if len(dims) >= rank else (None,) * rank
        out[name] = _sharding(rs.resolve(*dims, shape=tuple(t.shape),
                                         mesh=mesh), mesh)
    return out


def device_bytes(tensors: dict, shardings: dict) -> int:
    """Bytes one device holds of ``tensors`` (a dict, nested as the
    shardings) under ``shardings``: exact, from the shard shapes."""
    total = 0
    for k, sh in shardings.items():
        t = tensors[k]
        if isinstance(sh, dict):
            total += device_bytes(t, sh)
        else:
            total += math.prod(sh.local_shape(t.shape)) * t.element_size()
    return total


def _local(t: torch.Tensor, sh: Sharding) -> torch.Tensor:
    """This rank's shard of the full tensor ``t``: a slice a sharded dim,
    at this rank's coordinates, the mesh's major axis first (DTensor's
    order of several ``Shard`` of one dim)."""
    mesh = sh.mesh
    coord = mesh.get_coordinate()
    names = mesh.mesh_dim_names
    ext = rs._extents(mesh)
    if t.device.type == "meta":
        return torch.empty(sh.local_shape(t.shape), dtype=t.dtype,
                           device="meta")
    out = t
    for dim, d in enumerate(sh.spec):
        axes = sorted(_axes(d), key=names.index)
        if not axes:
            continue
        idx, n = 0, 1
        for a in axes:
            idx = idx * ext[a] + coord[names.index(a)]
            n *= ext[a]
        size = t.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out.contiguous()


def place(t: torch.Tensor, sh: Sharding):
    """The DTensor of the full tensor ``t`` (alike on every rank) placed
    by ``sh``: this rank's shard sliced locally, no collective."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(_local(t, sh), sh.mesh, sh.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def distribute(tensors: dict, shardings: dict) -> dict:
    """DTensors of ``tensors`` (a flat ``state_dict``, an AdamW state or a
    batch; every rank holds the same full values, e.g. drawn from the same
    seed, or ``meta`` tensors) placed by ``shardings`` (:func:`place`).
    Non-tensor entries, and entries without a sharding, pass through."""
    out = {}
    for k, t in tensors.items():
        sh = shardings.get(k)
        if isinstance(t, dict):
            out[k] = distribute(t, sh)
        elif sh is None or not isinstance(t, torch.Tensor):
            out[k] = t
        else:
            out[k] = place(t, sh)
    return out
