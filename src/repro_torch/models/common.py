"""Shared model building blocks: norms, activations, RoPE and the MLP,
and the parameter trees every family keeps.

Parameters are plain tensors in nested dicts, keyed as in the reference.
The reference's ``runtime.sharding.shard`` calls stand at the same places
(``runtime/sharding.shard``): under a mesh, on DTensors, they fix where
the collectives fall; anywhere else they are the identity.

:class:`ParamTree` holds such a tree as an ``nn.Module`` whose
``state_dict`` keys are its paths (a list's items under their index:
``layers.3.attn.wq``); :func:`params_from_jax` builds that ``state_dict``
from a reference tree and :func:`nest_params` turns one back into the
nested dict. :data:`META` stands in for a generator to draw a tree's
shapes on the ``meta`` device, where torch draws nothing.
"""
from __future__ import annotations

from collections.abc import Iterable, Mapping
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.runtime.sharding import is_dtensor, local_map, shard

#: a stand-in for a ``torch.Generator``: :func:`normal` gives empty tensors
#: on the ``meta`` device (torch's random functions take no generator there)
META = SimpleNamespace(device=torch.device("meta"))


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(gen: torch.Generator, shape, std: float,
           dtype: torch.dtype) -> torch.Tensor:
    """Standard normal draws from ``gen`` on its device, in float32, times
    ``std``, cast to ``dtype`` (:data:`META`: an empty ``meta`` tensor)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * std).to(dtype)


def generator_for(device, generator: torch.Generator | None):
    """``(device, generator)`` of a model built on ``device`` (None: the
    card; raises without one) from ``generator`` (None: a fresh one on the
    device, seeded 0), which must lie on the device's type; :data:`META`
    builds the model's shapes on the ``meta`` device, whatever
    ``device``."""
    if generator is META:
        return META.device, META
    dev = resolve_device(device)
    gen = generator if generator is not None \
        else torch.Generator(dev).manual_seed(0)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, model on {dev}")
    return dev, gen


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``, a weight narrower than ``x`` cast up to ``x``'s dtype, as
    the reference's type promotion computes a float32 input against bf16
    weights (the encoder's frames, the VLM's patches)."""
    if w.dtype != x.dtype and \
            torch.promote_types(x.dtype, w.dtype) == x.dtype:
        w = w.to(x.dtype)
    return x @ w


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``. Under a mesh on each rank's rows of ``ids`` with the
    table gathered whole (``runtime.sharding.local_map``): the vocab-sharded
    lookup's backward (``index_put`` into a sharded table) has no working
    DTensor strategy on every torch the port runs."""
    return local_map(lambda t, i: t[i], (table, ids), free=((), (0,)),
                     outs=(((1, 0),) + (None,) * ids.dim(),))


def write_at(buf: torch.Tensor, dim: int, index: torch.Tensor,
             src: torch.Tensor) -> None:
    """``buf.index_copy_(dim, index, src)``, in place: the reference's
    ``dynamic_update_slice`` at a position held on the device (``index``
    (1,) int64), so no host read fixes it. DTensor has no ``index_copy_``
    strategy on every torch the port runs: a DTensor whole along ``dim``
    writes each rank's own shard (``src`` placed as ``buf`` first), one
    sharded along it takes ``src`` where a one-hot mask of ``dim`` is
    set."""
    src = src.to(buf.dtype)
    if is_dtensor(buf):
        if any(p.is_shard(dim) for p in buf.placements):
            hit = torch.arange(buf.shape[dim], device=index.device) == index
            hit = hit.reshape((-1,) + (1,) * (buf.dim() - dim - 1))
            buf.copy_(torch.where(hit, src, buf))
            return
        if is_dtensor(src):
            src = src.redistribute(buf.device_mesh, buf.placements)
        buf, index, src = (t.to_local() if is_dtensor(t) else t
                           for t in (buf, index, src))
    buf.index_copy_(dim, index, src)


def pad_front(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (B, S, ...) with n (a conv's width - 1) zero rows in front along
    S: ``F.pad``; on a DTensor the same as a concatenation, which DTensor
    takes on every torch the port runs (its ``constant_pad_nd`` fails on
    torch 2.11)."""
    if not is_dtensor(x):
        return F.pad(x, (0, 0) * (x.dim() - 2) + (n, 0))
    zeros = torch.zeros_like(x[:, :1])
    return torch.cat([zeros] * n + [x], dim=1)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm(x, params, kind: str):
    if kind == "rmsnorm":
        return rms_norm(x, params["w"])
    return layer_norm(x, params["scale"], params["bias"])


def init_norm(kind: str, d: int, dtype, device) -> dict:
    if kind == "rmsnorm":
        return {"w": torch.zeros(d, dtype=dtype, device=device)}
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def activation(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    raise ValueError(kind)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x (..., S, H, D) rotated at ``positions`` (S,) or (B, S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., None] * freq               # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


class _SumOverRanks(torch.autograd.Function):
    """All-reduce SUM over ``group`` forward; the identity backward, for a
    sum whose result every rank of the group uses alike (its gradient is
    the same on every rank, the gradient of each summand)."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _sharded_logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over the last dim of a DTensor, without gathering it
    where that dim is sharded: each rank takes the max and the sum of
    exponentials of its own vocab shard, reduced by two all-reduces of the
    leading dims over each mesh dim that shards the vocab (MAX, then SUM).
    The max is a constant of the gradient, as in ``torch.logsumexp``."""
    mesh, vdim = logits.device_mesh, logits.dim() - 1
    groups = [(mesh, m) for m, p in enumerate(logits.placements)
              if p.is_shard(vdim)]
    if not groups:
        return torch.logsumexp(logits, dim=-1)

    def lse(x):
        from torch.distributed import _functional_collectives as funcol
        m = x.detach().amax(-1)
        for g in groups:
            m = funcol.wait_tensor(funcol.all_reduce(m, "max", g))
        # an all -inf row: the reference's logsumexp is -inf there too
        m = torch.where(torch.isfinite(m), m, 0.0)
        s = torch.exp(x - m[..., None]).sum(-1)
        for g in groups:
            s = _SumOverRanks.apply(s, g)
        return m + torch.log(s)

    return local_map(lse, (logits,), free=(tuple(range(vdim + 1)),),
                     outs=(tuple((0, d) for d in range(vdim)),))


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token CE in float32; logits (..., V), targets int (...), mask
    optional (a masked mean over ``max(mask.sum(), 1)``).

    Logits sharded on the vocab (a DTensor) are never gathered: the
    log-sum-exp reduces each rank's max and sum of exponentials
    (:func:`_sharded_logsumexp`), and the target's logit is a masked sum
    over the sharded vocab, exact (one nonzero term), reduced once over
    the model axis."""
    logits = logits.float()
    if is_dtensor(logits):
        hit = torch.arange(logits.shape[-1], device=targets.device) == \
            targets[..., None]
        dims = ("batch",) + (None,) * (targets.dim() - 1)
        ll = shard(torch.where(hit, logits, 0.0).sum(-1), *dims)
        lse = shard(_sharded_logsumexp(logits), *dims)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, targets[..., None].long())[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def shift_labels(tokens: torch.Tensor):
    """Next-token prediction: inputs tokens[:, :-1] predict tokens[:, 1:]."""
    return tokens[:, :-1], tokens[:, 1:]


def init_mlp(gen: torch.Generator, d: int, f: int, dtype,
             gated: bool = True) -> dict:
    p = {"w_up": normal(gen, (d, f), d ** -0.5, dtype),
         "w_down": normal(gen, (f, d), f ** -0.5, dtype)}
    if gated:
        p["w_gate"] = normal(gen, (d, f), d ** -0.5, dtype)
    return p


def mlp(params, x, act: str):
    up = shard(dot(x, params["w_up"]), "batch", None, "model")
    if "w_gate" in params:
        gate = shard(dot(x, params["w_gate"]), "batch", None, "model")
        h = activation(gate, act) * up
    else:
        h = activation(up, act)
    return shard(dot(h, params["w_down"]), "batch", None, None)


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

class ParamTree(nn.Module):
    """The tensors of a nested tree (dicts, lists of dicts, tensors) as
    frozen parameters under their paths; :meth:`params` is the tree again,
    sharing them."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for key, node in tree.items():
            if isinstance(node, torch.Tensor):
                self.register_parameter(
                    key, nn.Parameter(node, requires_grad=False))
            elif isinstance(node, list):
                self.add_module(key, nn.ModuleList(ParamTree(n)
                                                   for n in node))
            else:
                self.add_module(key, ParamTree(node))

    def params(self) -> dict:
        out: dict = dict(self._parameters)
        for key, mod in self._modules.items():
            out[key] = ([m.params() for m in mod]
                        if isinstance(mod, nn.ModuleList) else mod.params())
        return out


def params_from_jax(tree: Mapping, stacked: Iterable[str] = ("layers",)
                    ) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of a reference parameter tree (mapped through
    ``np.asarray``): the leading axis of each top-level key in ``stacked``
    is split into ``<key>.<i>``, and a list's items go under their index.
    Values are float32; ``load_state_dict`` casts them to the model's
    dtypes."""
    out: dict[str, torch.Tensor] = {}
    stacked = set(stacked)

    def walk(prefix, node, split):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v, split)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}.", v, split)
        else:
            a = np.array(node, dtype=np.float32)
            if split is None:
                out[prefix[:-1]] = torch.from_numpy(a)
            else:
                for i in range(a.shape[0]):
                    out[f"{split}.{i}.{prefix[:-1]}"] = torch.from_numpy(a[i])

    for key, node in tree.items():
        if key in stacked:
            walk("", node, key)
        else:
            walk(f"{key}.", node, None)
    return out


def nest_params(flat: Mapping[str, torch.Tensor]) -> dict:
    """The nested parameter dict of a ``state_dict`` (``layers.3.attn.wq``
    -> ``params["layers"][3]["attn"]["wq"]``), sharing its tensors: a
    level whose keys are all indices becomes a list."""
    out: dict = {}
    for key, t in flat.items():
        parts = key.split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(out)
