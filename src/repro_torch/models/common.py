"""Shared model building blocks: norms, activations, RoPE and the MLP,
and the parameter trees every family keeps.

Parameters are plain tensors in nested dicts, keyed as in the reference.
The reference's ``runtime.sharding.shard`` annotations have no counterpart
on one card, so those calls are dropped.

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


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token CE in float32; logits (..., V), targets int (...), mask
    optional (a masked mean over ``max(mask.sum(), 1)``)."""
    logits = logits.float()
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
    up = dot(x, params["w_up"])
    if "w_gate" in params:
        h = activation(dot(x, params["w_gate"]), act) * up
    else:
        h = activation(up, act)
    return dot(h, params["w_down"])


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
