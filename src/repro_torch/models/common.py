"""Shared model building blocks: norms, activations, RoPE and the MLP.

Parameters are plain tensors in nested dicts, keyed as in the reference.
The reference's ``runtime.sharding.shard`` annotations have no counterpart
on one card, so those calls are dropped.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(gen: torch.Generator, shape, std: float,
           dtype: torch.dtype) -> torch.Tensor:
    """Standard normal draws from ``gen`` on its device, in float32, times
    ``std``, cast to ``dtype``."""
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * std).to(dtype)


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
    up = x @ params["w_up"]
    if "w_gate" in params:
        h = activation(x @ params["w_gate"], act) * up
    else:
        h = activation(up, act)
    return h @ params["w_down"]
