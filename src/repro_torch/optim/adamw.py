"""AdamW + global-norm clipping + warmup-cosine schedule, the reference's
arithmetic (``src/repro/optim/adamw.py``) on dicts of tensors.

Not ``torch.optim.AdamW``: the reference adds the weight decay inside the
update (``upd = m_hat / (sqrt(v_hat) + eps) + wd * p``, then ``p - lr *
upd``), where PyTorch decays first (``p *= 1 - lr * wd``), which rounds
differently. Parameters, gradients and the state's ``m`` and ``v`` are
dicts with the same keys (a ``state_dict``); the state is float32 and its
``count`` an int32 scalar tensor, incremented before use.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor): linear warmup, then cosine
    decay to ``min_lr_frac * lr`` at ``total_steps``; float32."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = t.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: dict[str, torch.Tensor]) -> dict:
    """Zero float32 moments shaped like ``params`` and ``count = 0``."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = next(iter(params.values())).device
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: dict, state: dict, params: dict):
    """One step. Returns ``(new_params, new_state, {"grad_norm", "lr"})``;
    ``grad_norm`` is the norm before clipping. ``params`` and ``state``
    are not modified: :func:`update_` on copies of them."""
    params = {k: p.clone() for k, p in params.items()}
    state = {"m": {k: m.clone() for k, m in state["m"].items()},
             "v": {k: v.clone() for k, v in state["v"].items()},
             "count": state["count"].clone()}
    return (params, state) + (update_(cfg, grads, state, params),)


@torch.no_grad()
def update_(cfg: AdamWConfig, grads: dict, state: dict, params: dict):
    """One step in place, the counterpart of the reference's update under
    ``donate_argnums``: the new parameters are written into ``params``, the
    new moments and count into ``state``, bit for bit what
    :func:`update` returns, so one copy of the state is live. Returns
    ``{"grad_norm", "lr"}``."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    count = state["count"].add_(1)
    lr = schedule(cfg, count)
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()
    for k, p in params.items():
        g32 = grads[k].float() * scale
        m = state["m"][k].mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        v = state["v"][k].mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        upd = upd + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * upd)
    return {"grad_norm": gnorm, "lr": lr}
