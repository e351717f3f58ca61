"""Mixture-of-Experts FFN (Mixtral top-k routing), the reference's
``src/repro/models/moe.py`` in its ``einsum`` form.

Dispatch is the rulebook in LM clothes (DESIGN.md §5). Per sequence, the
router's token copies are sorted by expert, ranked within their expert and
given the slot ``e * C + rank``; the (E, C, D) gather feeds batched expert
GEMMs, and a gate-weighted scatter-add combines them. The capacity C is
``ceil(S * top_k * capacity_factor / E)`` rounded up to 8; copies past it
are dropped and counted in the aux metrics.

The reference vmaps its per-sequence routing over the batch; here
:func:`_dispatch_one` takes the batch as a leading axis and gives every
sequence the reference's integers. The router is float32 whatever the
model's dtype. :func:`top_k` is the routing's expert choice as a module
function, so that a caller can record or pin it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import common


def init_moe(gen: torch.Generator, cfg, dtype) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": common.normal(gen, (d, e), d ** -0.5, torch.float32),
        "w_gate": common.normal(gen, (e, d, f), d ** -0.5, dtype),
        "w_up": common.normal(gen, (e, d, f), d ** -0.5, dtype),
        "w_down": common.normal(gen, (e, f, d), f ** -0.5, dtype),
    }


def capacity(cfg, seq: int) -> int:
    c = math.ceil(seq * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)       # round up to 8, as the reference


def set_moe_impl(impl: str) -> None:
    """The reference's switch between its ``einsum`` dispatch and the
    ``shard_map`` one. Only ``einsum`` is ported: ``shard_map`` belongs to
    the LM's tensor sharding (ROADMAP §1 item 5)."""
    if impl == "shard_map":
        raise NotImplementedError(
            "moe impl 'shard_map' needs the LM's tensor sharding, which is "
            "not ported yet (ROADMAP §1 item 5)")
    if impl != "einsum":
        raise ValueError(f"unknown moe impl {impl!r}")


def top_k(logits: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest values and their
    indices, ties to the lower index (a stable descending sort). The
    values carry the gradient; the indices are integers."""
    idx = torch.sort(logits.detach(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return logits.gather(-1, idx), idx


def _dispatch_one(x, logits, k: int, e: int, cap: int):
    """Routing of each sequence, batched. x (B, S, D), logits (B, S, E) ->
    gather_tok (B, E*C) int32 (S, the zero pad row, for an empty slot),
    slot_gate (B, E*C) float32 and dropped (B,) copies."""
    b, s = x.shape[:2]
    dev = logits.device
    top_vals, top_idx = top_k(logits, k)                     # (B, S, k)
    gates = torch.softmax(top_vals, dim=-1)                  # Mixtral renorm
    flat_e = top_idx.reshape(b, s * k)
    flat_t = torch.arange(s, dtype=torch.int32,
                          device=dev).repeat_interleave(k)
    flat_g = gates.reshape(b, s * k)
    se, order = torch.sort(flat_e, dim=-1, stable=True)
    counts = torch.zeros((b, e), dtype=torch.int64, device=dev).scatter_add_(
        1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=-1) - counts
    rank = torch.arange(s * k, device=dev) - starts.gather(1, se)
    keep = rank < cap
    # slot e*cap is the overflow slot of a dropped copy, sliced off below
    slot = torch.where(keep, se * cap + rank, e * cap)
    gather_tok = torch.full((b, e * cap + 1), s, dtype=torch.int32,
                            device=dev).scatter(1, slot, flat_t[order])
    slot_gate = torch.zeros((b, e * cap + 1), dtype=torch.float32,
                            device=dev).scatter(1, slot,
                                                flat_g.gather(1, order))
    dropped = (~keep).sum(-1)
    return gather_tok[:, :e * cap], slot_gate[:, :e * cap], dropped


def moe_ffn(params, x: torch.Tensor, cfg):
    """x (B, S, D) -> (out (B, S, D), {"moe_aux", "moe_drop_frac"}).

    Differentiable as the reference's: through the gathers, the expert
    GEMMs, the gates scattered into ``slot_gate`` (into the router) and the
    load-balance term."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, s)
    logits = x.float() @ params["router"]                    # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gather_tok, slot_gate, dropped = _dispatch_one(x, logits, k, e, cap)

    x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    tok = gather_tok.long()
    routed = x_pad.gather(1, tok[..., None].expand(-1, -1, d))
    routed = routed.reshape(b, e, cap, d)
    h_g = torch.einsum("becd,edf->becf", routed, params["w_gate"])
    h_u = torch.einsum("becd,edf->becf", routed, params["w_up"])
    h = common.activation(h_g, cfg.act) * h_u
    y = torch.einsum("becf,efd->becd", h, params["w_down"])
    y = y.reshape(b, e * cap, d) * slot_gate[..., None].to(y.dtype)
    # the reference's .at[t].add(mode="drop") into (B, S+1, D): row S of
    # each sequence takes the empty slots and is sliced off
    rows = tok + (s + 1) * torch.arange(b, device=x.device)[:, None]
    out = y.new_zeros((b * (s + 1), d)).index_add(0, rows.reshape(-1),
                                                  y.reshape(-1, d))
    out = out.reshape(b, s + 1, d)[:, :s]

    # Switch-style load-balance aux: E * sum_e f_e * P_e
    f_e = F.one_hot(logits.argmax(-1), e).float().mean(dim=(0, 1))
    p_e = probs.mean(dim=(0, 1))
    aux = e * (f_e * p_e).sum()
    return out, {"moe_aux": aux,
                 "moe_drop_frac": dropped.sum() / (b * s * k)}
