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

Two dispatches, as the reference's ``set_moe_impl``: ``einsum`` (the
default) lets DTensor place the collectives between the pinned tensors;
``shard_map``, under a mesh with a ``model`` axis that is not a batch
axis, runs the gather, the expert GEMMs and the combine on each rank's
F-slice of ``w_gate``, ``w_up`` and ``w_down`` (:func:`_expert_ffn_combine`
on local tensors) and reduces the compact (B, S, D) output with one
all-reduce over ``model``, the counterpart of the reference's
``shard_map`` + ``psum``; in training the body is recomputed in the
backward (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).
Off-mesh both are the same function.

Under a mesh the routing (:func:`_dispatch_one`: sorts, scatters, a
cumulative sum) and the ``einsum`` dispatch's combine (an ``index_add``
into batch-sharded rows, :func:`_rowwise`), which DTensor has no sharding
strategy for, run on each rank's local rows: the router logits and the
expert outputs are sharded on the batch only (the outputs a partial sum
over ``model``), so every row is whole on its rank.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _checkpoint

from repro_torch.models import common
from repro_torch.runtime import sharding as rs
from repro_torch.runtime.sharding import shard


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


# 'einsum': DTensor places the collectives (the default); 'shard_map':
# the expert GEMMs and the combine run per model shard, so the reduction
# lands on the compact (B, S, D) output, not the (B, E, C, D) partials
_MOE_IMPL = ["einsum"]


def set_moe_impl(impl: str) -> None:
    """The reference's switch between its ``einsum`` and ``shard_map``
    dispatches (module docstring)."""
    if impl not in ("einsum", "shard_map"):
        raise ValueError(f"unknown moe impl {impl!r}")
    _MOE_IMPL[0] = impl


def moe_impl() -> str:
    return _MOE_IMPL[0]


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


def _expert_ffn_combine(x_pad, slot_gate, gather_tok, w_gate, w_up,
                        w_down, *, act: str, s: int, e: int):
    """Dispatch gather + expert GEMMs + gate-weighted combine into (B, S,
    D), with the reference's ``einsum`` pins (identity on plain tensors).
    The ``einsum`` dispatch runs it on DTensors; ``shard_map`` on each
    rank's local tensors, the weights F-sliced (the caller reduces over
    ``model`` after the combine)."""
    b, _, d = x_pad.shape
    tok = gather_tok.long()
    routed = x_pad.gather(1, tok[..., None].expand(-1, -1, d))
    routed = shard(routed.reshape(b, e, -1, d), "batch", None, None, None)
    h_g = _experts(routed, w_gate)
    h_u = _experts(routed, w_up)
    h = shard(common.activation(h_g, act) * h_u, "batch", None, None,
              "model")
    y = _experts(h, w_down)
    # gate before merging (E, C): DTensor plans the product of the 4-D
    # partial sum at once, where the merged view costs it minutes
    y = (y * slot_gate.reshape(b, e, -1)[..., None].to(y.dtype)).reshape(
        b, -1, d)
    return _rowwise(functools.partial(_combine, s=s), y, tok)


def _experts(x, w):
    """The expert GEMMs: x (B, E, C, K) @ w (E, K, N) -> (B, E, C, N). On
    DTensors one product an expert: einsum's merged (B*C) dim becomes a
    strided shard whose redistribution DTensor plans for minutes."""
    if not rs.is_dtensor(x):
        return torch.einsum("beck,ekn->becn", x, w)
    return torch.stack([x[:, i] @ w[i] for i in range(w.shape[0])], dim=1)


def _combine(y, tok, s: int):
    """The reference's ``.at[t].add(mode="drop")`` of y (B, E*C, D) into
    (B, S+1, D) at rows ``tok`` (B, E*C): row S of each sequence takes the
    empty slots and is sliced off."""
    b, _, d = y.shape
    rows = tok + (s + 1) * torch.arange(b, device=y.device)[:, None]
    out = y.new_zeros((b * (s + 1), d)).index_add(0, rows.reshape(-1),
                                                  y.reshape(-1, d))
    return out.reshape(b, s + 1, d)[:, :s]


def _rowwise(fn, y, *rest):
    """``fn(y, *rest)``; on DTensors sharded on the batch only (a partial
    sum allowed), on each rank's local rows, the result placed as ``y``.
    DTensor has no strategy for ``index_add`` into batch-sharded rows."""
    if not rs.is_dtensor(y):
        return fn(y, *rest)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def rows_only(t):
        return all(p == Shard(0) or p.is_replicate() or p.is_partial()
                   for p in t.placements)

    if not rows_only(y):
        y = shard(y, "batch", *(None,) * (y.dim() - 1))
    rest = tuple(t if rows_only(t) else
                 shard(t, "batch", *(None,) * (t.dim() - 1)) for t in rest)
    # the gradient of a partial sum's summand is the whole gradient
    local = y.to_local(grad_placements=tuple(
        Replicate() if p.is_partial() else p for p in y.placements))
    out = fn(local, *(t.to_local() for t in rest))
    return DTensor.from_local(out, y.device_mesh, y.placements,
                              run_check=False)


def _grad_placements(t, x):
    """Placements of the gradient of ``t`` when each rank computes the
    shard_map body on its own tensors: sharded dims stay, a replicated dim
    becomes ``Partial`` on ``model`` (each model rank adds its F-slice's
    part) and where ``x``'s batch is sharded (each data rank adds its
    rows' part), else stays replicated."""
    from torch.distributed.tensor import Partial
    out = []
    for n, p, xp in zip(t.device_mesh.mesh_dim_names, t.placements,
                        x.placements):
        if p.is_shard():
            out.append(p)
        elif n == rs.AXIS_MODEL or xp.is_shard():
            out.append(Partial())
        else:
            out.append(p)
    return tuple(out)


def _routing(x, logits, k, e, cap, *, local: bool = False):
    """:func:`_dispatch_one`; on DTensors on each rank's local rows (the
    logits sharded on the batch only). ``local``: ``gather_tok`` and
    ``slot_gate`` stay this rank's tensors for the shard_map body, their
    gradient into the logits a partial sum over ``model``; else all three
    are wrapped again."""
    if not rs.is_dtensor(logits):
        return _dispatch_one(x, logits, k, e, cap)
    from torch.distributed.tensor import DTensor
    # whole logits a row: a partial sum (the input sharded on D by a
    # sharded norm weight) is reduced, other dims gathered
    logits = shard(logits, "batch", None, None)
    mesh, pl = logits.device_mesh, logits.placements
    lg = logits.to_local(grad_placements=_grad_placements(logits, logits)
                         if local else None)
    tok, gate, dropped = _dispatch_one(lg, lg, k, e, cap)
    dropped = DTensor.from_local(dropped, mesh, pl, run_check=False)
    if local:
        return tok, gate, dropped
    return (DTensor.from_local(tok, mesh, pl, run_check=False),
            DTensor.from_local(gate, mesh, pl, run_check=False), dropped)


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
    x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)

    if (_MOE_IMPL[0] == "shard_map" and rs.is_dtensor(x)
            and rs.AXIS_MODEL in x.device_mesh.mesh_dim_names
            and rs.AXIS_MODEL not in rs.batch_axes()):
        from torch.distributed.tensor import DTensor
        gather_tok, slot_gate, dropped = _routing(x, logits, k, e, cap,
                                                  local=True)
        # whole rows into the body, as the reference's in_specs: a norm
        # weight sharded on D leaves x sharded there
        x_pad = shard(x_pad, "batch", None, None)
        wg, wu, wd = (params[n] for n in ("w_gate", "w_up", "w_down"))
        for name, w, dim in (("w_gate", wg, 2), ("w_up", wu, 2),
                             ("w_down", wd, 1)):
            want = rs.placements(rs.resolve(
                *(None if i != dim else rs.AXIS_MODEL for i in range(3)),
                shape=tuple(w.shape), mesh=w.device_mesh), w.device_mesh)
            if tuple(w.placements) != want:
                raise ValueError(f"shard_map dispatch: {name} placed "
                                 f"{w.placements}, wants {want}")
        body = functools.partial(_expert_ffn_combine, act=cfg.act, s=s, e=e)
        args = (x_pad.to_local(grad_placements=_grad_placements(x_pad,
                                                                x_pad)),
                slot_gate, gather_tok,
                *(w.to_local(grad_placements=_grad_placements(w, x_pad))
                  for w in (wg, wu, wd)))
        if torch.is_grad_enabled():
            # recompute the body in the backward: its operands are not
            # kept as residuals of the layer's own checkpoint (no RNG in
            # it: see transformer._remat)
            out_l = _checkpoint.checkpoint(body, *args, use_reentrant=False,
                                           preserve_rng_state=False)
        else:
            out_l = body(*args)
        out = DTensor.from_local(out_l, x.device_mesh,
                                 _grad_placements(x_pad, x_pad),
                                 run_check=False)
    else:
        gather_tok, slot_gate, dropped = _routing(x, logits, k, e, cap)
        out = _expert_ffn_combine(
            x_pad, slot_gate, gather_tok, params["w_gate"], params["w_up"],
            params["w_down"], act=cfg.act, s=s, e=e)
    out = shard(out, "batch", None, None)

    # Switch-style load-balance aux: E * sum_e f_e * P_e
    f_e = F.one_hot(logits.argmax(-1), e).float().mean(dim=(0, 1))
    p_e = probs.mean(dim=(0, 1))
    aux = e * (f_e * p_e).sum()
    return out, {"moe_aux": aux,
                 "moe_drop_frac": dropped.sum() / (b * s * k)}
