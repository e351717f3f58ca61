"""RecurrentGemma / Griffin: RG-LRU recurrent blocks and local attention,
1:2 attention:recurrent [arXiv:2402.19427], the reference's
``src/repro/models/rglru.py``.

Layers repeat (rec, rec, attn) in groups, plus a tail of recurrent layers
when ``n_layers % 3 != 0``. The RG-LRU linear recurrence runs as a
log-depth (Hillis-Steele) scan over the sequence in float32 for training
and prefill, where the reference runs ``lax.associative_scan``, and as one
step in decode. Gates are block-diagonal per head. The attention layers
go through :func:`attention.attend_full` with ``window=cfg.local_window``:
kernel 5 on the card.

Parameters are nested dicts keyed as in the reference, ``groups`` a list
of ``{rec0, rec1, attn}`` dicts where the reference stacks them, ``tail``
a list; ``lam`` stays float32. :class:`RGLRULM` holds them as an
``nn.Module`` and :func:`params_from_jax` turns a reference tree into its
``state_dict``.

Under a mesh the block-diagonal gates run on each rank's batch rows with
the width whole (``runtime.sharding.local_map``): 10 heads do not split
over a 16-way ``model`` axis, and DTensor reshapes only whole shards.
"""
from __future__ import annotations

import functools
from collections.abc import Mapping

import torch
import torch.nn.functional as F

from repro_torch.models import attention, common, transformer
from repro_torch.runtime.sharding import local_map, shard

C_RGLRU = 8.0


def lru_width(cfg) -> int:
    return cfg.lru_width or cfg.d_model


def _pattern(cfg):
    n_groups = cfg.n_layers // 3
    tail = cfg.n_layers - 3 * n_groups          # trailing rec layers
    return n_groups, tail


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_rec_layer(gen, cfg, dtype) -> dict:
    d, w, h = cfg.d_model, lru_width(cfg), cfg.n_heads
    bh = w // h
    dev = gen.device
    return {
        "ln": common.init_norm(cfg.norm, d, dtype, dev),
        "w_x": common.normal(gen, (d, w), d ** -0.5, dtype),
        "w_gate_branch": common.normal(gen, (d, w), d ** -0.5, dtype),
        "conv_w": common.normal(gen, (cfg.conv_width, w), 0.5, dtype),
        "conv_b": torch.zeros(w, dtype=dtype, device=dev),
        "gate_i": common.normal(gen, (h, bh, bh), bh ** -0.5, dtype),
        "gate_r": common.normal(gen, (h, bh, bh), bh ** -0.5, dtype),
        # sigmoid(lam) ~ 0.9..0.999 decay band
        "lam": torch.linspace(2.2, 6.9, w, dtype=torch.float32, device=dev),
        "w_out": common.normal(gen, (w, d), w ** -0.5, dtype),
        "ln2": common.init_norm(cfg.norm, d, dtype, dev),
        "mlp": common.init_mlp(gen, d, cfg.d_ff, dtype, gated=True),
    }


def init_attn_layer(gen, cfg, dtype) -> dict:
    dev = gen.device
    return {
        "ln": common.init_norm(cfg.norm, cfg.d_model, dtype, dev),
        "attn": attention.init_attention(gen, cfg, dtype),
        "ln2": common.init_norm(cfg.norm, cfg.d_model, dtype, dev),
        "mlp": common.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                               gated=True),
    }


def init_lm(cfg, gen) -> dict:
    """Random parameters drawn from ``gen``, on its device, in cfg.dtype
    (``lam`` float32)."""
    dtype = common.dtype_of(cfg)
    n_groups, tail = _pattern(cfg)
    return {
        "embed": common.normal(gen, (cfg.vocab, cfg.d_model), 0.02, dtype),
        "groups": [{"rec0": init_rec_layer(gen, cfg, dtype),
                    "rec1": init_rec_layer(gen, cfg, dtype),
                    "attn": init_attn_layer(gen, cfg, dtype)}
                   for _ in range(n_groups)],
        "final_norm": common.init_norm(cfg.norm, cfg.d_model, dtype,
                                       gen.device),
        "tail": [init_rec_layer(gen, cfg, dtype) for _ in range(tail)],
    }


class RGLRULM(common.ParamTree):
    """The parameters of a RecurrentGemma LM under the reference's names:
    ``embed`` (tied to the output), ``groups.<i>.{rec0,rec1,attn}...``,
    ``final_norm.w`` and ``tail.<i>...``; drawn by :func:`init_lm` from
    ``generator`` (None: seeded 0) on ``device`` (None: the card). An
    empty tail has no ``state_dict`` keys: the functions read a missing
    ``tail`` as empty."""

    def __init__(self, cfg, *, device=None, generator=None):
        _, gen = common.generator_for(device, generator)
        super().__init__(init_lm(cfg, gen))
        self.cfg = cfg


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """An :class:`RGLRULM` ``state_dict`` from a reference tree: the
    stacked ``groups`` axis split into ``groups.<i>``, the ``tail`` list
    under ``tail.<i>``."""
    return common.params_from_jax(tree, stacked=("groups",))


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _gate_values(x, gate_r, gate_i, h: int):
    xh = x.reshape(*x.shape[:-1], h, x.shape[-1] // h)
    r = torch.sigmoid(torch.einsum("...hc,hcd->...hd", xh, gate_r)
                      .reshape(x.shape).float())
    i = torch.sigmoid(torch.einsum("...hc,hcd->...hd", xh, gate_i)
                      .reshape(x.shape).float())
    return r, i


def _gates(lp, x, cfg):
    """Block-diagonal per-head gates. x (..., W) -> (r, i) in float32.
    Under a mesh on each rank's batch rows with W whole
    (``runtime.sharding.local_map``): W sharded finer than whole heads (10
    heads on a 16-way axis) cannot be split into heads by DTensor."""
    whole = (None,) * (x.dim() - 1)
    return local_map(functools.partial(_gate_values, h=cfg.n_heads),
                     (x, lp["gate_r"], lp["gate_i"]), free=((0,), (), ()),
                     outs=(((0, 0),) + whole, ((0, 0),) + whole))


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 (h_{-1} = 0), by Hillis-Steele
    doubling: ceil(log2 S) passes of (a, b) <- (a_{t-d} a_t,
    a_t b_{t-d} + b_t), each out of place (autograd keeps them)."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rg_lru_full(lp, x, cfg, h0=None):
    """x (B, S, W) -> (y in x's dtype, h_last (B, W) float32)."""
    r, i = _gates(lp, x, cfg)
    log_a = -C_RGLRU * r * F.softplus(lp["lam"])              # (B,S,W)
    a = torch.exp(log_a)
    gated_x = i * x.float()
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gated_x
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    h = _linear_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def rg_lru_step(lp, x, cfg, h_prev):
    """x (B, 1, W), h_prev (B, W) float32 -> (y (B, 1, W), h_new)."""
    r, i = _gates(lp, x, cfg)
    log_a = -C_RGLRU * r[:, 0] * F.softplus(lp["lam"])
    a = torch.exp(log_a)
    gated_x = i[:, 0] * x[:, 0].float()
    h_new = a * h_prev + torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) \
        * gated_x
    return h_new[:, None].to(x.dtype), h_new


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _gelu(x):
    return F.gelu(x, approximate="tanh")        # jax.nn.gelu's default


def _rec_temporal_full(lp, x, cfg, h0=None, conv_state=None):
    """The recurrent temporal block over the whole sequence: (out, h_last,
    the last ``conv_width - 1`` conv inputs)."""
    bx = shard(x @ lp["w_x"], "batch", None, "model")
    gate = _gelu(shard(x @ lp["w_gate_branch"], "batch", None, "model"))
    width = lp["conv_w"].shape[0]
    if conv_state is None:
        pad = common.pad_front(bx, width - 1)
    else:
        pad = torch.cat([conv_state, bx], dim=1)
    s = x.shape[1]
    conv = pad[:, 0:s] * lp["conv_w"][0]
    for i in range(1, width):
        conv = conv + pad[:, i:i + s] * lp["conv_w"][i]
    conv = conv + lp["conv_b"]
    y, h_last = rg_lru_full(lp, conv, cfg, h0)
    out = shard((y * gate) @ lp["w_out"], "batch", None, None)
    return out, h_last, pad[:, pad.shape[1] - (width - 1):]


def rec_layer_full(lp, h, cfg):
    t_out, h_last, conv_state = _rec_temporal_full(
        lp, common.norm(h, lp["ln"], cfg.norm), cfg)
    h = h + t_out
    m = common.mlp(lp["mlp"], common.norm(h, lp["ln2"], cfg.norm), cfg.act)
    return h + m, (h_last, conv_state)


def attn_layer_full(lp, h, cfg, impl: str = "kernel"):
    a_out, kv = attention.attend_full(lp["attn"],
                                      common.norm(h, lp["ln"], cfg.norm), cfg,
                                      window=cfg.local_window, impl=impl)
    h = h + a_out
    m = common.mlp(lp["mlp"], common.norm(h, lp["ln2"], cfg.norm), cfg.act)
    return h + m, kv


def rec_layer_decode(lp, h, cfg, rec_h, conv_state):
    x = common.norm(h, lp["ln"], cfg.norm)
    bx = x @ lp["w_x"]
    gate = _gelu(x @ lp["w_gate_branch"])
    window = torch.cat([conv_state, bx], dim=1)
    conv = (window * lp["conv_w"][None]).sum(1, keepdim=True) + lp["conv_b"]
    y, h_new = rg_lru_step(lp, conv, cfg, rec_h)
    h = h + (y * gate) @ lp["w_out"]
    m = common.mlp(lp["mlp"], common.norm(h, lp["ln2"], cfg.norm), cfg.act)
    return h + m, h_new, window[:, 1:]


def attn_layer_decode(lp, h, cfg, kvc: attention.KVCache,
                      step: torch.Tensor):
    a_in = common.norm(h, lp["ln"], cfg.norm)
    a_out, kvc = attention.attend_decode(lp["attn"], a_in, cfg, kvc, step,
                                         window=cfg.local_window)
    h = h + a_out
    m = common.mlp(lp["mlp"], common.norm(h, lp["ln2"], cfg.norm), cfg.act)
    return h + m, kvc


# ---------------------------------------------------------------------------
# LM-level API
# ---------------------------------------------------------------------------

def _group_full(gp, h, cfg, impl):
    """One (rec, rec, attn) group: (h, ((h0, c0), (h1, c1)), (k, v))."""
    h, rc0 = rec_layer_full(gp["rec0"], h, cfg)
    h, rc1 = rec_layer_full(gp["rec1"], h, cfg)
    h, kv = attn_layer_full(gp["attn"], h, cfg, impl)
    return h, (rc0, rc1), kv


def lm_loss(params, batch: dict, cfg, *, impl: str = "kernel"):
    """Next-token CE, logits through the tied embedding. batch: tokens
    (B, S) [, loss_mask (B, S), shifted as the decoder's]. Each group runs
    under ``transformer._remat`` (the tail does not, as in the reference);
    ``impl`` as in :func:`attention.attend_full`."""
    inputs, targets = common.shift_labels(batch["tokens"])
    h = shard(common.embed(params["embed"], inputs), "batch", None, None)
    body = functools.partial(_group_full, cfg=cfg, impl=impl)
    for gp in params["groups"]:
        h = transformer._remat(lambda g, x: body(g, x)[0], gp, h)
    for lp in params.get("tail", ()):
        h, _ = rec_layer_full(lp, h, cfg)
    h = common.norm(h, params["final_norm"], cfg.norm)
    logits = shard(h @ params["embed"].T, "batch", None, "model")
    mask = batch.get("loss_mask")
    loss = common.cross_entropy(logits, targets,
                                mask[:, 1:] if mask is not None else None)
    return loss, {"ce": loss}


def init_cache(cfg, batch: int, max_context: int, device=None) -> dict:
    dtype = common.dtype_of(cfg)
    n_groups, tail = _pattern(cfg)
    w = lru_width(cfg)
    cap = min(max_context, cfg.local_window)
    kvh, hd = cfg.n_kv_heads, cfg.head_dim_
    f32 = torch.float32

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "rec_h": zeros((n_groups, 2, batch, w), f32),
        "rec_conv": zeros((n_groups, 2, batch, cfg.conv_width - 1, w), dtype),
        "k": zeros((n_groups, batch, cap, kvh, hd), dtype),
        "v": zeros((n_groups, batch, cap, kvh, hd), dtype),
        "pos": torch.full((cap,), -1, dtype=torch.int32, device=device),
        "tail_h": zeros((max(tail, 1), batch, w), f32),
        "tail_conv": zeros((max(tail, 1), batch, cfg.conv_width - 1, w),
                           dtype),
        "step": transformer.step_tensor(0, device),
    }


@torch.no_grad()
def prefill(params, tokens: torch.Tensor, cfg, *, max_context: int,
            impl: str = "kernel"):
    """tokens (B, S) -> (last-token logits (B, V), cache): the recurrent
    states and conv inputs of every rec layer, the attention layers'
    rolling KV caches (capacity min(max_context, local_window)), ``pos``
    and ``step``, an int32 scalar on the device. ``impl`` as in
    :func:`attention.attend_full`."""
    s = tokens.shape[1]
    cap = min(max_context, cfg.local_window)
    h = common.embed(params["embed"], tokens)
    rec_h, rec_conv, ks, vs = [], [], [], []
    pos = None
    for gp in params["groups"]:
        h, ((h0, c0), (h1, c1)), (k, v) = _group_full(gp, h, cfg, impl)
        kvc = attention.cache_from_prefill(k, v, cap)
        rec_h.append(torch.stack([h0, h1]))
        rec_conv.append(torch.stack([c0, c1]))
        ks.append(kvc.k)
        vs.append(kvc.v)
        pos = kvc.pos
    cache = init_cache(cfg, tokens.shape[0], max_context, device=h.device)
    if params["groups"]:
        cache.update(rec_h=torch.stack(rec_h), rec_conv=torch.stack(rec_conv),
                     k=torch.stack(ks), v=torch.stack(vs), pos=pos)
    tail_h, tail_conv = [], []
    for lp in params.get("tail", ()):
        h, (hl, cl) = rec_layer_full(lp, h, cfg)
        tail_h.append(hl)
        tail_conv.append(cl)
    if tail_h:
        cache.update(tail_h=torch.stack(tail_h),
                     tail_conv=torch.stack(tail_conv))
    h = common.norm(h, params["final_norm"], cfg.norm)
    logits = (h[:, -1:] @ params["embed"].T)[:, 0]
    cache["step"] = transformer.step_tensor(s, h.device)
    return logits, cache


@torch.no_grad()
def decode_step(params, cache: dict, tokens: torch.Tensor, cfg):
    """tokens (B, 1) -> (logits (B, 1, V), cache). The cache's tensors are
    updated in place (see :func:`attention.attend_decode`), ``step`` too,
    advanced by one on the device; the returned dict shares them."""
    step = cache["step"]
    cap = cache["k"].shape[2]
    h = common.embed(params["embed"], tokens)
    # shared by all groups: once
    common.write_at(cache["pos"], 0, attention.decode_slot(step, cap),
                    step.reshape(1))
    for g, gp in enumerate(params["groups"]):
        for j, name in enumerate(("rec0", "rec1")):
            h, rh, rc = rec_layer_decode(gp[name], h, cfg,
                                         cache["rec_h"][g, j],
                                         cache["rec_conv"][g, j])
            cache["rec_h"][g, j] = rh
            cache["rec_conv"][g, j] = rc
        kvc = attention.KVCache(k=cache["k"][g], v=cache["v"][g],
                                pos=cache["pos"])
        h, _ = attn_layer_decode(gp["attn"], h, cfg, kvc, step)
    for i, lp in enumerate(params.get("tail", ())):
        h, rh, rc = rec_layer_decode(lp, h, cfg, cache["tail_h"][i],
                                     cache["tail_conv"][i])
        cache["tail_h"][i] = rh
        cache["tail_conv"][i] = rc
    h = common.norm(h, params["final_norm"], cfg.norm)
    step.add_(1)
    return shard(h @ params["embed"].T, "batch", None, "model"), cache
