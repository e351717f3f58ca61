"""Decoder LM (dense and MoE): training loss, prefill and decode, for the
llama-family configs (tinyllama, yi, deepseek, qwen3 with qk-norm and tied
embeddings), the sliding-window ones and mixtral's MoE feed-forward
(:mod:`repro_torch.models.moe`).

Parameters are nested dicts keyed as in the reference, except that
``layers`` is a list with one dict per layer where the reference stacks
them on a leading axis for ``lax.scan``: depth is a Python loop here.
:class:`DecoderLM` holds them as an ``nn.Module`` under the reference's
names, :func:`lm_params_from_jax` turns a reference parameter tree into
its ``state_dict`` and :func:`nest_params` a ``state_dict`` into the
nested dict. With grad enabled every layer runs under
``torch.utils.checkpoint`` in the mode :func:`set_remat_mode` picks, as
the reference's ``jax.checkpoint`` with its policy.
"""
from __future__ import annotations

import functools
from collections.abc import Mapping
from typing import Any

import torch
from torch.utils import checkpoint as _checkpoint

from repro_torch.models import attention, common, moe
from repro_torch.runtime.sharding import shard

#: ops whose outputs a remat mode saves (None: save the layer input only):
#: "dots" is ``checkpoint_dots`` (every matmul), "dots_no_batch"
#: ``checkpoint_dots_with_no_batch_dims`` (no batched matmul)
REMAT_SAVED_OPS = {
    "full": None,
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.bmm.default),
    "dots_no_batch": (torch.ops.aten.mm.default,),
}
_REMAT_MODE = ["full"]          # mutable: launch-time perf knob


def set_remat_mode(mode: str) -> None:
    if mode not in REMAT_SAVED_OPS:
        raise ValueError(f"unknown remat mode {mode!r}")
    _REMAT_MODE[0] = mode


def _remat(fn, *args):
    """``fn(*args)``, checkpointed in the current remat mode when grad is
    enabled: the backward recomputes what the mode does not save."""
    if not torch.is_grad_enabled():
        return fn(*args)
    ops = REMAT_SAVED_OPS[_REMAT_MODE[0]]
    kw = {} if ops is None else {"context_fn": functools.partial(
        _checkpoint.create_selective_checkpoint_contexts, list(ops))}
    return _checkpoint.checkpoint(fn, *args, use_reentrant=False, **kw)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg, dtype) -> dict:
    p = {"ln1": common.init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
         "ln2": common.init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
         "attn": attention.init_attention(gen, cfg, dtype)}
    if cfg.n_experts:
        p["moe"] = moe.init_moe(gen, cfg, dtype)
    else:
        p["mlp"] = common.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                   gated=cfg.act == "silu")
    return p


def init_lm(cfg, gen: torch.Generator) -> dict:
    """Random parameters drawn from ``gen``, on its device, in cfg.dtype
    (the MoE router in float32)."""
    dtype = common.dtype_of(cfg)
    params = {
        "embed": common.normal(gen, (cfg.vocab, cfg.d_model), 0.02, dtype),
        "layers": [init_layer(gen, cfg, dtype) for _ in range(cfg.n_layers)],
        "final_norm": common.init_norm(cfg.norm, cfg.d_model, dtype,
                                       gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = common.normal(
            gen, (cfg.d_model, cfg.vocab), cfg.d_model ** -0.5, dtype)
    return params


class DecoderLM(common.ParamTree):
    """The parameters of a decoder LM under the reference's names:
    ``embed``, ``layers.<i>.{ln1,ln2}.w``, ``layers.<i>.attn.{wq,wk,wv,wo}``
    (and ``q_norm``, ``k_norm``), ``layers.<i>.mlp.{w_up,w_gate,w_down}``
    or, MoE, ``layers.<i>.moe.{router,w_gate,w_up,w_down}`` (the router
    float32), ``final_norm.w`` and, untied, ``lm_head``.

    Weights come from :func:`init_lm` with ``generator`` (None: a fresh one
    on the device, seeded 0), on ``device`` (None: the card; raises without
    one). :meth:`params` is the nested dict the functions of this module
    take.
    """

    def __init__(self, cfg, *, device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        _, gen = common.generator_for(device, generator)
        super().__init__(init_lm(cfg, gen))
        self.cfg = cfg


def lm_params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """A :class:`DecoderLM` ``state_dict`` from a reference parameter tree
    (``repro.models.transformer.init_lm`` mapped through ``np.asarray``):
    the leading layer axis of ``layers`` is split into ``layers.<i>``.
    Values are float32; ``load_state_dict`` casts them to the model's
    dtype (the router stays float32)."""
    return common.params_from_jax(tree, stacked=("layers",))


#: the nested parameter dict of a ``state_dict`` (every family's)
nest_params = common.nest_params


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------

def _ffn(lp, x, cfg):
    """The layer's feed-forward: (out, moe_aux, moe_drop_frac)."""
    if cfg.n_experts:
        out, metrics = moe.moe_ffn(lp["moe"], x, cfg)
        return out, metrics["moe_aux"], metrics["moe_drop_frac"]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return common.mlp(lp["mlp"], x, cfg.act), zero, zero


def _layer_full(lp, h, cfg, impl: str = "kernel"):
    a_in = common.norm(h, lp["ln1"], cfg.norm)
    a_out, kv = attention.attend_full(lp["attn"], a_in, cfg, impl=impl)
    h = h + a_out
    m_in = common.norm(h, lp["ln2"], cfg.norm)
    m_out, aux, drop = _ffn(lp, m_in, cfg)
    return shard(h + m_out, "batch", None, None), aux, drop, kv


def forward_embeds(params, h, cfg, *, collect_kv: bool = False,
                   impl: str = "kernel"):
    """h (B, S, D) embeddings -> (hidden, aux, per-layer (k, v) list |
    None); aux holds ``moe_aux`` and ``moe_drop_frac`` averaged over the
    layers (zeros for a dense model)."""
    h = shard(h, "batch", None, None)
    aux = drop = torch.zeros((), dtype=torch.float32, device=h.device)
    kvs = []
    for lp in params["layers"]:
        h, a, d, kv = _remat(functools.partial(_layer_full, cfg=cfg,
                                               impl=impl), lp, h)
        aux, drop = aux + a, drop + d
        if collect_kv:
            kvs.append(kv)
    h = common.norm(h, params["final_norm"], cfg.norm)
    n_l = cfg.n_layers
    return h, {"moe_aux": aux / n_l, "moe_drop_frac": drop / n_l}, \
        (kvs if collect_kv else None)


def logits_fn(params, h, cfg):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return shard(common.dot(h, w), "batch", None, "model")


def lm_loss(params, batch: dict[str, Any], cfg, *, impl: str = "kernel"):
    """Next-token CE (+ MoE aux). batch: tokens (B, S) [, loss_mask (B, S)]
    tensors on the parameters' device. Returns (loss, {"ce", "moe_aux",
    "moe_drop_frac"}); ``impl`` as in :func:`attention.attend_full`."""
    inputs, targets = common.shift_labels(batch["tokens"])
    h = common.embed(params["embed"], inputs)
    h, aux, _ = forward_embeds(params, h, cfg, impl=impl)
    logits = logits_fn(params, h, cfg)
    mask = batch.get("loss_mask")
    mask = mask[:, 1:] if mask is not None else None
    loss = common.cross_entropy(logits, targets, mask)
    metrics = {"ce": loss, **aux}
    if cfg.n_experts:
        loss = loss + cfg.router_aux_coef * aux["moe_aux"]
    return loss, metrics


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def cache_capacity(cfg, max_context: int) -> int:
    return min(max_context, cfg.swa_window) if cfg.swa_window else max_context


def step_tensor(step: int, device) -> torch.Tensor:
    """A cache's ``step``: the next absolute position as an int32 scalar on
    ``device``, as the reference holds it."""
    return torch.tensor(step, dtype=torch.int32, device=device)


def init_cache(cfg, batch: int, max_context: int, device=None) -> dict:
    dtype = common.dtype_of(cfg)
    cap = cache_capacity(cfg, max_context)
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    shape = (cfg.n_layers, batch, cap, kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((cap,), -1, dtype=torch.int32, device=device),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def prefill(params, tokens: torch.Tensor, cfg, *, max_context: int,
            impl: str = "kernel"):
    """tokens (B, S) -> (last-token logits (B, V), cache).

    The cache holds k and v (L, B, C, KV, hd), pos (C,) and ``step``, the
    next absolute position, an int32 scalar on the device.
    """
    s = tokens.shape[1]
    cap = cache_capacity(cfg, max_context)
    h = common.embed(params["embed"], tokens)
    h, _, kvs = forward_embeds(params, h, cfg, collect_kv=True, impl=impl)
    logits = logits_fn(params, h[:, -1:], cfg)[:, 0]
    caches = [attention.cache_from_prefill(k, v, cap) for k, v in kvs]
    return logits, {"k": torch.stack([c.k for c in caches]),
                    "v": torch.stack([c.v for c in caches]),
                    "pos": caches[0].pos,
                    "step": step_tensor(s, tokens.device)}


@torch.no_grad()
def decode_step(params, cache: dict, tokens: torch.Tensor, cfg):
    """tokens (B, 1) -> (logits (B, 1, V), cache). One step, all layers.

    The cache's tensors are updated in place (see
    :func:`attention.attend_decode`), ``step`` too, advanced by one on the
    device; the returned dict shares them.
    """
    step = cache["step"]
    cap = cache["k"].shape[2]
    h = shard(common.embed(params["embed"], tokens), "batch", None, None)
    # shared by all layers: once
    common.write_at(cache["pos"], 0, attention.decode_slot(step, cap),
                    step.reshape(1))
    for i, lp in enumerate(params["layers"]):
        a_in = common.norm(h, lp["ln1"], cfg.norm)
        kvc = attention.KVCache(k=cache["k"][i], v=cache["v"][i],
                                pos=cache["pos"])
        a_out, _ = attention.attend_decode(lp["attn"], a_in, cfg, kvc, step)
        h = h + a_out
        m_in = common.norm(h, lp["ln2"], cfg.norm)
        h = h + _ffn(lp, m_in, cfg)[0]
    h = common.norm(h, params["final_norm"], cfg.norm)
    step.add_(1)
    return logits_fn(params, h, cfg), cache
