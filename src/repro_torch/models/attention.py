"""GQA attention with RoPE, optional qk-norm (qwen3), sliding window
(mixtral / recurrentgemma local), full-sequence and single-step decode
paths.

The full-sequence path dispatches through kernels/flash_attention/ops (the
CUDA kernel on the card, its plain version on the CPU; under a mesh on
each rank's own heads); the decode path is plain PyTorch over a (possibly
rolling) KV cache, as in the reference. q, k, v and the output projection
are pinned with ``runtime.sharding.shard`` where the reference pins them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models import common
from repro_torch.runtime.sharding import is_dtensor, resolve, shard


def init_attention(gen: torch.Generator, cfg, dtype) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {
        "wq": common.normal(gen, (d, h * hd), d ** -0.5, dtype),
        "wk": common.normal(gen, (d, kv * hd), d ** -0.5, dtype),
        "wv": common.normal(gen, (d, kv * hd), d ** -0.5, dtype),
        "wo": common.normal(gen, (h * hd, d), (h * hd) ** -0.5, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(hd, dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros(hd, dtype=dtype, device=gen.device)
    return p


def _heads(t, n: int, hd: int):
    """(B, S, n*hd) -> (B, S, n, hd) pinned on its heads over ``model``.
    A DTensor whose columns are sharded finer than whole heads (4 KV heads
    on a 16-way axis: the reference's GQA trap) is gathered on them first:
    DTensor reshapes only whole shards."""
    b, s, _ = t.shape
    if is_dtensor(t):
        heads = resolve("batch", None, "model", None, shape=(b, s, n, hd),
                        mesh=t.device_mesh)
        t = shard(t, "batch", None, heads[2])
    return shard(t.reshape(b, s, n, hd), "batch", None, "model", None)


def _qkv(params, x, cfg, positions):
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = _heads(common.dot(x, params["wq"]), h, hd)
    k = _heads(common.dot(x, params["wk"]), kv, hd)
    v = _heads(common.dot(x, params["wv"]), kv, hd)
    if cfg.qk_norm:
        q = common.rms_norm(q, params["q_norm"])
        k = common.rms_norm(k, params["k_norm"])
    q = common.rope(q, positions, cfg.rope_theta)
    k = common.rope(k, positions, cfg.rope_theta)
    return q, k, v


def attend_full(params, x, cfg, *, window: int | None = None,
                impl: str = "kernel"):
    """Prefill attention over the whole sequence.

    Returns (out, (k, v)), k and v in (B, S, KV, hd) layout for the cache.
    The kernel takes contiguous (B, H, S, hd) tensors: the transposes cost
    one copy of q, k and v per layer.
    """
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _qkv(params, x, cfg, positions)
    w = cfg.swa_window if window is None else window
    o = attn_ops.attention(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), causal=cfg.causal, window=w,
        impl=impl)
    o = o.transpose(1, 2).reshape(b, s, -1)
    return shard(common.dot(o, params["wo"]), "batch", None, None), (k, v)


class KVCache(NamedTuple):
    """Rolling KV cache: capacity C = min(max context, SWA window)."""

    k: torch.Tensor      # (B, C, KV, hd)
    v: torch.Tensor      # (B, C, KV, hd)
    pos: torch.Tensor    # (C,) absolute position held in each slot, -1 empty


def init_kv_cache(cfg, batch: int, capacity: int, dtype,
                  device=None) -> KVCache:
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    return KVCache(
        k=torch.zeros((batch, capacity, kv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, capacity, kv, hd), dtype=dtype, device=device),
        pos=torch.full((capacity,), -1, dtype=torch.int32, device=device))


def cache_from_prefill(k: torch.Tensor, v: torch.Tensor,
                       capacity: int) -> KVCache:
    """Keep the trailing ``capacity`` positions of a prefill's K/V."""
    s = k.shape[1]
    dev = k.device
    if s >= capacity:
        k_c, v_c = k[:, s - capacity:], v[:, s - capacity:]
        pos = torch.arange(s - capacity, s, dtype=torch.int32, device=dev)
        # slot layout must match decode's (pos % capacity) indexing
        order = torch.argsort(pos % capacity)
        return KVCache(k=k_c[:, order], v=v_c[:, order], pos=pos[order])
    pad = capacity - s
    return KVCache(
        k=F.pad(k, (0, 0, 0, 0, 0, pad)), v=F.pad(v, (0, 0, 0, 0, 0, pad)),
        pos=torch.cat([torch.arange(s, dtype=torch.int32, device=dev),
                       torch.full((pad,), -1, dtype=torch.int32,
                                  device=dev)]))


def decode_slot(step: torch.Tensor, capacity: int) -> torch.Tensor:
    """The cache slot of position ``step`` (an int32 scalar on the
    device): ``step % capacity`` as a (1,) int64 index, on the device."""
    return (step % capacity).reshape(1).long()


def attend_decode(params, x, cfg, cache: KVCache, step: torch.Tensor, *,
                  window: int | None = None):
    """One-token decode against the cache. x (B, 1, D); ``step`` is the
    absolute position, an int32 scalar on the cache's device, as the
    reference's: the slot, the position and the masks are computed on the
    device, so a captured step (``launch/serve.generate``) reads its
    position at each replay.

    Returns (out, cache). Unlike the reference, which returns a new cache,
    the cache's k and v are updated in place (slot ``step % C``) and the
    same cache is returned: a caller that needs the cache as it was must
    clone it first. ``pos`` is shared by every layer, so the caller writes
    ``pos[step % C] = step`` once per step, before the first layer.
    """
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q, k_new, v_new = _qkv(params, x, cfg, step.reshape(1))

    slot = decode_slot(step, cache.k.shape[1])
    common.write_at(cache.k, 1, slot, k_new)
    common.write_at(cache.v, 1, slot, v_new)

    w = cfg.swa_window if window is None else window
    valid = (cache.pos >= 0) & (cache.pos <= step)
    if w and w > 0:
        valid &= cache.pos > step - w
    group = h // kvh
    if is_dtensor(q):
        # q's heads keep 'model' only if the KV heads they split into do
        kv_dim = resolve("batch", None, "model", None, None,
                         shape=(b, 1, kvh, group, hd),
                         mesh=q.device_mesh)[2]
        q = shard(q, "batch", None, kv_dim, None)
    qh = q.reshape(b, 1, kvh, group, hd)
    # scores in float32, as the reference's preferred_element_type does
    s_ = torch.einsum("bqkgd,bckd->bkgqc", qh.float(),
                      cache.k.float()) * (hd ** -0.5)
    s_ = torch.where(valid, s_, torch.full((), -1e30, device=x.device))
    p = torch.softmax(s_, dim=-1)
    o = torch.einsum("bkgqc,bckd->bqkgd", p.to(cache.v.dtype).float(),
                     cache.v.float())
    o = o.reshape(b, 1, h * hd).to(x.dtype)
    return shard(o @ params["wo"], "batch", None, None), cache
