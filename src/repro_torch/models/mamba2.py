"""Mamba2: SSD (state-space duality) blocks [arXiv:2405.21060], the
reference's ``src/repro/models/mamba2.py``.

Attention-free: no kernel of the port runs here. The chunked SSD algorithm
is the quadratic intra-chunk dual form in batched matmuls, then a loop over
the chunks that carries the (H, P, N) state; decode is one recurrence step
on that state.

Parameters are nested dicts keyed as in the reference, ``layers`` a list
with one dict per layer; ``A_log``, ``D_skip`` and ``dt_bias`` stay
float32 in a bf16 model, as the reference keeps them. :class:`Mamba2LM`
holds them as an ``nn.Module`` and :func:`params_from_jax` turns a
reference tree into its ``state_dict``.

Unlike the reference, :func:`prefill` keeps the last ``conv_width - 1``
pre-conv rows left-padded with zeros, the state the causal conv saw: equal
to the reference's for prompts of at least ``conv_width - 1`` tokens, and
right for shorter ones, where the reference's cache has too few rows and
its next ``decode_step`` fails (ROADMAP §3 item 12).

Under a mesh (DTensor parameters) the SSD scan and the decode step run on
each rank's batch rows and heads (``runtime.sharding.local_map``): both
are independent along them, and DTensor plans their batched matmuls over
merged sharded dims for minutes; the ``in_proj`` output is gathered
whole before its split into z, xBC and dt, which straddle its column
shards.
"""
from __future__ import annotations

import functools
import math
from collections.abc import Mapping

import torch
import torch.nn.functional as F

from repro_torch.models import common, transformer
from repro_torch.runtime.sharding import is_dtensor, local_map, shard


def dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_headdim
    n_state = cfg.ssm_state
    conv_dim = d_inner + 2 * n_state           # x, B, C (n_groups = 1)
    return d_inner, n_heads, n_state, conv_dim


def init_layer(gen, cfg, dtype) -> dict:
    d = cfg.d_model
    d_inner, h, n, conv_dim = dims(cfg)
    d_proj = 2 * d_inner + 2 * n + h            # z, xBC, dt
    dev = gen.device
    f32 = torch.float32
    return {
        "ln": common.init_norm(cfg.norm, d, dtype, dev),
        "in_proj": common.normal(gen, (d, d_proj), d ** -0.5, dtype),
        "conv_w": common.normal(gen, (cfg.conv_width, conv_dim), 0.5, dtype),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32,
                                          device=dev)),
        "D_skip": torch.ones(h, dtype=f32, device=dev),
        "dt_bias": torch.full((h,), math.log(math.expm1(0.01)), dtype=f32,
                              device=dev),
        "norm_w": torch.zeros(d_inner, dtype=dtype, device=dev),
        "out_proj": common.normal(gen, (d_inner, d), d_inner ** -0.5, dtype),
    }


def init_lm(cfg, gen) -> dict:
    """Random parameters drawn from ``gen``, on its device, in cfg.dtype
    (``A_log``, ``D_skip``, ``dt_bias`` float32)."""
    dtype = common.dtype_of(cfg)
    return {
        "embed": common.normal(gen, (cfg.vocab, cfg.d_model), 0.02, dtype),
        "layers": [init_layer(gen, cfg, dtype) for _ in range(cfg.n_layers)],
        "final_norm": common.init_norm(cfg.norm, cfg.d_model, dtype,
                                       gen.device),
        "lm_head": common.normal(gen, (cfg.d_model, cfg.vocab),
                                 cfg.d_model ** -0.5, dtype),
    }


class Mamba2LM(common.ParamTree):
    """The parameters of a Mamba2 LM under the reference's names:
    ``embed``, ``layers.<i>.{ln.w,in_proj,conv_w,conv_b,A_log,D_skip,
    dt_bias,norm_w,out_proj}``, ``final_norm.w``, ``lm_head``; drawn by
    :func:`init_lm` from ``generator`` (None: seeded 0) on ``device``
    (None: the card)."""

    def __init__(self, cfg, *, device=None, generator=None):
        _, gen = common.generator_for(device, generator)
        super().__init__(init_lm(cfg, gen))
        self.cfg = cfg


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """A :class:`Mamba2LM` ``state_dict`` from a reference tree: the
    stacked ``layers`` axis split into ``layers.<i>``."""
    return common.params_from_jax(tree, stacked=("layers",))


# ---------------------------------------------------------------------------
# SSD chunked scan
# ---------------------------------------------------------------------------

def _segsum(loga: torch.Tensor) -> torch.Tensor:
    """loga (..., Q) -> (..., Q, Q) lower-triangular cumulative sums, -inf
    above the diagonal."""
    cs = torch.cumsum(loga, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    q = loga.shape[-1]
    tril = torch.ones((q, q), dtype=torch.bool, device=loga.device).tril()
    return d.masked_fill(~tril, float("-inf"))


def ssd_chunked(u, loga, b_mat, c_mat, chunk: int, init_state=None):
    """SSD: h_t = exp(loga_t) h_{t-1} + u_t (x) b_t ;  y_t = c_t . h_t.

    u (B, S, H, P); loga (B, S, H); b_mat, c_mat (B, S, N) (shared by the
    heads). Returns (y (B, S, H, P) in u's dtype, final state (B, H, P, N)
    float32). The reference's three-operand einsums are pairwise batched
    matmuls here: no (B, nc, Q, Q, H, P) product is formed.
    """
    bsz, s, h, p = u.shape
    n = b_mat.shape[-1]
    s_orig = s
    if s % chunk:
        # pad with identity steps: loga=0 (decay 1), u=c=0 -> the state
        # passes through untouched, padded outputs are zero and sliced off
        pad = chunk - s % chunk
        u = F.pad(u, (0, 0, 0, 0, 0, pad))
        loga = F.pad(loga, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    f32 = torch.float32
    uu = u.reshape(bsz, nc, chunk, h, p).permute(0, 3, 1, 2, 4).to(f32)
    la = loga.reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2)   # (B,H,nc,Q)
    b_c = b_mat.reshape(bsz, nc, chunk, n).to(f32)
    c_c = c_mat.reshape(bsz, nc, chunk, n).to(f32)

    a_cum = torch.cumsum(la, dim=-1)
    ell = torch.exp(_segsum(la))                               # (B,H,nc,Q,Q)
    # intra-chunk (the "attention dual"): scores, then a weighted sum
    scores = c_c @ b_c.transpose(-1, -2)                       # (B,nc,Q,Q)
    y = (scores[:, None] * ell) @ uu                           # (B,H,nc,Q,P)
    # per-chunk end states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)          # (B,H,nc,Q)
    states = (decay_states[..., None] * uu).transpose(-1, -2) \
        @ b_c[:, None]                                         # (B,H,nc,P,N)
    chunk_decay = torch.exp(a_cum[..., -1])                    # (B,H,nc)

    state = (torch.zeros((bsz, h, p, n), dtype=f32, device=u.device)
             if init_state is None else init_state.to(f32))
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = state * chunk_decay[:, :, c, None, None] + states[:, :, c]
    s_in = torch.stack(s_in, dim=2)                            # (B,H,nc,P,N)
    y = y + (c_c[:, None] @ s_in.transpose(-1, -2)) \
        * torch.exp(a_cum)[..., None]
    y = y.permute(0, 2, 3, 1, 4).reshape(bsz, s, h, p)[:, :s_orig]
    return y.to(u.dtype), state


def _causal_conv(x, w, b):
    """Depthwise causal conv1d: x (B, S, C), w (width, C)."""
    width = w.shape[0]
    pad = common.pad_front(x, width - 1)
    s = x.shape[1]
    out = pad[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + pad[:, i:i + s] * w[i]
    return out + b


def _ssm_inputs(lp, x, cfg):
    d_inner, _, _, conv_dim = dims(cfg)
    # whole before the split: z, xBC and dt straddle the column shards
    zxbcdt = shard(x @ lp["in_proj"], "batch", None, None)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt_raw = zxbcdt[..., d_inner + conv_dim:]
    return z, xbc, dt_raw


def _post_conv(lp, xbc_conv, dt_raw, cfg):
    d_inner, h, n, _ = dims(cfg)
    xbc_conv = F.silu(xbc_conv)
    x_ssm = xbc_conv[..., :d_inner]
    b_mat = xbc_conv[..., d_inner:d_inner + n]
    c_mat = xbc_conv[..., d_inner + n:]
    dt = F.softplus(dt_raw.float() + lp["dt_bias"])
    loga = -torch.exp(lp["A_log"]) * dt                        # (B,S,H)
    bsz, s = x_ssm.shape[:2]
    xh = x_ssm.reshape(bsz, s, h, cfg.ssm_headdim)
    u = xh * dt[..., None].to(xh.dtype)
    return xh, u, loga, b_mat, c_mat


def _finish(lp, y, xh, z, cfg):
    bsz, s = y.shape[:2]
    d_inner = cfg.ssm_expand * cfg.d_model
    y = y + lp["D_skip"][None, None, :, None].to(y.dtype) * xh
    y = y.reshape(bsz, s, d_inner)
    y = common.rms_norm(y * F.silu(z), lp["norm_w"])
    # the row-parallel input pinned and restrided: left to itself DTensor
    # shards the sequence here on the multi-pod mesh and plans its strided
    # shards for minutes (off-mesh y is contiguous already)
    y = shard(y, "batch", None, "model")
    if is_dtensor(y):
        y = y.clone(memory_format=torch.contiguous_format)
    return shard(y @ lp["out_proj"], "batch", None, None)


def _pinned(u, loga, b_mat, c_mat):
    """The SSD's inputs pinned as the reference pins u: batch rows over the
    batch axes, heads over ``model`` (loga alike); B and C whole a row."""
    return (shard(u, "batch", None, "model", None),
            shard(loga, "batch", None, "model"),
            shard(b_mat, "batch", None, None),
            shard(c_mat, "batch", None, None))


def _ssd(u, loga, b_mat, c_mat, cfg):
    """:func:`ssd_chunked`; under a mesh on each rank's rows and heads
    (``runtime.sharding.local_map``): the scan is independent along both,
    and DTensor plans its batched matmuls over merged sharded dims for
    minutes."""
    return local_map(
        functools.partial(ssd_chunked, chunk=cfg.ssm_chunk),
        _pinned(u, loga, b_mat, c_mat), free=((0, 2), (0, 2), (0,), (0,)),
        outs=(((0, 0), None, (0, 2), None), ((0, 0), (0, 2), None, None)))


def _layer(lp, x, cfg):
    """One layer over the whole sequence: (out, pre-conv xBC, final SSM
    state)."""
    z, xbc, dt_raw = _ssm_inputs(lp, x, cfg)
    xbc_c = _causal_conv(xbc, lp["conv_w"], lp["conv_b"])
    xh, u, loga, b_mat, c_mat = _post_conv(lp, xbc_c, dt_raw, cfg)
    y, fin = _ssd(u, loga, b_mat, c_mat, cfg)
    return _finish(lp, y, xh, z, cfg), xbc, fin


def layer_full(lp, x, cfg):
    return _layer(lp, x, cfg)[0]


def _ssm_step(u, loga, b_mat, c_mat, ssm_state):
    """One recurrence step: u (B, 1, H, P), loga (B, 1, H), b_mat, c_mat
    (B, 1, N), ssm_state (B, H, P, N) float32 -> (y (B, 1, H, P) in u's
    dtype, the new state)."""
    a = torch.exp(loga[:, 0])                                  # (B, H)
    upd = u[:, 0].float()[..., None] * b_mat[:, 0].float()[:, None, None]
    new_state = ssm_state * a[..., None, None] + upd           # (B,H,P,N)
    y = (new_state @ c_mat[:, 0].float()[:, None, :, None])[..., 0]
    return y[:, None].to(u.dtype), new_state


def layer_decode(lp, x, cfg, conv_state, ssm_state):
    """x (B, 1, D). Returns (out, new_conv_state, new_ssm_state)."""
    z, xbc_new, dt_raw = _ssm_inputs(lp, x, cfg)
    window = torch.cat([conv_state, xbc_new], dim=1)           # (B, W, C)
    conv_out = (window * lp["conv_w"][None]).sum(1, keepdim=True) \
        + lp["conv_b"]
    xh, u, loga, b_mat, c_mat = _post_conv(lp, conv_out, dt_raw, cfg)
    y, new_state = local_map(
        _ssm_step, (*_pinned(u, loga, b_mat, c_mat),
                    shard(ssm_state, "batch", "model", None, None)),
        free=((0, 2), (0, 2), (0,), (0,), (0, 1)),
        outs=(((0, 0), None, (0, 2), None), ((4, 0), (4, 1), None, None)))
    return _finish(lp, y.to(x.dtype), xh, z, cfg), window[:, 1:], new_state


# ---------------------------------------------------------------------------
# LM-level API
# ---------------------------------------------------------------------------

def _residual(lp, h, cfg):
    return h + layer_full(lp, common.norm(h, lp["ln"], cfg.norm), cfg)


def lm_loss(params, batch: dict, cfg, *, impl: str = "kernel"):
    """Next-token CE. batch: tokens (B, S) [, loss_mask (B, S), shifted as
    the decoder's]. Each layer runs under ``transformer._remat``. ``impl``
    is accepted for the API's sake: no attention runs here."""
    del impl
    inputs, targets = common.shift_labels(batch["tokens"])
    h = shard(common.embed(params["embed"], inputs), "batch", None, None)
    for lp in params["layers"]:
        h = transformer._remat(functools.partial(_residual, cfg=cfg), lp, h)
    h = common.norm(h, params["final_norm"], cfg.norm)
    logits = shard(h @ params["lm_head"], "batch", None, "model")
    mask = batch.get("loss_mask")
    loss = common.cross_entropy(logits, targets,
                                mask[:, 1:] if mask is not None else None)
    return loss, {"ce": loss}


def init_cache(cfg, batch: int, max_context: int, device=None) -> dict:
    del max_context                                      # O(1) state
    dtype = common.dtype_of(cfg)
    _, h, n, conv_dim = dims(cfg)
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1,
                             conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, h, cfg.ssm_headdim, n),
                           dtype=torch.float32, device=device),
        "step": transformer.step_tensor(0, device),
    }


@torch.no_grad()
def prefill(params, tokens: torch.Tensor, cfg, *, max_context: int,
            impl: str = "kernel"):
    """tokens (B, S) -> (last-token logits (B, V), cache): conv (L, B,
    conv_width - 1, C) the pre-conv rows the conv saw last (zeros before
    the prompt), ssm (L, B, H, P, N) float32, ``step`` an int32 scalar on
    the device."""
    del max_context, impl
    s = tokens.shape[1]
    keep = cfg.conv_width - 1
    h = common.embed(params["embed"], tokens)
    convs, ssms = [], []
    for lp in params["layers"]:
        out, xbc, fin = _layer(lp, common.norm(h, lp["ln"], cfg.norm), cfg)
        h = h + out
        convs.append(common.pad_front(xbc, keep)[:, s:])
        ssms.append(fin)
    h = common.norm(h, params["final_norm"], cfg.norm)
    logits = (h[:, -1:] @ params["lm_head"])[:, 0]
    return logits, {"conv": torch.stack(convs), "ssm": torch.stack(ssms),
                    "step": transformer.step_tensor(s, h.device)}


@torch.no_grad()
def decode_step(params, cache: dict, tokens: torch.Tensor, cfg):
    """tokens (B, 1) -> (logits (B, 1, V), cache). The cache's conv and ssm
    states are updated in place, and ``step`` advanced by one on the
    device; the returned dict shares them."""
    h = shard(common.embed(params["embed"], tokens), "batch", None, None)
    for i, lp in enumerate(params["layers"]):
        out, conv, ssm = layer_decode(lp, common.norm(h, lp["ln"], cfg.norm),
                                      cfg, cache["conv"][i], cache["ssm"][i])
        h = h + out
        cache["conv"][i] = conv
        cache["ssm"][i] = ssm
    h = common.norm(h, params["final_norm"], cfg.norm)
    cache["step"].add_(1)
    return shard(h @ params["lm_head"], "batch", None, "model"), cache
