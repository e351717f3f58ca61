"""Plain PyTorch version of the flash-attention kernel: its oracle.

The same chunked online softmax as the reference (``repro``'s
``attention_ref``): a loop over KV chunks keeps peak memory at
O(Sq * chunk) instead of O(Sq * Skv), with the same finite ``NEG_INF`` for
masked scores. Causal masks, sliding windows and GQA (by repeating each KV
head over its group of query heads) as there.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(q_pos, k_pos, causal: bool, window: int):
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = m & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        m = m & (k_pos[None, :] > q_pos[:, None] - window)
    return m


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  chunk: int = 1024) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D); Hq % Hkv == 0.

    ``window`` > 0 = sliding-window attention (keys within [pos-window+1,
    pos]). Positions are aligned to the *end*: q token i sits at absolute
    position Skv - Sq + i (the decode/prefill convention). Float32 inside;
    the result is in q's dtype.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    scale = d ** -0.5
    dev = q.device
    q_pos = torch.arange(sq, device=dev) + (skv - sq)
    qf = q.float()

    chunk = min(chunk, skv)
    m_run = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((b, hq, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=dev)
    # the reference pads the last chunk with masked zero keys; every row
    # holds a live key (its own position), so a padded key adds exactly 0
    # and the last chunk is taken short instead
    for k0 in range(0, skv, chunk):
        kj = k[:, :, k0:k0 + chunk].float()
        vj = v[:, :, k0:k0 + chunk].float()
        k_pos = torch.arange(k0, k0 + kj.shape[2], device=dev)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kj) * scale
        s = torch.where(_mask(q_pos, k_pos, causal, window)[None, None], s,
                        torch.full((), NEG_INF, device=dev))
        m_new = torch.maximum(m_run, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_run - m_new)
        l_run = l_run * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vj)
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.to(q.dtype)
