"""Rulebook helpers and the tap-scan execution of a kernel map.

* :func:`tap_counts`, :func:`blocked_tap_counts` and the hottest-first
  :func:`tap_schedule`: weight-stationary processing of the hottest taps
  first is the framework face of the paper's non-uniform caching (§V-C);
  ``build_tap_tiles`` (kernels/spconv_gemm/ops.py) lays each output
  block's tap segments out in this order.
* :func:`apply_kmap_gather`: output-stationary SpConv as a loop over taps
  (gather, matmul, add) in plain PyTorch, the oracle of every kernel
  backend (``plan.execute(impl="scan")``, the reference's ``impl="xla"``).
* :func:`apply_kmap_gather_spac`: the same with SPAC map elision in the
  forward and the gradient of the un-elided maps in the backward.
* :func:`apply_maps_scatter`: input-stationary SpConv over scatter-form
  maps (the Gconv3 dataflow of the paper's §IV-D3): per-tap partial sums
  added into the outputs in tap order.
"""
from __future__ import annotations

import torch

from repro_torch.core import segment, sparsity


def tap_counts(kmap: torch.Tensor) -> torch.Tensor:
    """Maps per weight tap, int32."""
    return (kmap >= 0).sum(dim=0, dtype=torch.int32)


def tap_schedule(counts: torch.Tensor) -> torch.Tensor:
    """Descending-count tap order with ties broken by tap id (a stable
    descending rank from an O(K^2) pairwise comparison), int32."""
    k = counts.shape[0]
    idx = torch.arange(k, dtype=torch.int32, device=counts.device)
    beats = (counts[None, :] > counts[:, None]).sum(dim=1)
    ties_before = ((counts[None, :] == counts[:, None])
                   & (idx[None, :] < idx[:, None])).sum(dim=1)
    rank = beats + ties_before                       # tap -> schedule slot
    sched = torch.zeros(k, dtype=torch.int32, device=counts.device)
    sched[rank] = idx
    return sched


def blocked_tap_counts(kmap: torch.Tensor, bo: int) -> torch.Tensor:
    """(n_blocks, K) int32 histogram of maps per (bo-row output block,
    tap): the groups the output-blocked tile layout pads to bm."""
    n_out, k = kmap.shape
    n_blocks = -(-n_out // bo)
    dev = kmap.device
    block = (torch.arange(n_out, device=dev) // bo).repeat_interleave(k)
    taps = torch.arange(k, device=dev).repeat(n_out)
    key = torch.where(kmap.reshape(-1) >= 0, block * k + taps, n_blocks * k)
    return torch.bincount(key, minlength=n_blocks * k + 1)[:-1].reshape(
        n_blocks, k).to(torch.int32)


def apply_kmap_gather(feats: torch.Tensor, weights: torch.Tensor,
                      kmap: torch.Tensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """Output-stationary SpConv: ``out[i] = sum_k feats[kmap[i, k]] @ W[k]``.

    feats (N_in, Cin), weights (K, Cin, Cout), kmap (N_out, K) with -1
    holes. One gather, one matmul and one add per tap, differentiable by
    autograd.
    """
    n_out, k = kmap.shape
    acc = torch.zeros((n_out, weights.shape[-1]), dtype=weights.dtype,
                      device=weights.device)
    for t in range(k):
        km = kmap[:, t]
        rows = feats[km.clamp(min=0).long()]
        rows = torch.where((km >= 0)[:, None], rows, 0.0)
        acc = acc + rows.to(weights.dtype) @ weights[t]
    if bias is not None:
        acc = acc + bias
    return acc


class _GatherSpac(torch.autograd.Function):
    """Forward on the compacted kmap; backward through the un-elided one."""

    @staticmethod
    def forward(ctx, feats, weights, kmap, row_nz):
        ctx.save_for_backward(feats, weights, kmap)
        return apply_kmap_gather(feats, weights,
                                 sparsity.compact_kmap(kmap, row_nz))

    @staticmethod
    def backward(ctx, g):
        feats, weights, kmap = ctx.saved_tensors
        dfeats = torch.zeros_like(feats) if ctx.needs_input_grad[0] else None
        dw = torch.empty_like(weights) if ctx.needs_input_grad[1] else None
        for t in range(kmap.shape[1]):
            km = kmap[:, t]
            hit = (km >= 0)[:, None]
            idx = km.clamp(min=0).long()
            gt = torch.where(hit, g, 0.0)
            if dw is not None:
                rows = torch.where(hit, feats[idx], 0.0).to(weights.dtype)
                dw[t] = rows.t() @ gt
            if dfeats is not None:
                dfeats.index_add_(0, idx,
                                  (gt @ weights[t].t()).to(feats.dtype))
        return dfeats, dw, None, None


def apply_kmap_gather_spac(feats: torch.Tensor, weights: torch.Tensor,
                           kmap: torch.Tensor,
                           row_nz: torch.Tensor) -> torch.Tensor:
    """SPAC map elision on the tap-scan path, with the right gradient.

    The forward drops maps sourcing all-zero rows
    (:func:`sparsity.compact_kmap`), which is lossless: those rows add
    exactly 0. The backward differentiates the **un-elided** maps: the
    gradient of an exactly-zero row is ``Wᵀ·g``, not 0. Bias stays
    outside (add it after).
    """
    return _GatherSpac.apply(feats, weights, kmap, row_nz)


def apply_maps_scatter(feats: torch.Tensor, weights: torch.Tensor, maps,
                       bias: torch.Tensor | None = None, *, n_out: int,
                       n_taps: int) -> torch.Tensor:
    """Input-stationary SpConv: every valid map ``(in_idx, out_idx, tap)``
    of the :class:`~repro_torch.core.mapsearch.StridedMaps` ``maps`` adds
    ``feats[in_idx] @ W[tap]`` into ``out[out_idx]``.

    The valid maps are ordered by tap (one host read of the per-tap
    counts) and each tap's slice is one matmul. Each output row adds its
    partial sums in ascending tap order, as the reference's scan of
    per-tap scatters does, and the backward adds each input row's
    gradients in the same order (:mod:`segment`; on the card no host
    read, for both indexes and in the backward), so two runs give the same
    bits. Maps with ``out_idx`` outside ``[0, n_out)`` are dropped.
    Returns the (n_out, Cout) output (+ bias), zero on rows that
    ``maps.out_valid`` marks invalid. Differentiable by autograd.
    """
    key = torch.where(maps.mvalid, maps.tap, n_taps).long()
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=n_taps + 1)[:n_taps].tolist()
    live = order[:sum(counts)]
    src = maps.in_idx[live].long()
    by_out, by_in = segment.segments((maps.out_idx[live], n_out),
                                     (src, feats.shape[0]))
    rows = segment.ordered_gather(feats, src, by_in).to(weights.dtype)
    parts, start = [], 0
    for t, c in enumerate(counts):
        if c:
            parts.append(rows[start:start + c] @ weights[t])
        start += c
    acc = segment.ordered_sum(
        torch.cat(parts) if parts else rows.new_zeros((0, weights.shape[-1])),
        by_out)
    if bias is not None:
        acc = acc + bias
    return torch.where(maps.out_valid[:n_out, None], acc, 0.0)
