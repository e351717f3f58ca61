"""Rulebook helpers: per-tap map counts and the hottest-first tap schedule.

Weight-stationary processing of the hottest taps first is the framework
face of the paper's non-uniform caching (§V-C); ``build_tap_tiles``
(kernels/spconv_gemm/ops.py) lays each output block's tap segments out in
this order.
"""
from __future__ import annotations

import torch


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
