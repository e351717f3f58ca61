"""Uniform model API: init / loss / prefill / init_cache / decode_step.

Only the ``decoder`` family (dense and MoE) is ported. The others raise
``NotImplementedError`` naming their ROADMAP item; the dry-run's
``input_specs`` and ``abstract_cache`` come with them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer

_NOT_PORTED = {
    "vlm": "the VLM family (llava) is not ported yet (ROADMAP §1 item 5)",
    "mamba2": "the Mamba2 family is not ported yet (ROADMAP §1 item 5)",
    "rglru": "the RG-LRU family (recurrentgemma) is not ported yet "
             "(ROADMAP §1 item 5)",
    "encoder": "the encoder family (hubert) is not ported yet (ROADMAP §1 "
               "item 5)",
}


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[..., Any]            # (generator=None) -> params
    loss: Callable[..., Any]            # (params, batch, impl=) -> (loss, metrics)
    prefill: Callable[..., Any]         # (params, batch, max_context)
    init_cache: Callable[..., Any]      # (batch, max_context) -> cache
    decode_step: Callable[..., Any]     # (params, cache, tokens)


def build_model(cfg: ModelConfig, *,
                device: str | torch.device | None = None) -> Model:
    """The model functions of ``cfg`` on ``device`` (None: the card; raises
    without one). ``init`` builds a :class:`~transformer.DecoderLM` and
    returns its nested parameter dict."""
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(f"{cfg.name}: {_NOT_PORTED[cfg.family]}")
    if cfg.family != "decoder":
        raise ValueError(f"unknown family {cfg.family!r}")
    dev = resolve_device(device)
    return Model(
        cfg, dev,
        init=lambda generator=None: transformer.DecoderLM(
            cfg, device=dev, generator=generator).params(),
        loss=lambda p, b, impl="kernel": transformer.lm_loss(p, b, cfg,
                                                             impl=impl),
        prefill=lambda p, b, mc: transformer.prefill(
            p, b["tokens"], cfg, max_context=mc),
        init_cache=lambda bs, mc: transformer.init_cache(cfg, bs, mc,
                                                         device=dev),
        decode_step=lambda p, c, t: transformer.decode_step(p, c, t, cfg))
