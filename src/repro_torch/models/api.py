"""Uniform model API over the five families: init / loss / prefill /
init_cache / decode_step, and the per-cell input specs.

``input_specs(cell)``, :meth:`Model.abstract_params` and
:func:`abstract_cache` stand in for the reference's ``ShapeDtypeStruct``
trees with tensors on the ``meta`` device: shapes and dtypes, no
allocation and no draws. The modality frontends are stubs, as in the
reference: their inputs are precomputed embeddings (the encoder's
``frames``, the VLM's ``patches``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.device import resolve_device
from repro_torch.models import common, encoder, mamba2, rglru, transformer, vlm


def _tokens(fn):
    """A prefill over ``batch["tokens"]`` in the table's signature."""
    return lambda p, b, cfg, mc, impl: fn(p, b["tokens"], cfg,
                                          max_context=mc, impl=impl)


#: family -> (its ``nn.Module``, loss, prefill (params, batch, cfg,
#: max_context, impl), the module whose ``init_cache`` and ``decode_step``
#: serve it or None). An encoder's "prefill" is a plain full-sequence
#: encode; the VLM decodes through the decoder's cache.
_FAMILIES = {
    "decoder": (transformer.DecoderLM, transformer.lm_loss,
                _tokens(transformer.prefill), transformer),
    "vlm": (vlm.VLMModel, vlm.lm_loss,
            lambda p, b, cfg, mc, impl: vlm.prefill(
                p, b, cfg, max_context=mc, impl=impl), transformer),
    "mamba2": (mamba2.Mamba2LM, mamba2.lm_loss, _tokens(mamba2.prefill),
               mamba2),
    "rglru": (rglru.RGLRULM, rglru.lm_loss, _tokens(rglru.prefill), rglru),
    "encoder": (encoder.EncoderModel, encoder.masked_prediction_loss,
                lambda p, b, cfg, mc, impl: encoder.encode(
                    p, b["frames"], cfg, impl=impl), None),
}


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    module: Callable[..., Any]          # (generator=None) -> nn.Module
    loss: Callable[..., Any]            # (params, batch, impl=) -> (loss, metrics)
    prefill: Callable[..., Any]         # (params, batch, max_context, impl=)
    init_cache: Callable[..., Any] | None   # (batch, max_context, device=)
    decode_step: Callable[..., Any] | None  # (params, cache, tokens)

    def init(self, generator: torch.Generator | None = None) -> dict:
        """The nested parameters of a fresh :attr:`module` drawn from
        ``generator`` (None: one on the device, seeded 0)."""
        return self.module(generator).params()

    def abstract_params(self) -> dict:
        """The nested parameters as ``meta`` tensors: no allocation."""
        return self.module(common.META).params()

    @staticmethod
    def nest(flat: dict) -> dict:
        """The nested parameters of a :attr:`module` ``state_dict``."""
        return common.nest_params(flat)

    def input_specs(self, cell: ShapeCell) -> dict:
        return input_specs(self.cfg, cell)


def build_model(cfg: ModelConfig, *,
                device: str | torch.device | None = None) -> Model:
    """The model functions of ``cfg`` on ``device`` (None: the card; raises
    without one). ``module`` builds the family's ``nn.Module`` (its
    ``state_dict`` is what training updates), ``nest`` turns that
    ``state_dict`` into the nested dict the functions take."""
    dev = resolve_device(device)
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    cls, loss, prefill, serving = _FAMILIES[cfg.family]
    return Model(
        cfg, dev,
        module=lambda generator=None: cls(cfg, device=dev,
                                          generator=generator),
        loss=lambda p, b, impl="kernel": loss(p, b, cfg, impl=impl),
        prefill=lambda p, b, mc, impl="kernel": prefill(p, b, cfg, mc, impl),
        init_cache=None if serving is None else
        lambda bs, mc, device=dev: serving.init_cache(cfg, bs, mc,
                                                      device=device),
        decode_step=None if serving is None else
        lambda p, c, t: serving.decode_step(p, c, t, cfg))


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """``meta`` tensors of the inputs of the function run in this cell:
    train -> the loss's ``batch``, prefill -> the prefill batch (the whole
    sequence), decode -> {tokens (B, 1)} (the cache: :func:`abstract_cache`).
    """
    b, s = cell.global_batch, cell.seq_len
    i32 = torch.int32
    act = common.dtype_of(cfg)
    if cfg.family == "encoder":
        if cell.kind == "train":
            return {"frames": _spec((b, s, cfg.frontend_dim), act),
                    "mask": _spec((b, s), torch.bool),
                    "targets": _spec((b, s), i32)}
        # prefill == plain encode for an encoder
        return {"frames": _spec((b, s, cfg.frontend_dim), act)}
    if cfg.family == "vlm":
        p = min(cfg.n_patches, s // 2)
        text = s - p
        if cell.kind in ("train", "prefill"):
            return {"patches": _spec((b, p, cfg.vision_dim), act),
                    "tokens": _spec((b, text), i32)}
        return {"tokens": _spec((b, 1), i32)}
    if cell.kind in ("train", "prefill"):
        return {"tokens": _spec((b, s), i32)}
    return {"tokens": _spec((b, 1), i32)}


def abstract_cache(model: Model, cell: ShapeCell) -> dict:
    """The decode cache of ``cell`` (context length ``cell.seq_len``) as
    ``meta`` tensors, ``step`` an int32 scalar among them, as the
    reference's."""
    return model.init_cache(cell.global_batch, cell.seq_len, device="meta")
