"""LLaVA-NeXT (mistral-7b backbone) VLM wrapper, the reference's
``src/repro/models/vlm.py``.

The vision tower is a stub, as in the reference: the input is precomputed
patch embeddings (B, n_patches, vision_dim); the anyres tiling (576 base
patches + 4 tiles = 2,880) sets n_patches. This module owns the 2-layer
MLP projector and the multimodal sequence ``[patches | text]``; the rest
is the decoder stack, whose attention is kernel 5 on the card.
:func:`decode_step` and :func:`init_cache` are the decoder's.

Patches wider than the model's dtype compute in theirs, as the reference's
type promotion does: float32 patches into a bf16 model give float32
hidden states, logits and KV cache (kernel 5's float32 route); bf16
patches stay bf16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import attention, common, transformer
from repro_torch.runtime.sharding import shard


def init_model(cfg, gen) -> dict:
    """The decoder's parameters plus the projector ``proj_in`` and
    ``proj_out``."""
    dtype = common.dtype_of(cfg)
    lm = transformer.init_lm(cfg, gen)
    return {
        **lm,
        "proj_in": common.normal(gen, (cfg.vision_dim, cfg.d_model),
                                 cfg.vision_dim ** -0.5, dtype),
        "proj_out": common.normal(gen, (cfg.d_model, cfg.d_model),
                                  cfg.d_model ** -0.5, dtype),
    }


class VLMModel(common.ParamTree):
    """The parameters of the VLM under the reference's names (the
    decoder's and ``proj_in``, ``proj_out``); drawn by :func:`init_model`
    from ``generator`` (None: seeded 0) on ``device`` (None: the card)."""

    def __init__(self, cfg, *, device=None, generator=None):
        _, gen = common.generator_for(device, generator)
        super().__init__(init_model(cfg, gen))
        self.cfg = cfg


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """A :class:`VLMModel` ``state_dict`` from a reference tree."""
    return common.params_from_jax(tree, stacked=("layers",))


def project_patches(params, patches: torch.Tensor, cfg) -> torch.Tensor:
    """patches (B, P, vision_dim) -> (B, P, D) in the promoted dtype of the
    patches and the model."""
    dt = torch.promote_types(patches.dtype, common.dtype_of(cfg))
    h = F.gelu(common.dot(patches.to(dt), params["proj_in"]),
               approximate="tanh")
    return shard(common.dot(h, params["proj_out"]), "batch", None, None)


def _sequence(params, patches, tokens, cfg):
    pe = project_patches(params, patches, cfg)
    te = common.embed(params["embed"], tokens).to(pe.dtype)
    return torch.cat([pe, te], dim=1), pe.shape[1]


def lm_loss(params, batch: dict, cfg, *, impl: str = "kernel"):
    """batch: patches (B, P, vision_dim), tokens (B, S_text) [, loss_mask
    (B, S_text)]. Sequence ``[patches | text]``; next-token CE on the text
    only (position P-1+i predicts text token i)."""
    tokens = batch["tokens"]
    h, p = _sequence(params, batch["patches"], tokens[:, :-1], cfg)
    h, aux, _ = transformer.forward_embeds(params, h, cfg, impl=impl)
    logits = transformer.logits_fn(params, h[:, p - 1:], cfg)
    loss = common.cross_entropy(logits, tokens, batch.get("loss_mask"))
    return loss, {"ce": loss, **aux}


@torch.no_grad()
def prefill(params, batch: dict, cfg, *, max_context: int,
            impl: str = "kernel"):
    """Multimodal prefill: ``[patches | prompt tokens]`` -> (last logits
    (B, V), cache), the decoder's cache over P + S_text positions."""
    h, _ = _sequence(params, batch["patches"], batch["tokens"], cfg)
    cap = transformer.cache_capacity(cfg, max_context)
    h, _, kvs = transformer.forward_embeds(params, h, cfg, collect_kv=True,
                                           impl=impl)
    logits = transformer.logits_fn(params, h[:, -1:], cfg)[:, 0]
    caches = [attention.cache_from_prefill(k, v, cap) for k, v in kvs]
    return logits, {"k": torch.stack([c.k for c in caches]),
                    "v": torch.stack([c.v for c in caches]),
                    "pos": caches[0].pos,
                    "step": transformer.step_tensor(h.shape[1], h.device)}


decode_step = transformer.decode_step
init_cache = transformer.init_cache
