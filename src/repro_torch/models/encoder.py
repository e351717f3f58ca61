"""HuBERT-style encoder-only audio backbone [arXiv:2106.07447], the
reference's ``src/repro/models/encoder.py``.

The modality frontend (the CNN feature extractor) is a stub, as in the
reference: the input is precomputed frame embeddings (B, S,
frontend_dim). Training objective: masked prediction of cluster ids at the
masked frames. The stack is :func:`transformer.forward_embeds` with
``cfg.causal`` False, so kernel 5 runs non-causal on the card.

Frames wider than the model's dtype compute in theirs, as the reference's
type promotion does: float32 frames into a bf16 model give a float32
hidden stream (kernel 5's float32 route); bf16 frames stay bf16.
"""
from __future__ import annotations

import torch

from repro_torch.models import common, transformer
from repro_torch.runtime.sharding import shard


def init_model(cfg, gen) -> dict:
    """The decoder stack's parameters without ``embed`` / ``lm_head``,
    plus ``frontend_proj``, ``mask_emb`` and ``pred_head``."""
    dtype = common.dtype_of(cfg)
    lm = transformer.init_lm(cfg, gen)
    del lm["embed"]                        # no token embedding
    lm.pop("lm_head", None)
    return {
        **lm,
        "frontend_proj": common.normal(gen, (cfg.frontend_dim, cfg.d_model),
                                       cfg.frontend_dim ** -0.5, dtype),
        "mask_emb": common.normal(gen, (cfg.frontend_dim,), 0.02, dtype),
        "pred_head": common.normal(gen, (cfg.d_model, cfg.vocab),
                                   cfg.d_model ** -0.5, dtype),
    }


class EncoderModel(common.ParamTree):
    """The parameters of the encoder under the reference's names
    (``layers.<i>...``, ``final_norm``, ``frontend_proj``, ``mask_emb``,
    ``pred_head``); drawn by :func:`init_model` from ``generator`` (None:
    seeded 0) on ``device`` (None: the card)."""

    def __init__(self, cfg, *, device=None, generator=None):
        _, gen = common.generator_for(device, generator)
        super().__init__(init_model(cfg, gen))
        self.cfg = cfg


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """An :class:`EncoderModel` ``state_dict`` from a reference tree."""
    return common.params_from_jax(tree, stacked=("layers",))


def encode(params, frames: torch.Tensor, cfg, *, impl: str = "kernel"):
    """frames (B, S, frontend_dim) -> hidden (B, S, D), in the promoted
    dtype of the frames and the model; ``impl`` as in
    :func:`attention.attend_full`."""
    dt = torch.promote_types(frames.dtype, common.dtype_of(cfg))
    h = shard(common.dot(frames.to(dt), params["frontend_proj"]),
              "batch", None, None)
    h, _, _ = transformer.forward_embeds(params, h, cfg, impl=impl)
    return h


def masked_prediction_loss(params, batch: dict, cfg, *,
                           impl: str = "kernel"):
    """batch: frames (B, S, F), mask (B, S) bool, targets (B, S) int.
    CE of the cluster ids at the masked frames, which see ``mask_emb``."""
    frames = torch.where(batch["mask"][..., None],
                         params["mask_emb"].to(batch["frames"].dtype),
                         batch["frames"])
    h = encode(params, frames, cfg, impl=impl)
    logits = shard(common.dot(h, params["pred_head"]), "batch", None,
                   "model")
    loss = common.cross_entropy(logits, batch["targets"], batch["mask"])
    return loss, {"ce": loss}
