"""Config registry: ``--arch <id>`` resolution for every architecture of
the reference, each ``CONFIG`` a copy of the reference's."""
from __future__ import annotations

from repro_torch.configs import base
from repro_torch.configs.base import (SHAPE_CELLS, ModelConfig, ShapeCell,
                                      cell_applicable)

_MODULES = {
    "mixtral-8x22b": "mixtral_8x22b",
    "mixtral-8x7b": "mixtral_8x7b",
    "mamba2-2.7b": "mamba2_2p7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "yi-9b": "yi_9b",
    "qwen3-1.7b": "qwen3_1p7b",
    "deepseek-67b": "deepseek_67b",
    "tinyllama-1.1b": "tinyllama_1p1b",
    "hubert-xlarge": "hubert_xlarge",
    "recurrentgemma-2b": "recurrentgemma_2b",
}


def list_archs() -> list[str]:
    return list(_MODULES)


def get_config(name: str) -> ModelConfig:
    import importlib

    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


__all__ = ["get_config", "list_archs", "ModelConfig", "ShapeCell",
           "SHAPE_CELLS", "cell_applicable", "base"]
