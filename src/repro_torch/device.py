"""Device resolution for the port's entry points.

Entry points take ``device=None`` and resolve it here: None means the card.
A host without one raises instead of silently running on the CPU; the CPU
is used only when the caller asks for it (``device="cpu"``), as the tests
do; ``device="meta"`` gives shapes without storage (the dry run).
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch device an entry point runs on.

    None resolves to ``cuda``. A CUDA device on a host without one raises
    ``RuntimeError`` — there is no fallback to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on the GPU by default and no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
