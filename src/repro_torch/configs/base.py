"""Architecture config schema and the shape cells of the model API
(``ShapeCell``, ``SHAPE_CELLS``, ``cell_applicable``), copied field for
field from the reference."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # decoder | encoder | mamba2 | rglru | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qk_norm: bool = False
    swa_window: int = 0         # 0 = full attention
    rope_theta: float = 1e4
    causal: bool = True
    act: str = "silu"
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    # MoE (mixtral)
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.02
    # Mamba2 / SSD
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # RG-LRU hybrid (recurrentgemma)
    rglru_pattern: tuple = ()   # e.g. ("rec", "rec", "attn")
    lru_width: int = 0          # 0 -> d_model
    local_window: int = 2048
    # VLM (llava)
    n_patches: int = 0
    vision_dim: int = 0
    # encoder (hubert)
    frontend_dim: int = 0       # stub frame-embedding dim
    mask_prob: float = 0.08
    # numerics
    dtype: str = "bfloat16"
    notes: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / sliding-window)."""
        return (self.family in ("mamba2", "rglru")
                or (self.swa_window > 0 and self.family in ("decoder",)))

    @property
    def has_decode(self) -> bool:
        return self.family != "encoder"

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests (brief (f))."""
        kv = max(1, min(self.n_kv_heads, 2))
        heads = max(kv, 4)
        repl = dict(
            n_layers=min(self.n_layers, 3 if not self.rglru_pattern else
                         max(3, len(self.rglru_pattern))),
            d_model=64, n_heads=heads, n_kv_heads=kv, d_ff=128,
            vocab=min(self.vocab, 256), head_dim=16,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            # drop-free capacity so prefill/decode consistency is exact in
            # smoke tests (capacity drops are legitimate nondeterminism)
            capacity_factor=4.0 if self.n_experts else self.capacity_factor,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=8 if self.ssm_state else 256,
            swa_window=16 if self.swa_window else 0,
            local_window=8 if self.rglru_pattern else 2048,
            lru_width=64 if self.rglru_pattern else 0,
            n_patches=8 if self.n_patches else 0,
            vision_dim=32 if self.vision_dim else 0,
            frontend_dim=32 if self.frontend_dim else 0,
            dtype="float32",
        )
        return dataclasses.replace(self, **repl)


@dataclass(frozen=True)
class ShapeCell:
    """One assigned (arch x input-shape) benchmark cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    """Skip rules of the grid (recorded, not silently dropped)."""
    if cell.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only arch has no decode step"
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""
