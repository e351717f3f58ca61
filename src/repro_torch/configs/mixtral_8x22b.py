"""Mixtral 8x22B [arXiv:2401.04088; hf] — MoE 8e top-2, GQA kv=8, SWA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="decoder",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768, head_dim=128,
    n_experts=8, top_k=2, swa_window=4096, rope_theta=1e6,
    notes="MoE dispatch reuses the SpOctA rulebook machinery "
          "(DESIGN.md §5); SWA => rolling KV cache, long_500k eligible.")
