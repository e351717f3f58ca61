"""Mixtral 8x7B [arXiv:2401.04088; hf] — MoE 8e top-2, GQA kv=8, SWA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="decoder",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, head_dim=128,
    n_experts=8, top_k=2, swa_window=4096, rope_theta=1e6)
