"""Qwen3-1.7B [hf:Qwen/Qwen3-8B family] — qk_norm, GQA kv=8, tied."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="decoder",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6, tie_embeddings=True)
