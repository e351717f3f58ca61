"""LLaVA-NeXT (mistral-7b) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Anyres tiling: 576 base + 4x576 tile patches = 2880 precomputed patch
embeddings (vision tower stubbed per the brief)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, head_dim=128, rope_theta=1e6,
    n_patches=2880, vision_dim=1024,
    notes="treated as full attention (no SWA listed) -> long_500k skip.")
