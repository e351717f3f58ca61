"""RecurrentGemma-2B [arXiv:2402.19427; hf] — RG-LRU + local attn 1:2."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="rglru",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000, head_dim=256,
    rglru_pattern=("rec", "rec", "attn"), lru_width=2560,
    local_window=2048, act="gelu", tie_embeddings=True,
    notes="sub-quadratic (RG-LRU state + window-2048 local attn): "
          "long_500k eligible.")
