"""HuBERT-XLarge [arXiv:2106.07447] — encoder-only audio backbone.

Frontend (CNN feature extractor) stubbed: input_specs provides frame
embeddings (B, S, 512). kv=16 == n_heads (full MHA)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab=504, head_dim=80,
    causal=False, act="gelu", norm="layernorm", frontend_dim=512,
    notes="encoder-only: decode shape cells skipped per brief.")
