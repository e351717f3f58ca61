"""DeepSeek-67B [arXiv:2401.02954; hf] — llama-arch, GQA kv=8, 95L."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="decoder",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=102400, head_dim=128)
