"""TinyLlama-1.1B [arXiv:2401.02385; hf] — llama2-arch small, kv=4."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="decoder",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab=32000, head_dim=64)
