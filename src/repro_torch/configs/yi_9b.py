"""Yi-9B [arXiv:2403.04652; hf] — llama-arch, GQA kv=4."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="decoder",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000, head_dim=128, rope_theta=5e6)
