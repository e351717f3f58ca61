"""Mamba2-2.7B [arXiv:2405.21060] — SSD, attention-free."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="mamba2",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    notes="paper technique inapplicable (attention-free, SiLU); "
          "vocab 50280 not divisible by model axis -> embed replicated.")
