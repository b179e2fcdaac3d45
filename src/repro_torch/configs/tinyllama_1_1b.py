"""tinyllama-1.1b — llama2-arch small dense LM [arXiv:2401.02385].

22L d_model=2048 32H (GQA kv=4, head_dim 64) d_ff=5632 vocab=32000.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "tinyllama-1.1b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    rope_theta=10000.0,
    pad_multiple=16,
)
