"""qwen1.5-32b — dense LM with QKV bias [hf:Qwen/Qwen1.5-32B].

64L d_model=5120 40H (kv=40, head_dim 128) d_ff=27392 vocab=152064.
40 heads pad to 48 for the 16-way model axis.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen1.5-32b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    pad_multiple=16,
)
