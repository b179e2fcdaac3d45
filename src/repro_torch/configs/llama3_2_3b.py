"""llama3.2-3b — small llama3 dense LM [hf:meta-llama/Llama-3.2-3B].

28L d_model=3072 24H (GQA kv=8, head_dim 128) d_ff=8192 vocab=128256.
24 q-heads pad to 32 for the 16-way model axis (see DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "llama3.2-3b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    pad_multiple=16,
)
