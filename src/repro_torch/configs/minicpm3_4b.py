"""minicpm3-4b — dense LM with MLA [hf:openbmb/MiniCPM3-4B].

62L d_model=2560 40H d_ff=6400 vocab=73448 (padded to 73472 for 16-way TP).
MLA: q_lora 768, kv_lora 256, qk nope/rope 64/32, v 64.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "minicpm3-4b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab_size=73448,
    attn_type="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
    pad_multiple=16,
)
