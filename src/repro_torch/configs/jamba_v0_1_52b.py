"""jamba-v0.1-52b — hybrid Mamba+attention MoE [arXiv:2403.19887].

32L d_model=4096; attention every 8th layer (offset 4, 32H GQA kv=8,
head_dim 128); MoE every 2nd layer (offset 1): 16 experts top-2,
d_ff=14336; mamba elsewhere (d_inner 8192, state 16, dt_rank 256).
``long_500k`` RUNS (hybrid: 28/32 layers are linear-time).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "jamba-v0.1-52b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    attn_layer_period=8,
    attn_layer_offset=4,
    n_experts=16,
    n_shared_experts=0,
    experts_per_token=2,
    moe_d_ff=14336,
    moe_layer_period=2,
    moe_layer_offset=1,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    dt_rank=256,
    pad_multiple=16,
)
